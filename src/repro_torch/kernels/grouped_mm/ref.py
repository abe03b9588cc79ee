"""Plain PyTorch version of the grouped matmul: one product a group."""

import torch


def grouped_mm(a: torch.Tensor, w: torch.Tensor,
               offs: torch.Tensor) -> torch.Tensor:
    """a (M, K), w (G, K, N), offs (G,) the cumulative row ends of the
    groups: rows offs[g-1]:offs[g] of a times w[g], (M, N) in a's dtype.
    Rows past offs[-1] are zero. Reads `offs` on the host."""
    out = torch.zeros((a.shape[0], w.shape[2]), dtype=a.dtype,
                      device=a.device)
    start = 0
    for g, end in enumerate(offs.tolist()):
        if end > start:
            out[start:end] = a[start:end] @ w[g].to(a.dtype)
        start = end
    return out
