"""Plain PyTorch version of the fused UniPC update."""

import torch


def weighted_combine(terms: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """terms: (K, *shape); weights: (K,) or per-slot (K, B). Returns
    sum_k w_k * terms[k] as an fp32 axpy chain in the kernel's order (per
    batch row for per-slot weights), cast to the terms' dtype."""
    w = weights.to(torch.float32)
    if w.ndim == 2:  # (K, B) per-slot columns over (K, B, ...) terms
        w = w.reshape(w.shape + (1,) * (terms.ndim - w.ndim))
    acc = w[0] * terms[0].to(torch.float32)
    for k in range(1, terms.shape[0]):
        acc = acc + w[k] * terms[k].to(torch.float32)
    return acc.to(terms.dtype)
