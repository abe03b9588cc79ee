"""The grouped matmul of a dropless MoE layer: rows sorted by expert, each
expert's rows times its own weight, the group sizes held on the device as
cumulative offsets, so a CUDA graph captures it with no host sync. On the
card it is torch's `_grouped_mm` (CUTLASS's grouped GEMM for bf16 on
sm_90); off it the plain version (`ref.py`), one product a group."""

from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .. import dispatch
from ..dispatch import Cost, nbytes, use_kernel


def cost(a, w, offs) -> Cost:
    """a, w and offs read, the (M, N) output written; 2 M K N operations
    over the rows the groups hold (all M of a dropless layer's)."""
    M, (G, K, N) = a.shape[0], w.shape
    return Cost(2 * M * K * N, nbytes(a, w, offs) + M * N * a.element_size(),
                a.dtype, matmul=True)


def grouped_mm(a: torch.Tensor, w: torch.Tensor, offs: torch.Tensor, *,
               backend: Optional[str] = None) -> torch.Tensor:
    """a (M, K), w (G, K, N), offs (G,) int32 cumulative row ends (offs[-1]
    == M) -> (M, N) in a's dtype. `backend="plain"` pins the plain
    version."""
    on_card = use_kernel(backend, a)
    if dispatch.COUNT is None:
        return _route(a, w, offs, on_card)
    with dispatch.COUNT.kernel("grouped_mm", cost(a, w, offs), (a, w)):
        return _route(a, w, offs, on_card)


def _route(a, w, offs, on_card):
    if a.device.type == "meta":
        return a.new_empty((a.shape[0], w.shape[2]))
    if on_card:
        return torch._grouped_mm(a, w.to(a.dtype), offs=offs)
    return ref.grouped_mm(a, w, offs)
