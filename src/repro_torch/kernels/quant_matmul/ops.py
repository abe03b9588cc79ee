"""Public wrapper for the quantized matmul: device dispatch (the port of
`repro/kernels/quant_matmul/ops.py`; the kernel masks ragged M, N and K
itself, so there is no padding to a tile lattice).

With a static activation scale `sa` (W8A8) the activations are quantized
here, in plain PyTorch as in the reference, and `sa` is folded into the
weight scale, so the kernel and the plain version both compute
`(x_q @ qw) * (sa * ws)`.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernel, ref
from ..dispatch import refuse_grad, use_kernel


def quant_matmul(x: torch.Tensor, qw: torch.Tensor, ws: torch.Tensor, *,
                 sa=None, backend: Optional[str] = None) -> torch.Tensor:
    """x: (..., K) float; qw: (K, N) int8/fp8; ws: (N,) fp32 per-output-
    channel weight scales; sa: optional static activation scale (W8A8).
    Returns (..., N) in x's dtype. `backend="plain"` pins the plain version
    (kernels/dispatch.py)."""
    if not use_kernel(backend, x):
        return ref.quant_matmul(x, qw, ws, sa=sa)
    # no backward kernel: checked here too, as W8A8's int8 x2 drops x's grad
    refuse_grad("quant_matmul", x, ws, sa)
    lead, K = x.shape[:-1], x.shape[-1]
    x2, scale = ref.fold_act(x.reshape(-1, K), ws, sa)
    out = kernel.quant_matmul(x2, qw, scale, out_dtype=x.dtype)
    return out.reshape(*lead, qw.shape[-1])
