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
from .. import dispatch
from ..dispatch import Cost, nbytes, refuse_grad, use_kernel


def cost(x2, qw, scale, out_dtype) -> Cost:
    """x2 (M, K), the weight and its scales read, the (M, N) output written;
    2 M K N operations at the peak of x2's dtype (int8 for W8A8, else the
    activations' float type: the weights are widened to it)."""
    M, (K, N) = x2.shape[0], qw.shape
    out_size = torch.empty((), dtype=out_dtype).element_size()
    return Cost(2 * M * K * N, nbytes(x2, qw, scale) + M * N * out_size,
                x2.dtype, matmul=True)


def quant_matmul(x: torch.Tensor, qw: torch.Tensor, ws: torch.Tensor, *,
                 sa=None, backend: Optional[str] = None) -> torch.Tensor:
    """x: (..., K) float; qw: (K, N) int8/fp8; ws: (N,) fp32 per-output-
    channel weight scales; sa: optional static activation scale (W8A8).
    Returns (..., N) in x's dtype. `backend="plain"` pins the plain version
    (kernels/dispatch.py)."""
    on_card = use_kernel(backend, x)
    if on_card:
        # no backward kernel: checked here too, as W8A8's int8 x2 drops x's
        # grad
        refuse_grad("quant_matmul", x, ws, sa)
    lead, K = x.shape[:-1], x.shape[-1]
    x2, scale = ref.fold_act(x.reshape(-1, K), ws, sa)
    if dispatch.COUNT is None:
        out = _route(x2, qw, scale, x.dtype, on_card)
    else:
        with dispatch.COUNT.kernel("quant_matmul", cost(
                x2, qw, scale, x.dtype), (x2, qw, scale)):
            out = _route(x2, qw, scale, x.dtype, on_card)
    return out.reshape(*lead, qw.shape[-1])


def _route(x2, qw, scale, out_dtype, on_card):
    if on_card:
        return kernel.quant_matmul(x2, qw, scale, out_dtype=out_dtype)
    return ref.matmul(x2, qw, scale).to(out_dtype)
