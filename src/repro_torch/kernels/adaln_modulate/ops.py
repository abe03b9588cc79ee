"""Public wrapper for the fused adaLN modulation: device dispatch (the port of
`repro/kernels/adaln_modulate/ops.py`; the kernels take any D and T, so
there is no padding to do)."""

from __future__ import annotations

from typing import Optional

import torch

from . import kernel, ref
from ..dispatch import needs_grad, use_kernel


class _Modulate(torch.autograd.Function):
    """modulate on the card, differentiable: the forward kernel and the
    backward kernel (`kernel.modulate_bwd`)."""

    @staticmethod
    def forward(ctx, x, shift, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return kernel.adaln_modulate(x, shift, scale, eps=eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        return (*kernel.modulate_bwd(g.contiguous(), x, scale, ctx.eps), None)


class _GateResidual(torch.autograd.Function):
    """gate_residual on the card, differentiable: the forward kernel and the
    backward kernel (`kernel.gate_residual_bwd`)."""

    @staticmethod
    def forward(ctx, resid, gate, y):
        ctx.save_for_backward(gate, y)
        return kernel.gate_residual(resid, gate, y)

    @staticmethod
    def backward(ctx, g):
        return kernel.gate_residual_bwd(g.contiguous(), *ctx.saved_tensors)


def modulate(x, shift, scale, *, eps=1e-5, backend: Optional[str] = None):
    """LN(x) * (1 + scale) + shift in one pass. x: (B, T, D); shift/scale:
    (B, D). `backend="plain"` pins the plain version (kernels/dispatch.py).
    On the card, with grad mode on and an input that requires grad, the call
    goes through the backward kernel too; otherwise it is the forward
    kernel's launch alone."""
    if not use_kernel(backend, x):
        return ref.modulate(x, shift, scale, eps=eps)
    if needs_grad(x, shift, scale):
        return _Modulate.apply(x, shift, scale, eps)
    return kernel.adaln_modulate(x, shift, scale, eps=eps)


def gate_residual(resid, gate, y, *, backend: Optional[str] = None):
    """resid + gate * y in one pass. resid/y: (B, T, D); gate: (B, D). On
    the card, differentiable as `modulate` is."""
    if not use_kernel(backend, resid):
        return ref.gate_residual(resid, gate, y)
    if needs_grad(resid, gate, y):
        return _GateResidual.apply(resid, gate, y)
    return kernel.gate_residual(resid, gate, y)
