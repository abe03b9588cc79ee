"""Public wrapper for the fused adaLN modulation: device dispatch (the port of
`repro/kernels/adaln_modulate/ops.py`; the kernels take any D and T, so
there is no padding to do), and each kernel's `cost` for the operation
count (`analysis/opcount.py`)."""

from __future__ import annotations

from typing import Optional

import torch

from . import kernel, ref
from .. import dispatch
from ..dispatch import Cost, laid_out_like, nbytes, needs_grad, use_kernel


def cost_modulate(x, shift, scale) -> Cost:
    """x and the conditioning rows read, the output written; 8 fp32
    operations an element (mean, centring, variance, normalise, scale,
    shift)."""
    return Cost(8 * x.numel(), 2 * nbytes(x) + nbytes(shift, scale),
                torch.float32)


def cost_gate(resid, gate, y) -> Cost:
    """resid, y and the gate read, the output (resid's dtype) written; a
    multiply and an add an element, in fp32."""
    return Cost(2 * resid.numel(), nbytes(resid, y, resid) + nbytes(gate),
                torch.float32)


def cost_modulate_bwd(g, x, scale) -> Cost:
    """g, x and scale read, dx, dshift and dscale written; 15 fp32
    operations an element."""
    return Cost(15 * x.numel(), nbytes(g, x, x) + 3 * nbytes(scale),
                torch.float32)


def cost_gate_bwd(g, gate, y) -> Cost:
    """g, y and the gate read, dy and dgate written (dresid is g itself); 3
    fp32 operations an element."""
    return Cost(3 * y.numel(), nbytes(g, y, y) + 2 * nbytes(gate),
                torch.float32)


def _modulate_route(x, shift, scale, eps, on_card):
    if on_card:
        return kernel.adaln_modulate(x, shift, scale, eps=eps)
    return laid_out_like(ref.modulate(x, shift, scale, eps=eps), x)


def _modulate(x, shift, scale, eps, on_card):
    if dispatch.COUNT is None:
        return _modulate_route(x, shift, scale, eps, on_card)
    with dispatch.COUNT.kernel("adaln_modulate", cost_modulate(
            x, shift, scale), (x, shift, scale)):
        return _modulate_route(x, shift, scale, eps, on_card)


def _gate_route(resid, gate, y, on_card):
    if on_card:
        return kernel.gate_residual(resid, gate, y)
    return laid_out_like(ref.gate_residual(resid, gate, y), resid)


def _gate_residual(resid, gate, y, on_card):
    if dispatch.COUNT is None:
        return _gate_route(resid, gate, y, on_card)
    with dispatch.COUNT.kernel("gate_residual", cost_gate(resid, gate, y),
                               (resid, gate, y)):
        return _gate_route(resid, gate, y, on_card)


def _modulate_bwd_route(g, x, scale, eps, on_card):
    if on_card:
        return kernel.modulate_bwd(g, x, scale, eps)
    dx, dshift, dscale = ref.modulate_bwd(g, x, scale, eps)
    return laid_out_like(dx, x), dshift, dscale


def _gate_bwd_route(g, gate, y, on_card):
    if on_card:
        return kernel.gate_residual_bwd(g, gate, y)
    dresid, dgate, dy = ref.gate_residual_bwd(g, gate, y)
    return dresid, dgate, laid_out_like(dy, y)


class _Modulate(torch.autograd.Function):
    """modulate, differentiable through its own backward: on the card the
    forward kernel and the backward kernel (`kernel.modulate_bwd`); off it
    the plain versions of both (`ref.modulate_bwd`), so a backward runs,
    and counts, the same on every device."""

    @staticmethod
    def forward(ctx, x, shift, scale, eps, on_card):
        ctx.save_for_backward(x, scale)
        ctx.eps, ctx.on_card = eps, on_card
        return _modulate(x, shift, scale, eps, on_card)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        g = g.contiguous()
        args = (g, x, scale, ctx.eps, ctx.on_card)
        if dispatch.COUNT is None:
            return (*_modulate_bwd_route(*args), None, None)
        with dispatch.COUNT.kernel("adaln_modulate_bwd", cost_modulate_bwd(
                g, x, scale), (g, x, scale)):
            return (*_modulate_bwd_route(*args), None, None)


class _GateResidual(torch.autograd.Function):
    """gate_residual, differentiable as `_Modulate` is: the backward kernel
    `kernel.gate_residual_bwd` on the card, `ref.gate_residual_bwd` off
    it."""

    @staticmethod
    def forward(ctx, resid, gate, y, on_card):
        ctx.save_for_backward(gate, y)
        ctx.on_card = on_card
        return _gate_residual(resid, gate, y, on_card)

    @staticmethod
    def backward(ctx, g):
        gate, y = ctx.saved_tensors
        g = g.contiguous()
        if dispatch.COUNT is None:
            return (*_gate_bwd_route(g, gate, y, ctx.on_card), None)
        with dispatch.COUNT.kernel("gate_residual_bwd",
                                   cost_gate_bwd(g, gate, y), (g, gate, y)):
            return (*_gate_bwd_route(g, gate, y, ctx.on_card), None)


def modulate(x, shift, scale, *, eps=1e-5, backend: Optional[str] = None):
    """LN(x) * (1 + scale) + shift in one pass. x: (B, T, D); shift/scale:
    (B, D). `backend="plain"` pins the plain version (kernels/dispatch.py),
    differentiated by autograd: the yardstick the backward kernel is held
    against. Otherwise, with grad mode on and an input that requires grad,
    the call goes through the op's own backward too (the backward kernel on
    the card, its plain version off it); without, it is the forward alone."""
    on_card = use_kernel(backend, x)
    if backend is None and needs_grad(x, shift, scale):
        return _Modulate.apply(x, shift, scale, eps, on_card)
    return _modulate(x, shift, scale, eps, on_card)


def gate_residual(resid, gate, y, *, backend: Optional[str] = None):
    """resid + gate * y in one pass. resid/y: (B, T, D); gate: (B, D).
    Differentiable as `modulate` is."""
    on_card = use_kernel(backend, resid)
    if backend is None and needs_grad(resid, gate, y):
        return _GateResidual.apply(resid, gate, y, on_card)
    return _gate_residual(resid, gate, y, on_card)
