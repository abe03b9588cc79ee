"""Public wrapper for blockwise attention: device dispatch (the port of
`repro/kernels/flash_attention/ops.py`; the kernel masks ragged sequence
ends itself, so there is no padding to do), and the kernels' `cost` for
the operation count (`analysis/opcount.py`)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import kernel, ref
from .. import dispatch
from ..dispatch import Cost, laid_out_like, nbytes, needs_grad, use_kernel


def attention_pairs(Sq: int, Skv: int, causal: bool, window) -> int:
    """The (query, key) pairs the mask keeps, which the kernel scores: key j
    is visible to query i when j <= i (causal) and j > i - window, top-left
    aligned as `ref._visible` is; S * Skv unmasked."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def cost(q, k, v, *, causal, window, lse: bool = False) -> Cost:
    """q, k and v read, the output (q's dtype, v's width) written, and with
    `lse` the fp32 log-sum-exp and, for a bf16 q, the fp32 output copy;
    QK^T (q's depth D) and PV (v's width Dv) over the kept pairs only, at
    the peak of q's dtype."""
    B, Hq, Sq, D = q.shape
    Dv = v.shape[3]
    moved = nbytes(q, k, v) + B * Hq * Sq * Dv * q.element_size()
    if lse:
        moved += B * Hq * Sq * 4 * (1 + (Dv if q.dtype != torch.float32
                                          else 0))
    pairs = attention_pairs(Sq, k.shape[2], causal, window)
    return Cost(2 * B * Hq * pairs * (D + Dv), moved, q.dtype, matmul=True)


def cost_bwd(q, k, v, o, lse, do, *, causal, window) -> Cost:
    """q, k, v, o, lse and do read, dq, dk and dv written (the kernel's own
    Delta, which its dq pass writes and its dk/dv pass reads, is not the
    function's work); five products over the kept pairs (QK^T, dO V^T, dQ,
    dK, dV), at the peak of q's dtype."""
    B, Hq, Sq, D = q.shape
    pairs = attention_pairs(Sq, k.shape[2], causal, window)
    return Cost(10 * B * Hq * pairs * D,
                nbytes(q, k, v, o, lse, do, q, k, v), q.dtype, matmul=True)


def _route(q, k, v, causal, window, on_card, lse, scale=None):
    if on_card:
        return kernel.flash_attention(q, k, v, causal=causal, window=window,
                                      lse=lse, scale=scale)
    if not lse:
        out = ref.attention(q, k, v, causal=causal, window=window,
                            scale=scale)
        return out if v.shape[3] != q.shape[3] else laid_out_like(out, q)
    o32 = ref.attention32(q, k, v, causal=causal, window=window)
    out = laid_out_like(o32.to(q.dtype), q)
    lse_ = ref.attention_lse(q, k, causal=causal, window=window)
    # the kernel's fp32 output is its own fp32 copy, as here
    return out, lse_, out if q.dtype == torch.float32 else o32


def _attention(q, k, v, causal, window, on_card, lse=False, scale=None):
    if dispatch.COUNT is None:
        return _route(q, k, v, causal, window, on_card, lse, scale)
    with dispatch.COUNT.kernel("flash_attention", cost(
            q, k, v, causal=causal, window=window, lse=lse), (q, k, v)):
        return _route(q, k, v, causal, window, on_card, lse, scale)


def _route_bwd(q, k, v, o, lse, do, causal, window, on_card):
    if on_card:
        return kernel.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                          window=window)
    grads = ref.attention_bwd(q, k, v, o, lse, do, causal=causal,
                              window=window)
    return tuple(map(laid_out_like, grads, (q, k, v)))


class _Attention(torch.autograd.Function):
    """Attention, differentiable through its own backward: on the card the
    forward kernel (which also saves its log-sum-exp and its output before
    the rounding to q's dtype, for the backward's Delta) and the backward
    kernel (`kernel.flash_attention_bwd`), with the same mask and group
    size; off it the plain versions of both (`ref.attention_bwd`), so a
    backward runs, and counts, the same on every device."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, on_card):
        out, lse, o32 = _attention(q, k, v, causal, window, on_card,
                                   lse=True)
        ctx.save_for_backward(q, k, v, o32, lse)
        ctx.mask, ctx.on_card = (causal, window), on_card
        return out

    @staticmethod
    def backward(ctx, do):
        (causal, window), saved = ctx.mask, ctx.saved_tensors
        args = (*saved, do, causal, window, ctx.on_card)
        if dispatch.COUNT is None:
            return (*_route_bwd(*args), None, None, None)
        with dispatch.COUNT.kernel("flash_attention_bwd", cost_bwd(
                *saved, do, causal=causal, window=window), (*saved, do)):
            return (*_route_bwd(*args), None, None, None)


def attention(q, k, v, *, causal=True, window=None, scale=None,
              backend: Optional[str] = None):
    """(B, Hq, Sq, D) x (B, Hkv, Skv, D) -> (B, Hq, Sq, D). `backend="plain"`
    pins the plain version (kernels/dispatch.py), differentiated by
    autograd: the yardstick the backward kernel is held against. Otherwise,
    with grad mode on and an input that requires grad, the call is
    differentiable through the op's own backward: the backward kernel on
    the card, for every mask and group size the forward takes, and its
    plain version off it.

    MLA's form (`models/mla.py`): v (B, Hkv, Skv, Dv) narrower than q and
    k, and the scores times `scale` (1/sqrt(D) where None); forward only,
    with the kernel's qk-192 / v-128 body on the card."""
    on_card = use_kernel(backend, q)
    latent = scale is not None or v.shape[3] != q.shape[3]
    if backend is None and needs_grad(q, k, v):
        if latent:
            raise ValueError("attention: the backward takes equal q/k and "
                             "v head dims and the 1/sqrt(D) scale; MLA's "
                             "form is forward only (backend=\"plain\" "
                             "differentiates the plain version)")
        return _Attention.apply(q, k, v, causal, window, on_card)
    return _attention(q, k, v, causal, window, on_card, scale=scale)
