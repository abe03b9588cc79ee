"""Public wrapper for blockwise attention: device dispatch (the port of
`repro/kernels/flash_attention/ops.py`; the kernel masks ragged sequence
ends itself, so there is no padding to do)."""

from __future__ import annotations

from typing import Optional

import torch

from . import kernel, ref
from ..dispatch import needs_grad, use_kernel


class _Attention(torch.autograd.Function):
    """Attention on the card, differentiable: the forward kernel (which also
    saves its log-sum-exp and its output before the rounding to q's dtype,
    for the backward's Delta) and the backward kernel
    (`kernel.flash_attention_bwd`), with the same mask and group size."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse, o32 = kernel.flash_attention(q, k, v, causal=causal,
                                               window=window, lse=True)
        ctx.save_for_backward(q, k, v, o32, lse)
        ctx.mask = (causal, window)
        return out

    @staticmethod
    def backward(ctx, do):
        causal, window = ctx.mask
        dq, dk, dv = kernel.flash_attention_bwd(*ctx.saved_tensors, do,
                                                causal=causal, window=window)
        return dq, dk, dv, None, None


def attention(q, k, v, *, causal=True, window=None,
              backend: Optional[str] = None):
    """(B, Hq, Sq, D) x (B, Hkv, Skv, D) -> (B, Hq, Sq, D). `backend="plain"`
    pins the plain version (kernels/dispatch.py). On the card, with grad mode
    on and an input that requires grad, the call is differentiable through
    the backward kernel, for every mask and group size the forward
    takes."""
    if not use_kernel(backend, q):
        return ref.attention(q, k, v, causal=causal, window=window)
    if needs_grad(q, k, v):
        return _Attention.apply(q, k, v, causal, window)
    return kernel.flash_attention(q, k, v, causal=causal, window=window)
