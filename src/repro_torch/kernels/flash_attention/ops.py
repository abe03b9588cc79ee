"""Public wrapper for blockwise attention: device dispatch (the port of
`repro/kernels/flash_attention/ops.py`; the kernel masks ragged sequence
ends itself, so there is no padding to do)."""

from __future__ import annotations

from typing import Optional

import torch

from . import kernel, ref
from ..dispatch import needs_grad, use_kernel


class _Attention(torch.autograd.Function):
    """Non-causal attention with Hq == Hkv on the card, differentiable: the
    forward kernel (which also saves its log-sum-exp) and the backward
    kernel (`kernel.flash_attention_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = kernel.flash_attention(q, k, v, causal=False, lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        return kernel.flash_attention_bwd(*ctx.saved_tensors, do)


def attention(q, k, v, *, causal=True, window=None,
              backend: Optional[str] = None):
    """(B, Hq, Sq, D) x (B, Hkv, Skv, D) -> (B, Hq, Sq, D). `backend="plain"`
    pins the plain version (kernels/dispatch.py). On the card, with grad mode
    on and an input that requires grad, the call is differentiable through
    the backward kernel; that kernel covers the non-causal Hq == Hkv case
    only, and anything else raises rather than train on a detached
    output."""
    if not use_kernel(backend, q):
        return ref.attention(q, k, v, causal=causal, window=window)
    if needs_grad(q, k, v):
        if causal or window is not None or q.shape[1] != k.shape[1]:
            raise NotImplementedError(
                f"flash_attention backward: causal, window and GQA (Hq != "
                f"Hkv) are not yet ported to repro_torch (ROADMAP item 12); "
                f"got causal={causal}, window={window}, Hq={q.shape[1]}, "
                f"Hkv={k.shape[1]}")
        return _Attention.apply(q, k, v)
    return kernel.flash_attention(q, k, v, causal=causal, window=window)
