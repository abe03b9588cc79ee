"""Public wrapper for blockwise attention: device dispatch (the port of
`repro/kernels/flash_attention/ops.py`; the kernel masks ragged sequence
ends itself, so there is no padding to do)."""

from __future__ import annotations

from typing import Optional

from . import kernel, ref
from ..dispatch import use_kernel


def attention(q, k, v, *, causal=True, window=None,
              backend: Optional[str] = None):
    """(B, Hq, Sq, D) x (B, Hkv, Skv, D) -> (B, Hq, Sq, D). `backend="plain"`
    pins the plain version (kernels/dispatch.py)."""
    if not use_kernel(backend, q):
        return ref.attention(q, k, v, causal=causal, window=window)
    return kernel.flash_attention(q, k, v, causal=causal, window=window)
