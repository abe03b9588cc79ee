"""Binding of `csrc/unipc_update.cu`, the Hopper kernel that replaces
`repro/kernels/unipc_update/kernel.py:fused_combine_batched`."""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from ..dispatch import LAUNCHES, require_cuda

MAX_TERMS = 8


@functools.cache
def _launcher():
    fn = build.library("unipc_update").unipc_combine
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_combine_batched(terms: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """terms: (K, B, N) contiguous fp32/bf16 on the card; weights: (K,) or
    per-slot (K, B) fp32. Returns the (B, N) weighted sum, fp32-accumulated,
    in the terms' dtype."""
    require_cuda("unipc_update", terms, weights)
    if terms.ndim != 3 or not terms.is_contiguous():
        raise ValueError(f"unipc_update: terms must be a contiguous (K, B, N) "
                         f"tensor, got shape {tuple(terms.shape)}")
    K, B, N = terms.shape
    if not 1 <= K <= MAX_TERMS:
        raise ValueError(f"unipc_update: 1 <= K <= {MAX_TERMS}, got K={K}")
    if B > 65535:
        raise ValueError(f"unipc_update: at most 65535 batch rows, got {B}")
    per_slot = weights.ndim == 2
    if (weights.dtype != torch.float32 or not weights.is_contiguous()
            or weights.shape != ((K, B) if per_slot else (K,))):
        raise ValueError(f"unipc_update: weights must be contiguous fp32 "
                         f"(K,) or (K, B) = ({K}, {B}); got "
                         f"{weights.dtype} {tuple(weights.shape)}")
    out = torch.empty((B, N), dtype=terms.dtype, device=terms.device)
    rc = _launcher()(terms.data_ptr(), weights.data_ptr(), out.data_ptr(), K, B,
                     N, int(per_slot), build.dtype_code(terms.dtype),
                     build.stream_of(terms))
    build.check(rc, "unipc_update")
    LAUNCHES["unipc_update"] += 1
    return out
