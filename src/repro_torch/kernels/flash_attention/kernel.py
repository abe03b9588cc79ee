"""Binding of `csrc/flash_attention.cu`, the Hopper kernel that replaces
`repro/kernels/flash_attention/kernel.py:flash_attention`."""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from .. import build
from ..dispatch import LAUNCHES, require_cuda

MAX_D = 128
BLOCK_Q = 64            # 65535 query tiles of the fp32 body bound Sq
# the bf16 body is compiled for these head-dim widths in 8-column chunks;
# a D between them runs in the next one up, zero-padded in shared memory
MMA_CHUNKS = (4, 8, 9, 16)
MMA_BLOCK_Q = 128


@functools.cache
def _launcher():
    fn = build.library("flash_attention").flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _rows16(t: torch.Tensor) -> bool:
    """Every row of t's head dim starts on a 16-byte boundary."""
    return (t.data_ptr() % 16 == 0
            and all(t.stride(i) % 8 == 0 for i in range(3)))


def plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         out: torch.Tensor) -> dict:
    """Which body serves these operands, chosen by dtype and shape: fp32 ->
    "cuda_cores"; bf16 -> "mma" with the head dim compiled as `chunks`
    8-column chunks, rows loaded (`vec_in`) and stored (`vec_out`) as
    16-byte chunks where D % 8 == 0 and the rows are 16-byte aligned, else
    as 2-byte elements. `blocks` is the grid: one block per (b, h) and
    128-query tile (bf16), per (b, h) and 64-query tile (fp32)."""
    B, Hq, Sq, D = q.shape
    if q.dtype == torch.float32:
        return dict(body="cuda_cores", chunks=0, vec_in=False, vec_out=False,
                    blocks=B * Hq * -(-Sq // BLOCK_Q))
    chunks = next(c for c in MMA_CHUNKS if 8 * c >= D)
    aligned = D % 8 == 0
    return dict(body="mma", chunks=chunks,
                vec_in=aligned and all(_rows16(t) for t in (q, k, v)),
                vec_out=aligned and _rows16(out),
                blocks=B * Hq * -(-Sq // MMA_BLOCK_Q))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D); Hq % Hkv == 0, D <= 128,
    fp32 or bf16, any (b, h, s) strides with unit column stride. Returns
    (B, Hq, Sq, D) laid out like q (so a head-major view of a (B, S, H, D)
    projection comes back as one, ready to reshape)."""
    require_cuda("flash_attention", q, k, v)
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q (B, Hq, Sq, D), k/v (B, Hkv, "
                         f"Skv, D); got {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, Dk = k.shape
    if k.shape[0] != B or Dk != D or Hq % Hkv or D > MAX_D:
        raise ValueError(f"flash_attention: need matching B and D, Hq % Hkv "
                         f"== 0 and D <= {MAX_D}; got q {tuple(q.shape)} k "
                         f"{tuple(k.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q/k/v dtypes differ: {q.dtype} "
                         f"{k.dtype} {v.dtype}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim must have stride 1")
    if -(-Sq // BLOCK_Q) > 65535:
        raise ValueError(f"flash_attention: Sq <= {65535 * BLOCK_Q}, got {Sq}")
    out = torch.empty_like(q)   # keeps q's layout; dense, so stride(3) == 1
    strides = (ctypes.c_longlong * 12)(*[
        t.stride(i) for t in (q, k, v, out) for i in (0, 1, 2)])
    p = plan(q, k, v, out)
    rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     B, Hq, Hkv, Sq, Skv, D, ctypes.addressof(strides),
                     int(causal), int(window or 0), 1.0 / math.sqrt(D),
                     build.dtype_code(q.dtype), p["chunks"], int(p["vec_in"]),
                     int(p["vec_out"]), build.stream_of(q))
    build.check(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
