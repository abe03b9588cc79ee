"""Binding of `csrc/quant_matmul.cu`, the Hopper kernel that replaces
`repro/kernels/quant_matmul/kernel.py:quant_matmul`."""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from ..dispatch import LAUNCHES, require_cuda

X_DTYPES = (torch.float32, torch.bfloat16, torch.int8)
W_DTYPES = (torch.int8, torch.float8_e4m3fn)
OUT_DTYPES = (torch.float32, torch.bfloat16)
MAX_ROW_TILES = 65535       # grid.y of the WMMA bodies; their smallest row tile is 16
SKINNY_MAX_M = 64
# body -> (code shared with csrc/quant_matmul.cu, output tile BM x BN)
BODIES = {"cuda_cores": (0, (64, 64)), "wmma": (1, (128, 128)),
          "skinny": (2, (16, 32)), "wgmma": (3, (144, 128))}


@functools.cache
def _launcher():
    fn = build.library("quant_matmul").quant_matmul
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _rows16(t: torch.Tensor) -> bool:
    """t's rows start on 16-byte boundaries (what TMA takes)."""
    return (t.data_ptr() % 16 == 0
            and t.stride(0) * t.element_size() % 16 == 0)


def plan(x: torch.Tensor, qw: torch.Tensor) -> dict:
    """Which body computes x @ qw, chosen by dtype and shape: fp32 x ->
    "cuda_cores"; M <= 64 (the adaLN sites) -> "skinny"; rows of x and qw
    on 16-byte boundaries -> "wgmma" (TMA loads); else "wmma". Returns the
    body, its output tile and the number of tiles (blocks) of the grid."""
    M, N = x.shape[0], qw.shape[1]
    if x.dtype == torch.float32:
        body = "cuda_cores"
    elif M <= SKINNY_MAX_M:
        body = "skinny"
    elif _rows16(x) and _rows16(qw):
        body = "wgmma"
    else:
        body = "wmma"
    bm, bn = BODIES[body][1]
    return dict(body=body, tile=(bm, bn), blocks=-(-M // bm) * -(-N // bn))


def quant_matmul(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor, *,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """x: (M, K) fp32/bf16/int8; qw: (K, N) int8 or fp8 e4m3; scale: (N,)
    fp32, contiguous. x and qw may have any row stride (unit column
    stride). Returns (x @ qw) * scale as a new contiguous (M, N) tensor of
    `out_dtype` (fp32 or bf16), fp32-accumulated."""
    require_cuda("quant_matmul", x, qw, scale)
    if x.ndim != 2 or qw.ndim != 2 or x.shape[1] != qw.shape[0]:
        raise ValueError(f"quant_matmul: x (M, K) @ qw (K, N); got "
                         f"{tuple(x.shape)} @ {tuple(qw.shape)}")
    M, K = x.shape
    N = qw.shape[1]
    if min(M, K, N) < 1 or -(-M // 16) > MAX_ROW_TILES:
        raise ValueError(f"quant_matmul: need 1 <= M <= {16 * MAX_ROW_TILES}"
                         f" and K, N >= 1; got M={M} K={K} N={N}")
    if (x.dtype not in X_DTYPES or qw.dtype not in W_DTYPES
            or out_dtype not in OUT_DTYPES):
        raise ValueError(f"quant_matmul: x in {X_DTYPES}, qw in {W_DTYPES}, "
                         f"out in {OUT_DTYPES}; got {x.dtype}, {qw.dtype}, "
                         f"{out_dtype}")
    if x.stride(1) != 1 or qw.stride(1) != 1:
        raise ValueError("quant_matmul: x and qw need unit column stride")
    if (scale.dtype != torch.float32 or tuple(scale.shape) != (N,)
            or not scale.is_contiguous()):
        raise ValueError(f"quant_matmul: scale must be a contiguous fp32 "
                         f"({N},) tensor; got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    code = build.operand_code
    rc = _launcher()(x.data_ptr(), qw.data_ptr(), scale.data_ptr(),
                     out.data_ptr(), M, N, K, x.stride(0), qw.stride(0), N,
                     code(x.dtype), code(qw.dtype), code(out_dtype),
                     BODIES[plan(x, qw)["body"]][0], build.stream_of(x))
    build.check(rc, "quant_matmul")
    LAUNCHES["quant_matmul"] += 1
    return out
