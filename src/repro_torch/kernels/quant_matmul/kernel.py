"""Binding of `csrc/quant_matmul.cu`, the Hopper kernel that replaces
`repro/kernels/quant_matmul/kernel.py:quant_matmul`."""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from ..dispatch import LAUNCHES, refuse_grad, require_cuda

X_DTYPES = (torch.float32, torch.bfloat16, torch.int8)
W_DTYPES = (torch.int8, torch.float8_e4m3fn)
OUT_DTYPES = (torch.float32, torch.bfloat16)
MAX_ROW_TILES = 65535       # grid.y of the WMMA bodies; their smallest row tile is 16
SKINNY_MAX_M = 64
# body -> (code shared with csrc/quant_matmul.cu, output tile BM x BN); a
# skinny tile is every row (M <= 64) of a strip of 64 columns (32 where the
# strips would not fill the card, or M > 32)
BODIES = {"cuda_cores": (0, (64, 64)), "wmma": (1, (128, 128)),
          "skinny": (2, (SKINNY_MAX_M, 64)), "wgmma": (3, (144, 128))}
SKINNY_MAX_SPLIT = 8        # warps a skinny block (SK_MAX_SPLIT in the source)


@functools.cache
def _launcher():
    """The C entry points (quant_matmul, quant_matmul_skinny)."""
    lib = build.library("quant_matmul")
    fn, sk = lib.quant_matmul, lib.quant_matmul_skinny
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    sk.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = sk.restype = ctypes.c_int
    return fn, sk


def skinny_smem(m_tiles: int, vw: int, split: int) -> int:
    """Dynamic shared memory of a skinny block (sk_smem in the source):
    the warps' partial sums."""
    return split * vw // 2 * m_tiles * 32 * 16


def _rows16(t: torch.Tensor) -> bool:
    """t's rows start on 16-byte boundaries (what TMA takes)."""
    return (t.data_ptr() % 16 == 0
            and t.stride(0) * t.element_size() % 16 == 0)


def plan(x: torch.Tensor, qw: torch.Tensor) -> dict:
    """Which body computes x @ qw, chosen by dtype and shape: fp32 x ->
    "cuda_cores"; M <= 64 (the adaLN sites) -> "skinny"; rows of x and qw
    on 16-byte boundaries -> "wgmma" (TMA loads); else "wmma". Returns the
    body, its output tile and the number of tiles of the output.

    The skinny body's plan adds `m_tiles` (n8 tiles of x rows: 2, 4 or 8
    for M up to 16, 32, 64), `vw` (weight bytes a lane loads from a row:
    8, a strip of 64 columns, where such strips fill three quarters of the
    SMs, else 4; always 4 with 8 x-row tiles), `split` (warps a block,
    each taking every split-th 16-row group of K: one a group, at most 8),
    `grid` (a block a strip, at most one an SM, the blocks then walking
    the strips in turn) and `access_x` / `access_w` (whole loads, 4 values
    of x and vw bytes of the weight, where the operand's start and row
    stride are aligned to them; else its element size: element loads)."""
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
    if body != "skinny":
        return dict(body=body, tile=(bm, bn),
                    blocks=-(-M // bm) * -(-N // bn))
    K = x.shape[1]
    m_tiles = 2 if M <= 16 else 4 if M <= 32 else 8
    sms = build.sm_count(x)
    vw = 8 if m_tiles < 8 and -(-N // 64) * 4 >= 3 * sms else 4
    strips = -(-N // (8 * vw))
    xa = 4 * x.element_size()
    aligned_x = x.data_ptr() % xa == 0 and x.stride(0) * x.element_size() % xa == 0
    aligned_w = qw.data_ptr() % vw == 0 and qw.stride(0) % vw == 0
    return dict(body=body, tile=(bm, 8 * vw), blocks=strips,
                m_tiles=m_tiles, vw=vw,
                split=min(SKINNY_MAX_SPLIT, -(-K // 16)),
                grid=min(strips, sms),
                access_x=xa if aligned_x else x.element_size(),
                access_w=vw if aligned_w else 1)


def quant_matmul(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor, *,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """x: (M, K) fp32/bf16/int8; qw: (K, N) int8 or fp8 e4m3; scale: (N,)
    fp32, contiguous. x and qw may have any row stride (unit column
    stride). Returns (x @ qw) * scale as a new contiguous (M, N) tensor of
    `out_dtype` (fp32 or bf16), fp32-accumulated. No backward: raises under
    grad (dispatch.refuse_grad)."""
    require_cuda("quant_matmul", x, qw, scale)
    refuse_grad("quant_matmul", x, scale)
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
    _launch(x, qw, scale, out, plan(x, qw))
    return out


def _launch(x, qw, scale, out, p) -> None:
    """Launch the body of plan `p` (see plan()) into `out`."""
    M, K = x.shape
    N = qw.shape[1]
    code = build.operand_code
    args = (x.data_ptr(), qw.data_ptr(), scale.data_ptr(), out.data_ptr(), M,
            N, K, x.stride(0), qw.stride(0), N, code(x.dtype), code(qw.dtype),
            code(out.dtype))
    fn, sk = _launcher()
    if p["body"] == "skinny":
        rc = sk(*args, p["m_tiles"], p["vw"], p["split"], p["grid"],
                int(p["access_x"] > x.element_size()), int(p["access_w"] > 1),
                build.stream_of(x))
    else:
        rc = fn(*args, BODIES[p["body"]][0], build.stream_of(x))
    build.check(rc, "quant_matmul")
    LAUNCHES["quant_matmul"] += 1
