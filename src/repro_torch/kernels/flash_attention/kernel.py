"""Binding of `csrc/flash_attention.cu`, the Hopper kernel that replaces
`repro/kernels/flash_attention/kernel.py:flash_attention`, and of its
backward (`flash_attention_bwd`, the training path: every mask and group
size the forward takes), which replaces the gradient XLA derives from that
forward."""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from .. import build
from ..dispatch import LAUNCHES, require_cuda

MAX_D = 128
# the (score depth, value width) pairs of the MLA body, compiled in 8-column
# chunks each: DeepSeek-V2's 128 + 64 deep scores over 128-wide values
MLA_DIMS = {(192, 128): (24, 16)}
BLOCK_Q = 64            # 65535 query tiles of the fp32 body bound Sq
# the bf16 body is compiled for these head-dim widths in 8-column chunks;
# a D between them runs in the next one up, zero-padded in shared memory
MMA_CHUNKS = (4, 8, 9, 16)
MMA_BLOCK_Q = 128
# the backward's wgmma body (sm_90a): head dims from 64 to 128 compiled in
# 8-column chunks (a D between them runs in the next one up), 64-row tiles
# in both passes, and at most WGMMA_MAX_GROUP q heads a kv head (a thread
# block cluster)
WGMMA_CHUNKS = (8, 9, 14, 16)
WGMMA_ROWS = 64
WGMMA_MAX_GROUP = 8
# with one query tile (Sq <= WGMMA_ROWS) a dk/dv block's cluster sum of its
# group's dK and dV outweighs its one tile of work, and the mma body, each
# block walking the group's heads, is faster (llama-vision's 64 queries over
# 1600, GQA 64/8, on an H100: PERF.md §6): there the wgmma body takes no
# group larger than this
WGMMA_ONE_TILE_MAX_GROUP = 1
BWD_BODIES = {"cuda_cores": 0, "mma": 0, "wgmma": 1}


@functools.cache
def _launcher():
    fn = build.library("flash_attention").flash_attention
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _mla_launcher():
    fn = build.library("flash_attention").flash_attention_mla
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float] + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_launcher():
    fn = build.library("flash_attention").flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float] + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _rows16(t: torch.Tensor) -> bool:
    """Every row of t's head dim starts on a 16-byte boundary."""
    return (t.data_ptr() % 16 == 0
            and all(t.stride(i) % 8 == 0 for i in range(3)))


def plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         out: torch.Tensor) -> dict:
    """Which body serves these operands, chosen by dtype and shape: a v
    narrower than q and k -> "mla" (`MLA_DIMS`: `chunks` of the scores'
    depth, `chunks_v` of the values' width); fp32 ->
    "cuda_cores"; bf16 -> "mma" with the head dim compiled as `chunks`
    8-column chunks, rows loaded (`vec_in`) and stored (`vec_out`) as
    16-byte chunks where D % 8 == 0 and the rows are 16-byte aligned, else
    as 2-byte elements. `blocks` is the grid: one block per (b, h) and
    128-query tile (bf16), per (b, h) and 64-query tile (fp32)."""
    B, Hq, Sq, D = q.shape
    if v.shape[3] != D:
        chunks, chunks_v = MLA_DIMS[(D, v.shape[3])]
        return dict(body="mla", chunks=chunks, chunks_v=chunks_v,
                    vec_in=all(_rows16(t) for t in (q, k, v)),
                    vec_out=_rows16(out), blocks=B * Hq * -(-Sq // MMA_BLOCK_Q))
    if q.dtype == torch.float32:
        return dict(body="cuda_cores", chunks=0, vec_in=False, vec_out=False,
                    blocks=B * Hq * -(-Sq // BLOCK_Q))
    chunks = next(c for c in MMA_CHUNKS if 8 * c >= D)
    aligned = D % 8 == 0
    return dict(body="mma", chunks=chunks,
                vec_in=aligned and all(_rows16(t) for t in (q, k, v)),
                vec_out=aligned and _rows16(out),
                blocks=B * Hq * -(-Sq // MMA_BLOCK_Q))


def check_operands(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> tuple:
    """The forward's shape, dtype and stride checks, on any device: q (B,
    Hq, Sq, D), k (B, Hkv, Skv, D), v (B, Hkv, Skv, Dv), one dtype, unit
    column strides, Hq % Hkv == 0, and either Dv == D <= MAX_D or (D, Dv) a
    pair of `MLA_DIMS` in bf16. Returns (B, Hq, Hkv, Sq, Skv, D, Dv)."""
    if (q.ndim != 4 or k.ndim != 4 or v.ndim != 4
            or v.shape[:3] != k.shape[:3]
            or (v.shape[3] != k.shape[3]
                and (k.shape[3], v.shape[3]) not in MLA_DIMS)):
        raise ValueError(f"flash_attention: q (B, Hq, Sq, D), k/v (B, Hkv, "
                         f"Skv, D); got {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, Dk = k.shape
    Dv = v.shape[3]
    if (k.shape[0] != B or Dk != D or Hq % Hkv
            or (Dv == D and D > MAX_D)):
        raise ValueError(f"flash_attention: need matching B and D, Hq % Hkv "
                         f"== 0 and D <= {MAX_D}; got q {tuple(q.shape)} k "
                         f"{tuple(k.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q/k/v dtypes differ: {q.dtype} "
                         f"{k.dtype} {v.dtype}")
    if Dv != D and q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention: the MLA body ({D} deep scores, "
                         f"{Dv} wide values) takes bf16, got {q.dtype}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim must have stride 1")
    if -(-Sq // BLOCK_Q) > 65535:
        raise ValueError(f"flash_attention: Sq <= {65535 * BLOCK_Q}, got {Sq}")
    return B, Hq, Hkv, Sq, Skv, D, Dv


def _empty_out(q: torch.Tensor, Dv: int) -> torch.Tensor:
    """An output (B, Hq, Sq, Dv) laid out like q: its dims in q's order of
    strides, dense, so stride(3) == 1."""
    if Dv == q.shape[3]:
        return torch.empty_like(q)
    order = sorted(range(4), key=lambda i: -q.stride(i))
    shape = [q.shape[i] if i != 3 else Dv for i in order]
    t = torch.empty(shape, dtype=q.dtype, device=q.device)
    return t.permute([order.index(i) for i in range(4)])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    lse: bool = False, scale: Optional[float] = None):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D); Hq % Hkv == 0, D <= 128,
    fp32 or bf16, any (b, h, s) strides with unit column stride. Returns
    (B, Hq, Sq, D) laid out like q (so a head-major view of a (B, S, H, D)
    projection comes back as one, ready to reshape). With `lse=True` also
    what the backward reads: the (B, Hq, Sq) fp32 log-sum-exp of each
    query's scaled scores and the output in fp32 before its rounding to q's
    dtype, (B, Hq, Sq, D) contiguous (fp32 q: `out` itself), for Delta:
    (out, lse, o32). The output is the same either way. The scores are
    scaled by `scale`, 1/sqrt(D) where None.

    MLA's form: v (B, Hkv, Skv, Dv) narrower than q and k, (D, Dv) a pair
    of `MLA_DIMS` (192, 128), bf16; the output (B, Hq, Sq, Dv)."""
    require_cuda("flash_attention", q, k, v)
    B, Hq, Hkv, Sq, Skv, D, Dv = check_operands(q, k, v)
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    out = _empty_out(q, Dv)   # keeps q's layout; dense, so stride(3) == 1
    lse_out = o32_out = None
    if lse:
        lse_out = torch.empty((B, Hq, Sq), dtype=torch.float32,
                              device=q.device)
        o32_out = (out if q.dtype == torch.float32 else torch.empty(
            (B, Hq, Sq, Dv), dtype=torch.float32, device=q.device))
    strides = (ctypes.c_longlong * 12)(*[
        t.stride(i) for t in (q, k, v, out) for i in (0, 1, 2)])
    p = plan(q, k, v, out)
    lse_ptr = 0 if lse_out is None else lse_out.data_ptr()
    o32_ptr = (0 if o32_out is None or o32_out is out
               else o32_out.data_ptr())
    if p["body"] == "mla":
        rc = _mla_launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse_ptr, o32_ptr, B, Hq, Hkv, Sq, Skv, D, Dv,
            ctypes.addressof(strides), int(causal), int(window or 0), scale,
            p["chunks"], p["chunks_v"], int(p["vec_in"]), int(p["vec_out"]),
            build.stream_of(q))
    else:
        rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), lse_ptr, o32_ptr,
                         B, Hq, Hkv, Sq, Skv, D, ctypes.addressof(strides),
                         int(causal), int(window or 0), scale,
                         build.dtype_code(q.dtype), p["chunks"],
                         int(p["vec_in"]), int(p["vec_out"]),
                         build.stream_of(q))
    build.check(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return (out, lse_out, o32_out) if lse else out


def plan_bwd(q, k, v, do, o=None) -> dict:
    """The backward's body, chosen up front by dtype, shape and alignment:
    fp32 -> "cuda_cores"; bf16 -> "wgmma" (the sm_90a body: TMA tiles from
    a producer warp, wgmma products) where D % 8 == 0 and D >= 64, every
    row of q, k, v and do is 16-byte aligned (`vec_in`), the rows of `o`
    (the forward's fp32 output; contiguous when not given) are too, and a
    kv head has at most WGMMA_MAX_GROUP q heads (WGMMA_ONE_TILE_MAX_GROUP
    where Sq fits one 64-query tile), with the head dim compiled as
    `chunks` 8-column chunks of WGMMA_CHUNKS; else "mma" (mma.sync) with the
    forward's chunks and 2-byte loads where rows are not 16-byte aligned.
    `blocks` is the grid of each of its two passes: the dq pass one block
    per (b, q head) and 64-query tile; the dk/dv pass one block per (b, kv
    head) and 64-key tile (mma: each summing the kv head's group of q
    heads in turn), or per (b, q head) and 64-key tile (wgmma: `cluster`
    blocks, the group, summing their dk and dv in head order)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    grids = (B * Hq * -(-Sq // BLOCK_Q), B * Hkv * -(-Skv // BLOCK_Q))
    if q.dtype == torch.float32:
        return dict(body="cuda_cores", chunks=0, vec_in=False, blocks=grids)
    vec_in = D % 8 == 0 and all(_rows16(t) for t in (q, k, v, do))
    o_rows = o is None or (o.data_ptr() % 16 == 0
                           and all(o.stride(i) % 4 == 0 for i in range(3)))
    positive = all(t.stride(i) > 0 or t.shape[i] == 1
                   for t in (q, k, v, do) for i in range(3))
    max_group = (WGMMA_MAX_GROUP if Sq > WGMMA_ROWS
                 else min(WGMMA_MAX_GROUP, WGMMA_ONE_TILE_MAX_GROUP))
    if (vec_in and D >= 64 and o_rows and positive
            and group <= max_group and B * Hkv <= 65535):
        return dict(body="wgmma",
                    chunks=next(c for c in WGMMA_CHUNKS if 8 * c >= D),
                    vec_in=True, cluster=group,
                    blocks=(B * Hq * -(-Sq // WGMMA_ROWS),
                            B * Hq * -(-Skv // WGMMA_ROWS)))
    return dict(body="mma", chunks=next(c for c in MMA_CHUNKS if 8 * c >= D),
                vec_in=vec_in, blocks=grids)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = False,
                        window: Optional[int] = None) -> tuple:
    """(dq, dk, dv) of `flash_attention(q, k, v, causal=causal,
    window=window)` from its output `o`, its log-sum-exp `lse` (B, Hq, Sq,
    fp32) and the output's gradient `do`: q, o, do (B, Hq, Sq, D); k, v
    (B, Hkv, Skv, D), Hq % Hkv == 0 (dk and dv of a kv head sum its group
    of q heads). Any (b, h, s) strides with unit column stride; each
    gradient is laid out like its input. Note the default: non-causal.
    Delta = rowsum(do * o) is read from the output before its rounding, so
    `o` is fp32: for bf16 q the forward's o32 (the third of
    `flash_attention(..., lse=True)`, what the autograd Function saves)."""
    require_cuda("flash_attention_bwd", q, k, v, o, lse, do)
    B, Hq, Sq, D = q.shape
    if (q.ndim != 4 or k.ndim != 4 or v.shape != k.shape
            or k.shape[0] != B or k.shape[3] != D or Hq % k.shape[1]
            or o.shape != q.shape or do.shape != q.shape):
        raise ValueError(f"flash_attention_bwd: q/o/do (B, Hq, Sq, D), k/v "
                         f"(B, Hkv, Skv, D) with Hq % Hkv == 0; got q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} o {tuple(o.shape)} do "
                         f"{tuple(do.shape)}")
    Hkv, Skv = k.shape[1], k.shape[2]
    if (D > MAX_D or any(t.dtype != q.dtype for t in (k, v, do))
            or o.dtype != torch.float32):
        raise ValueError(f"flash_attention_bwd: D <= {MAX_D}, one dtype for "
                         f"q, k, v, do and an fp32 o; got D {D}, "
                         f"{[t.dtype for t in (q, k, v, o, do)]}")
    if (lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous "
                         f"fp32 ({B}, {Hq}, {Sq}); got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    if do.stride(3) != 1:
        do = do.contiguous()
    if any(t.stride(3) != 1 for t in (q, k, v, o)):
        raise ValueError("flash_attention_bwd: the head dim must have "
                         "stride 1")
    if -(-max(Sq, Skv) // BLOCK_Q) > 65535:
        raise ValueError(f"flash_attention_bwd: Sq, Skv <= {65535 * BLOCK_Q}")
    p = plan_bwd(q, k, v, do, o)
    # the workspace: Delta (mma), or each query's (lse2, Delta) over whole
    # 64-query tiles (wgmma)
    delta = torch.empty(
        (B, Hq, -(-Sq // WGMMA_ROWS) * WGMMA_ROWS, 2) if p["body"] == "wgmma"
        else (B, Hq, Sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    strides = (ctypes.c_longlong * 24)(*[
        t.stride(i) for t in (q, k, v, o, do, dq, dk, dv) for i in (0, 1, 2)])
    rc = _bwd_launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, Hq, Hkv, Sq, Skv, D, ctypes.addressof(strides),
        int(causal), int(window or 0), 1.0 / math.sqrt(D),
        build.dtype_code(q.dtype), p["chunks"], int(p["vec_in"]),
        BWD_BODIES[p["body"]], build.stream_of(q))
    build.check(rc, "flash_attention_bwd", "flash_attention")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
