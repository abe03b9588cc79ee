"""Binding of `csrc/unipc_update.cu`, the Hopper kernel that replaces
`repro/kernels/unipc_update/kernel.py:fused_combine_batched`: the weighted
combine, and the predictor and corrector of one sampler row, one body."""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from ..dispatch import LAUNCHES, refuse_grad, require_cuda
from .ref import ROW_FIXED

MAX_TERMS = 8
ROW_THREADS = 128
ACCESS_BYTES = (16, 8, 4, 2)
# operand modes of the one body (Mode in the source)
COMBINE, PREDICT, CORRECT = 0, 1, 2


class RowArgs(ctypes.Structure):
    """The source's RowArgs, field for field, passed by value: every
    operand as a base pointer (and a row stride in elements)."""
    _fields_ = [("ring", ctypes.c_void_p * MAX_TERMS),
                *((f, ctypes.c_void_p) for f in (
                    "x", "e_new", "x_pred", "out", "ring_out", "weights",
                    "rows", "idx")),
                *((f, ctypes.c_longlong) for f in (
                    "N", "rs_ring", "rs_x", "rs_e", "rs_xp")),
                *((f, ctypes.c_int) for f in (
                    "K", "B", "per_slot", "n_rows", "cols")),
                ("sign", ctypes.c_float)]


@functools.cache
def _launcher():
    fn = build.library("unipc_update").unipc_row
    fn.argtypes = [RowArgs] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def plan(views, B: int, N: int, like: torch.Tensor) -> dict:
    """The launch plan over `views`, every operand (outputs too) viewed
    flat as (..., B, N) with unit element stride, on `like`'s card.

    `access_bytes` is the widest access (16, 8, 4 or 2 bytes, at least one
    element) that every pointer and every row and slot stride is aligned
    to; a row is then N * size / access_bytes accesses and its N % (access
    elements) ragged end single elements. Blocks of ROW_THREADS threads take
    one access each a turn; `blocks_per_row` blocks serve a row, as many as
    its accesses need, at most the SM count over B, so the grid is one wave
    (grid-stride beyond it)."""
    size = views[0].element_size()
    bits = 0
    for v in views:
        bits |= v.data_ptr()
        for st in v.stride()[:-1]:
            bits |= st * size
    return _plan(bits, size, B, N, like)


def _plan(bits: int, size: int, B: int, N: int, like: torch.Tensor) -> dict:
    """plan() of operands whose pointers and byte strides OR to `bits`."""
    width = next(w for w in ACCESS_BYTES if w <= size or bits % w == 0)
    vec = width // size
    accesses = N // vec + N % vec
    per_row = min(-(-accesses // ROW_THREADS),
                  max(1, build.sm_count(like) // B))
    return dict(access_bytes=width, threads=ROW_THREADS,
                blocks_per_row=per_row)


def _launch(mode: int, args: RowArgs, like: torch.Tensor, p: dict) -> None:
    """Launch one mode of the body on plan `p`, on `like`'s stream."""
    rc = _launcher()(args, mode, build.dtype_code(like.dtype),
                     p["access_bytes"], p["blocks_per_row"], p["threads"],
                     build.stream_of(like))
    build.check(rc, "unipc_update")


def fused_combine_batched(terms: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """terms: (K, B, N) contiguous fp32/bf16 on the card; weights: (K,) or
    per-slot (K, B) fp32. Returns the (B, N) weighted sum, fp32-accumulated,
    in the terms' dtype. There is no backward: raises under grad
    (dispatch.refuse_grad)."""
    require_cuda("unipc_update", terms, weights)
    refuse_grad("unipc_update", terms, weights)
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
    args = RowArgs(out=out.data_ptr(), weights=weights.data_ptr(), N=N,
                   rs_ring=N, K=K, B=B, per_slot=int(per_slot))
    for k in range(K):
        args.ring[k] = terms.data_ptr() + k * B * N * terms.element_size()
    _launch(COMBINE, args, terms, plan((terms, out), B, N, terms))
    LAUNCHES["unipc_update"] += 1
    return out


def _lead_strides(t: torch.Tensor, lead: int, name: str) -> tuple:
    """The strides (elements) of t's first `lead` dims, its other dims one
    contiguous run of N elements (any stride between samples and ring
    slots)."""
    if t.is_contiguous():
        return t.stride()[:lead]
    try:
        return t.view(*t.shape[:lead], -1).stride()[:lead]
    except RuntimeError as err:
        raise ValueError(f"unipc_update: {name}'s per-sample dims must be "
                         f"contiguous; got shape {tuple(t.shape)} strides "
                         f"{t.stride()}") from err


def _row_args(x, E, rows, idx, sign, out):
    """Check the operands of a row op (x, the ring E, the packed table rows
    and the index idx) and fill its RowArgs, `out` the (B, N) output.
    Returns (args, the OR of their pointers and byte strides)."""
    if not isinstance(idx, torch.Tensor):
        raise ValueError(f"unipc_update: the row index must be a tensor on "
                         f"the card, got {type(idx).__name__}")
    require_cuda("unipc_update", x, E, rows, idx)
    K, B = E.shape[0] - 1, x.shape[0]
    if E.shape[1:] != x.shape or K < 1:
        raise ValueError(f"unipc_update: the ring must be (K + 1, *x.shape) "
                         f"with K >= 1; got E {tuple(E.shape)} for x "
                         f"{tuple(x.shape)}")
    if x.dtype not in build.DTYPE_CODES or E.dtype != x.dtype:
        raise ValueError(f"unipc_update: x and the ring share one dtype, "
                         f"fp32 or bf16; got {x.dtype} and {E.dtype}")
    if (rows.dtype != torch.float32 or rows.ndim != 2
            or not rows.is_contiguous()
            or rows.shape[1] != len(ROW_FIXED) + 2 * K):
        raise ValueError(f"unipc_update: rows must be a contiguous fp32 "
                         f"(n_rows, {len(ROW_FIXED) + 2 * K}) table for a "
                         f"ring of {K + 1}; got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if idx.dtype != torch.int64 or idx.shape not in ((), (B,)) or (
            not idx.is_contiguous()):
        raise ValueError(f"unipc_update: idx must be a contiguous int64 0-d "
                         f"or ({B},) tensor; got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if not 1 <= B <= 65535:
        raise ValueError(f"unipc_update: 1 to 65535 batch rows, got {B}")
    N, size = x.numel() // B, x.element_size()
    (rs_x,), (slot, rs_ring) = _lead_strides(x, 1, "x"), _lead_strides(
        E, 2, "E")
    base = E.data_ptr()
    args = RowArgs(x=x.data_ptr(), out=out.data_ptr(), rows=rows.data_ptr(),
                   idx=idx.data_ptr(), N=N, rs_x=rs_x, rs_ring=rs_ring, K=K,
                   B=B, per_slot=idx.ndim, n_rows=rows.shape[0],
                   cols=rows.shape[1], sign=sign)
    for k in range(K + 1):
        args.ring[k] = base + k * slot * size
    bits = (args.x | args.out | base
            | (rs_x | rs_ring | slot | N) * size)
    return args, bits


def unipc_row_predict(x: torch.Tensor, E: torch.Tensor, rows: torch.Tensor,
                      idx: torch.Tensor, sign: float) -> torch.Tensor:
    """x_pred of the row `idx` (an int64 0-d or (B,) tensor on the card,
    clipped to the table on the device) of the packed fp32 `rows`; x (B, ...)
    and the (K + 1, B, ...) ring E fp32 or bf16, their per-sample dims
    contiguous."""
    refuse_grad("unipc_update", x, E, rows)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    args, bits = _row_args(x, E, rows, idx, sign, out)
    _launch(PREDICT, args, x, _plan(bits, out.element_size(), args.B, args.N,
                                    x))
    LAUNCHES["unipc_update"] += 1
    return out


def unipc_row_correct(x: torch.Tensor, E: torch.Tensor, e_new: torch.Tensor,
                      x_pred: torch.Tensor, rows: torch.Tensor,
                      idx: torch.Tensor, sign: float) -> tuple:
    """(x_next, E_next) of the row `idx`, as `unipc_row_predict` takes its
    operands; e_new and x_pred are x-shaped, of x's dtype. E_next is a new
    tensor: E, which the caller may still hold, is never written."""
    refuse_grad("unipc_update", x, E, e_new, x_pred, rows)
    x_next = torch.empty_like(x, memory_format=torch.contiguous_format)
    E_next = torch.empty_like(E, memory_format=torch.contiguous_format)
    args, bits = _row_args(x, E, rows, idx, sign, x_next)
    require_cuda("unipc_update", x, e_new, x_pred)
    if e_new.shape != x.shape or x_pred.shape != x.shape or (
            e_new.dtype != x.dtype or x_pred.dtype != x.dtype):
        raise ValueError(f"unipc_update: e_new {e_new.dtype} "
                         f"{tuple(e_new.shape)} and x_pred {x_pred.dtype} "
                         f"{tuple(x_pred.shape)} must be x's dtype and shape "
                         f"{tuple(x.shape)}")
    (args.rs_e,), (args.rs_xp,) = (_lead_strides(e_new, 1, "e_new"),
                                   _lead_strides(x_pred, 1, "x_pred"))
    args.e_new, args.x_pred = e_new.data_ptr(), x_pred.data_ptr()
    args.ring_out = E_next.data_ptr()
    bits |= (args.e_new | args.x_pred | args.ring_out
             | (args.rs_e | args.rs_xp) * x.element_size())
    _launch(CORRECT, args, x, _plan(bits, x.element_size(), args.B, args.N,
                                    x))
    LAUNCHES["unipc_update"] += 1
    return x_next, E_next
