"""Binding of `csrc/adaln_modulate.cu`, the Hopper kernels that replace
`repro/kernels/adaln_modulate/kernel.py:adaln_modulate` and `:gate_residual`,
and of their backward kernels (`modulate_bwd`, `gate_residual_bwd`: the
training path), which replace the gradients XLA derives from those
forwards."""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from ..dispatch import LAUNCHES, require_cuda

MAX_D = 8 * 1024  # MOD_MAX_D in the source
ACCESS_BYTES = (16, 8, 4, 2)
# the register bodies the source compiles for both kernels: (dtype, access
# bytes, lanes per row, chunks per lane), for D = 1152 / 384 / 128
# (ROW_BODIES); any other
# operands run the generic body (32 lanes, chunks 0) at their access width
REGISTER_BODIES = {
    (torch.bfloat16, 16, 32, 5), (torch.bfloat16, 16, 16, 3),
    (torch.bfloat16, 16, 16, 1), (torch.float32, 16, 32, 9),
    (torch.float32, 16, 32, 3), (torch.float32, 16, 16, 2)}
MOD_THREADS = 256
# blocks of MOD_THREADS an SM holds at once with every register body of
# either kernel (ptxas: at most 128 registers a thread)
BLOCKS_PER_SM = 2
H100_SMS = build.H100_SMS
BWD_MAX_ROWS = 64       # rows of one tile of the backward (BWD_MAX_ROWS)
# blocks an SM that modulate_bwd's register bodies plan for (one row a
# group at the DiT's training shape)
BWD_BLOCKS_PER_SM = 1
# threads a block of modulate_bwd's register bodies (rows_threads<T>())
BWD_ROWS_THREADS = {torch.bfloat16: 512, torch.float32: 256}
# gate_residual_bwd: rows whose loads a thread has in flight at once
# (GATE_BWD_UNROLL in the source; a thread takes a multiple of them), the
# block size its plan aims at and the most the source takes
# (GATE_BWD_MAX_THREADS), the widest column strip of a block in chunks,
# and the blocks an SM its tiles are sized for
GATE_BWD_UNROLL = 4
GATE_BWD_THREADS = 256
GATE_BWD_MAX_THREADS = 512
GATE_BWD_MAX_COLS = 256
GATE_BWD_BLOCKS_PER_SM = 2


@functools.cache
def _launchers():
    lib = build.library("adaln_modulate")
    mod, gate = lib.adaln_modulate, lib.gate_residual
    mod.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    gate.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong] + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    mod.restype = gate.restype = ctypes.c_int
    return mod, gate


def _check_rows(name, x, *conds):
    """x: contiguous (B, T, D); conds: (B, D) rows with unit column stride
    and one shared row stride, all of x's dtype. Returns that row stride."""
    require_cuda(name, x, *conds)
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous (B, T, D) tensor, "
                         f"got shape {tuple(x.shape)}")
    B, _, D = x.shape
    if D > MAX_D:
        raise ValueError(f"{name}: D <= {MAX_D}, got {D}")
    row_stride = conds[0].stride(0)
    for c in conds:
        if c.dtype != x.dtype:
            raise ValueError(f"{name}: dtypes differ ({c.dtype} vs {x.dtype})")
        if (tuple(c.shape) != (B, D) or c.stride(1) != 1
                or c.stride(0) != row_stride):
            raise ValueError(f"{name}: conditioning rows must be (B, D) = "
                             f"({B}, {D}) with unit column stride and a "
                             f"shared row stride; got {tuple(c.shape)} "
                             f"strides {c.stride()}")
    return row_stride


def _row_plan(x: torch.Tensor, conds, out: torch.Tensor) -> dict:
    """The plan of either kernel over the (B, T, D) rows of x, its (B, D)
    conditioning rows `conds` (one shared row stride) and `out`."""
    B, T, D = x.shape
    if D > MAX_D:
        raise ValueError(f"D <= {MAX_D}, got {D}")
    size = x.element_size()
    # every address and byte stride the accesses step by, OR-ed: its low
    # bits bound the alignment they all share
    offsets = x.data_ptr() | out.data_ptr() | D * size | conds[0].stride(0) * size
    for c in conds:
        offsets |= c.data_ptr()
    width = next(w for w in ACCESS_BYTES if w <= size or offsets % w == 0)
    nvec = D * size // width
    lanes = 32 if nvec >= 64 else 16
    chunks = -(-nvec // lanes)
    if (x.dtype, width, lanes, chunks) in REGISTER_BODIES:
        body = "registers"
    else:
        body, lanes, chunks = "generic", 32, 0
    rows = MOD_THREADS // lanes
    sms = build.sm_count(x)
    per_b = -(-T // rows)                       # one row a group
    turns = -(-B * per_b // (BLOCKS_PER_SM * sms))
    return dict(body=body, access_bytes=width, lanes=lanes, chunks=chunks,
                rows_per_block=rows, blocks=B * -(-per_b // turns))


def plan(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
         out: torch.Tensor) -> dict:
    """Which body serves these operands, by dtype, D and alignment.

    `access_bytes` is the widest access (16, 8, 4 or 2 bytes, at least one
    element) that every pointer, the rows of x and out and the
    conditioning row stride are aligned to; a row is then
    `D * size / access_bytes` chunks. `lanes` own a row (32, or 16 under
    64 chunks) and `chunks` is the count per lane. The body is "registers"
    where that combination is compiled (REGISTER_BODIES), else "generic"
    (32 lanes, chunks 0). Blocks of MOD_THREADS hold `rows_per_block`
    rows of one b at once. Where one block per `rows_per_block` rows
    would overflow a wave (BLOCKS_PER_SM on each SM), `blocks` shrinks by
    an integer factor until it fits, and each group takes that many rows
    in turn (grid-stride), keeping its shift/scale registers.
    """
    return _row_plan(x, (shift, scale), out)


def plan_gate(resid: torch.Tensor, gate: torch.Tensor, y: torch.Tensor,
              out: torch.Tensor) -> dict:
    """gate_residual's plan: plan()'s rule over resid, the gate rows (their
    row stride in the conditioning stride's place), y and out. The
    register bodies hold the gate chunks of a group's columns across the
    rows it takes."""
    return _row_plan(resid, (gate, y), out)


def _launch_modulate(x, shift, scale, out, eps, p) -> None:
    """Launch the modulate kernel on plan `p` (see plan())."""
    B, T, D = x.shape
    rc = _launchers()[0](
        x.data_ptr(), shift.data_ptr(), scale.data_ptr(), out.data_ptr(), B,
        T, D, shift.stride(0), eps, build.dtype_code(x.dtype),
        p["access_bytes"], p["lanes"], p["chunks"],
        p["rows_per_block"] * p["lanes"] // 32, p["blocks"] // B,
        build.stream_of(x))
    build.check(rc, "adaln_modulate")
    LAUNCHES["adaln_modulate"] += 1


def adaln_modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """LN(x) * (1 + scale) + shift in one pass; x (B, T, D) fp32/bf16."""
    _check_rows("adaln_modulate", x, shift, scale)
    if x.shape[0] > 65535:
        raise ValueError(f"adaln_modulate: B <= 65535, got {x.shape[0]}")
    out = torch.empty_like(x)
    _launch_modulate(x, shift, scale, out, eps, plan(x, shift, scale, out))
    return out


def gate_residual(resid: torch.Tensor, gate: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """resid + gate * y in one pass; resid/y (B, T, D), gate (B, D)."""
    stride = _check_rows("gate_residual", resid, gate)
    if y.shape != resid.shape or y.dtype != resid.dtype or not y.is_contiguous():
        raise ValueError(f"gate_residual: y must match resid "
                         f"{tuple(resid.shape)} {resid.dtype} and be "
                         f"contiguous; got {tuple(y.shape)} {y.dtype}")
    require_cuda("gate_residual", resid, y)
    if resid.shape[0] > 65535:
        raise ValueError(f"gate_residual: B <= 65535, got {resid.shape[0]}")
    out = torch.empty_like(resid)
    _launch_gate(resid, gate, y, out, plan_gate(resid, gate, y, out))
    return out


def _launch_gate(resid, gate, y, out, p) -> None:
    """Launch the gate_residual kernel on plan `p` (see plan_gate())."""
    B, T, D = resid.shape
    rc = _launchers()[1](
        resid.data_ptr(), gate.data_ptr(), y.data_ptr(), out.data_ptr(), B, T,
        D, gate.stride(0), build.dtype_code(resid.dtype), p["access_bytes"],
        p["lanes"], p["chunks"], p["rows_per_block"] * p["lanes"] // 32,
        p["blocks"] // B, build.stream_of(resid))
    build.check(rc, "gate_residual", "adaln_modulate")
    LAUNCHES["gate_residual"] += 1


@functools.cache
def _bwd_launchers():
    lib = build.library("adaln_modulate")
    mod, gate = lib.adaln_modulate_bwd, lib.gate_residual_bwd
    mod.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_float] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    gate.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    mod.restype = gate.restype = ctypes.c_int
    return mod, gate


def bwd_rows(x: torch.Tensor) -> int:
    """Rows of one tile of modulate_bwd's generic body: about two blocks an
    SM over the B * T rows, at most BWD_MAX_ROWS (each tile leaves one
    partial row of the (B, D) sums in the workspace)."""
    B, T, _ = x.shape
    return max(1, min(BWD_MAX_ROWS, -(-B * T // (2 * build.sm_count(x)))))


def plan_bwd(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
             dx: torch.Tensor) -> dict:
    """modulate_bwd's plan: plan()'s rule over x, scale, g and dx (access
    width, lanes, chunks). Where plan() picks a register body, so does the
    backward: each group of `lanes` lanes reads a row of x and g once into
    registers and `rows_per_group` rows in turn, a block holding
    BWD_ROWS_THREADS // lanes rows at once and adding them to its tile's
    partial sums; the rows a group takes grow by an integer factor until
    the tiles fit BWD_BLOCKS_PER_SM blocks an SM. Else "generic":
    bwd_rows() rows a tile, each read from memory in every pass. `tiles`
    is a b's count of partial rows in the workspace, `blocks` the row
    pass's grid."""
    B, T, _ = x.shape
    p = _row_plan(x, (scale, g), dx)
    if p["body"] == "generic":
        rows = bwd_rows(x)
        return dict(p, rows_per_group=0, tiles=-(-T // rows),
                    blocks=B * -(-T // rows), tile_rows=rows)
    held = BWD_ROWS_THREADS[x.dtype] // p["lanes"]
    per_b = -(-T // held)
    turns = -(-B * per_b // (BWD_BLOCKS_PER_SM * build.sm_count(x)))
    tiles = -(-T // (held * turns))
    return dict(p, rows_per_group=turns, tiles=tiles, blocks=B * tiles,
                tile_rows=held * turns)


def plan_gate_bwd(g: torch.Tensor, gate: torch.Tensor, y: torch.Tensor,
                  dy: torch.Tensor) -> dict:
    """gate_residual_bwd's plan over g, the gate rows, y and dy.

    `access_bytes` is plan()'s rule over the four (16 at the DiT's shapes;
    narrower where a pointer, the rows or the gate's row stride allow no
    more): a row is `D * size / access_bytes` chunks, and each thread owns
    one chunk of every row it takes, its gate chunk held in registers. A
    block covers a strip of `cols` chunks (a row's, or an even share of
    it over `strips` strips of at most GATE_BWD_MAX_COLS) with `groups`
    row groups (about GATE_BWD_THREADS threads in all, at most
    GATE_BWD_MAX_THREADS); each group takes
    `rows_per_thread` rows of the tile in turn (a multiple of
    GATE_BWD_UNROLL, grown until the grid fits GATE_BWD_BLOCKS_PER_SM
    blocks an SM), so a tile is `tile_rows` rows and b has `tiles` of
    them: its count of partial rows in the workspace. `blocks` is the row
    pass's grid."""
    B, T, D = y.shape
    width = _row_plan(y, (gate, g), dy)["access_bytes"]
    nvec = D * y.element_size() // width
    strips = -(-nvec // GATE_BWD_MAX_COLS)
    cols = -(-nvec // strips)
    groups = max(1, min((GATE_BWD_THREADS + cols // 2) // cols,
                        GATE_BWD_MAX_THREADS // cols))
    per_b = -(-T // groups)                     # one row a group
    turns = -(-B * strips * per_b
              // (GATE_BWD_BLOCKS_PER_SM * build.sm_count(y)))
    turns = GATE_BWD_UNROLL * -(-turns // GATE_BWD_UNROLL)
    tiles = -(-T // (groups * turns))
    return dict(access_bytes=width, cols=cols, strips=strips, groups=groups,
                threads=cols * groups, rows_per_thread=turns,
                tile_rows=groups * turns, tiles=tiles,
                blocks=B * strips * tiles)


def _check_grad(name, g, x):
    if g.shape != x.shape or g.dtype != x.dtype or not g.is_contiguous():
        raise ValueError(f"{name}: the gradient must be a contiguous "
                         f"{tuple(x.shape)} {x.dtype} tensor; got "
                         f"{tuple(g.shape)} {g.dtype}")
    require_cuda(name, g, x)


def modulate_bwd(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-5) -> tuple:
    """(dx, dshift, dscale) of `adaln_modulate(x, shift, scale)` from the
    output's gradient g (contiguous, x's shape and dtype); dshift and dscale
    are new contiguous (B, D) tensors. Two launches (rows, then the sums
    over T), counted once; the plan is plan_bwd()'s."""
    _check_rows("adaln_modulate_bwd", x, scale)
    _check_grad("adaln_modulate_bwd", g, x)
    dx = torch.empty_like(x)
    dshift, dscale = _launch_modulate_bwd(g, x, scale, dx, eps,
                                          plan_bwd(g, x, scale, dx))
    return dx, dshift, dscale


def _launch_modulate_bwd(g, x, scale, dx, eps, p) -> tuple:
    """Launch modulate's backward on plan `p` (see plan_bwd()) into dx;
    returns the new (dshift, dscale)."""
    B, T, D = x.shape
    dshift, dscale = (torch.empty((B, D), dtype=x.dtype, device=x.device)
                      for _ in range(2))
    part = torch.empty((B, p["tiles"], 2, D), dtype=torch.float32,
                       device=x.device)
    rows = p["rows_per_group"] or p["tile_rows"]
    rc = _bwd_launchers()[0](
        g.data_ptr(), x.data_ptr(), scale.data_ptr(), dx.data_ptr(),
        dshift.data_ptr(), dscale.data_ptr(), part.data_ptr(), B, T, D,
        scale.stride(0), eps, build.dtype_code(x.dtype), rows,
        p["access_bytes"], p["lanes"], p["chunks"], build.stream_of(x))
    build.check(rc, "adaln_modulate_bwd", "adaln_modulate")
    LAUNCHES["adaln_modulate_bwd"] += 1
    return dshift, dscale


def gate_residual_bwd(g: torch.Tensor, gate: torch.Tensor,
                      y: torch.Tensor) -> tuple:
    """(dresid, dgate, dy) of `gate_residual(resid, gate, y)` from the
    output's gradient g: dresid is g itself, dy = gate * g (bit-equal to
    the plain version), dgate a new contiguous (B, D) tensor, the fp32 sum
    over T of g * y in a fixed order, rounded once. Two launches (the row
    pass, then the tile sums as its programmatic dependent), counted once;
    the plan is plan_gate_bwd()'s."""
    _check_rows("gate_residual_bwd", y, gate)
    _check_grad("gate_residual_bwd", g, y)
    dy = torch.empty_like(y)
    dgate = _launch_gate_bwd(g, gate, y, dy, plan_gate_bwd(g, gate, y, dy))
    return g, dgate, dy


def _launch_gate_bwd(g, gate, y, dy, p) -> torch.Tensor:
    """Launch gate_residual's backward on plan `p` (see plan_gate_bwd())
    into dy; returns the new dgate."""
    B, T, D = y.shape
    dgate = torch.empty((B, D), dtype=y.dtype, device=y.device)
    part = torch.empty((B, p["tiles"], D), dtype=torch.float32,
                       device=y.device)
    rc = _bwd_launchers()[1](
        g.data_ptr(), gate.data_ptr(), y.data_ptr(), dy.data_ptr(),
        dgate.data_ptr(), part.data_ptr(), B, T, D, gate.stride(0),
        build.dtype_code(y.dtype), p["access_bytes"], p["cols"],
        p["groups"], p["rows_per_thread"], build.stream_of(y))
    build.check(rc, "gate_residual_bwd", "adaln_modulate")
    LAUNCHES["gate_residual_bwd"] += 1
    return dgate
