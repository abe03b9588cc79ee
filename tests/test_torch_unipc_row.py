"""The sampler row's predictor and corrector (the `unipc_update` row ops).

On the CPU the row ops run their plain versions. Those are held bit for
bit (`assert_array_equal`) against the row as `step_fn_over_rows` composed
it from torch ops and the plain weighted combine before the row ops
existed (`_composed_step`, kept below as that reference): uniform and
per-slot indices, the init row, warm-up rows, indices past the table,
K = 1-5, fp32 and bf16 rings. The CPU tests also pin the packed table's
column layout against the CUDA source, the binding's struct against the
source's, the kernel's launch plan, and the sampler driven by a device
index. The `gpu` tests hold the kernel against the plain version on the
card (bit-equal at fp32; bf16 <= 1e-2, DESIGN.md §11.3), its refusals, and
a CUDA graph of a row replayed on a new row index; they skip without a
card.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from repro_torch.core import unipc
from repro_torch.core.coeffs import augment_step_rows
from repro_torch.diffusion import VPLinear
from repro_torch.engine import EngineSpec, SamplerEngine
from repro_torch.kernels import build
from repro_torch.kernels.unipc_update import kernel as row_kernel
from repro_torch.kernels.unipc_update import ops as row_ops
from repro_torch.kernels.unipc_update import ref as row_ref

torch.set_num_threads(2)

ORDER_OF_K = {1: 2, 2: 3, 3: 4, 4: 5, 5: 6}   # K = order - 1 (at least 1)


def _schedule(K, nfe=8):
    """A real UniPC schedule whose ring has K + 1 slots: data prediction
    for odd K, noise (sign -1) for even K."""
    sched = unipc.make_unipc_schedule(VPLinear(), nfe, order=ORDER_OF_K[K],
                                      prediction="data" if K % 2 else "noise")
    assert sched.w_pred.shape[1] == K
    return sched


def _table(K, device="cpu"):
    """(device step table, sign) of `_schedule(K)`."""
    sched = _schedule(K)
    return unipc.rows_on(augment_step_rows(sched), device), sched.sign


def _state(K, B, dtype, seed, device="cpu", N=(4, 6)):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((B,) + N, generator=g)
    E = torch.randn((K + 1, B) + N, generator=g)
    return x.to(device=device, dtype=dtype), E.to(device=device, dtype=dtype)


def _stub(seen):
    """A stub eval: a fixed function of x_pred and t, recording both."""
    def model(x, t, **kw):
        seen.append((x.clone(), t.clone()))
        tt = t.reshape(t.shape + (1,) * (x.ndim - t.ndim))
        return 0.5 * x - 0.25 * tt
    return model


def _composed_step(model_fn, tab, *, sign):
    """The sampler row as `step_fn_over_rows` composed it before the row
    ops: torch ops around two plain weighted combines (the reference that
    the plain row ops reproduce bit for bit)."""
    col_keys = sorted(k for k in tab if k.startswith("mc_"))
    n_rows = tab["t"].shape[0]
    combine = row_ref.weighted_combine

    def step(carry, idx, model_kwargs=None):
        x, E = carry
        idx = torch.as_tensor(idx, device=x.device).long().clamp(0, n_rows - 1)
        per_slot = idx.ndim == 1
        row = {k: v[idx] for k, v in tab.items()}

        def wstack(base_x, base_m0, w_prev, w_new=None):
            scale = row["out_scale"][..., None] if per_slot else row["out_scale"]
            parts = [base_x[None], base_m0[None],
                     torch.movedim(sign * scale * w_prev, -1, 0)]
            if w_new is not None:
                parts.append((sign * row["out_scale"] * w_new)[None])
            return torch.cat(parts, dim=0)

        m0 = E[0]
        diffs = E[1:] - m0[None]
        extras = {k[3:]: row[k] for k in col_keys}
        if model_kwargs:
            extras = {**extras, **model_kwargs}
        terms = torch.cat([x[None], m0[None], diffs], dim=0)
        x_pred = combine(terms, wstack(row["base_x"], row["base_m0"],
                                       row["w_pred"]))
        e_new = model_fn(x_pred, row["t"], **extras).to(E.dtype)
        d_new = e_new - m0
        terms_c = torch.cat([terms, d_new[None]], dim=0)
        x_corr = combine(terms_c, wstack(row["base_x_c"], row["base_m0_c"],
                                         row["w_corr_prev"], row["w_corr_new"]))
        use_c = (row["use_c"].reshape((-1,) + (1,) * (x.ndim - 1))
                 if per_slot else row["use_c"])
        x_next = x_pred + use_c * (x_corr - x_pred)
        E_next = torch.cat([e_new[None], E[:-1]], dim=0)
        return x_next, E_next

    return step


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.float().numpy(), b.float().numpy())


# uniform rows: the init row, the warm-up rows, a body row, the last row,
# past the table and below it (both clipped)
UNIFORM = (0, 1, 2, 5, 8, 9, 40, -3)


@pytest.mark.parametrize("K", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["uniform", "per-slot"])
def test_plain_row_ops_match_the_composed_row(K, dtype, kind):
    tab, sign = _table(K)
    B = 5
    x, E = _state(K, B, dtype, seed=K)
    indices = ([torch.tensor(i) for i in UNIFORM] if kind == "uniform" else
               [torch.tensor([0, 1, 4, 9, 30]), torch.tensor([3, 3, 0, 2, 8])])
    for idx in indices:
        seen_old, seen_new = [], []
        want = _composed_step(_stub(seen_old), tab, sign=sign)((x, E), idx)
        got = unipc.step_fn_over_rows(_stub(seen_new), tab, sign=sign)(
            (x, E), idx)
        (xp_old, t_old), (xp_new, t_new) = seen_old[0], seen_new[0]
        _same(xp_new, xp_old)
        _same(t_new, t_old)
        _same(got[0], want[0])
        _same(got[1], want[1])
        # the plain row ops themselves, on the same operands
        rows = row_ops.pack_weight_rows(tab)
        _same(row_ops.unipc_row_predict(x, E, rows, idx, sign), xp_old)
        e_new = _stub([])(xp_old, t_old).to(E.dtype)
        x_next, E_next = row_ops.unipc_row_correct(x, E, e_new, xp_old, rows,
                                                   idx, sign)
        _same(x_next, want[0])
        _same(E_next, want[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_row_is_an_identity_and_the_ring_rotates(dtype):
    """Row 0 (where idle slots park) gives x back bit for bit, and E_next is
    [e_new, E[:-1]], a new tensor: E is left as it was. (The plain blend
    promotes a bf16 state to fp32 under per-slot fp32 use_c columns, as the
    composed row did; the values are x's.)"""
    tab, sign = _table(2)
    x, E = _state(2, 3, dtype, seed=9)
    E_before = E.clone()
    rows = row_ops.pack_weight_rows(tab)
    for idx in (torch.tensor(0), torch.tensor([0, 0, 0]), torch.tensor(-1)):
        x_pred = row_ops.unipc_row_predict(x, E, rows, idx, sign)
        e_new = torch.randn(x.shape).to(dtype)
        x_next, E_next = row_ops.unipc_row_correct(x, E, e_new, x_pred, rows,
                                                   idx, sign)
        _same(x_pred, x)
        _same(x_next.to(dtype), x)
        _same(E_next, torch.cat([e_new[None], E[:-1]]))
        assert E_next.data_ptr() != E.data_ptr()
    _same(E, E_before)


def test_pack_weight_rows_column_layout():
    K = 3
    tab, _ = _table(K)
    n = tab["t"].shape[0]
    tab = {k: torch.arange(v.numel(), dtype=torch.float32).reshape(v.shape)
           + 1000 * i for i, (k, v) in enumerate(sorted(tab.items()))}
    rows = row_ops.pack_weight_rows(tab)
    assert rows.shape == (n, 7 + 2 * K) and rows.dtype == torch.float32
    for c, name in enumerate(row_ref.ROW_FIXED):
        _same(rows[:, c], tab[name])
    _same(rows[:, 7:7 + K], tab["w_pred"])
    _same(rows[:, 7 + K:], tab["w_corr_prev"])
    # the CUDA source reads the same columns by the same order
    src = (build.CSRC / "unipc_update.cu").read_text()
    enum = re.search(r"enum RowColumn : int \{(.*?)\};", src, re.S).group(1)
    names = [part.split("=")[0].strip() for part in enum.split(",")]
    assert names == ["C_" + k.upper() for k in row_ref.ROW_FIXED] + ["C_W"]


_CTYPE = {"void*": ctypes.c_void_p, "float*": ctypes.c_void_p,
          "long long*": ctypes.c_void_p, "long long": ctypes.c_longlong,
          "int": ctypes.c_int, "float": ctypes.c_float}


def test_binding_struct_matches_the_source():
    """kernel.RowArgs is the source's RowArgs field for field (name, type,
    order): ctypes passes it by value, so a mismatch would go unnoticed
    until the card reads the wrong bytes."""
    src = (build.CSRC / "unipc_update.cu").read_text()
    body = re.search(r"struct RowArgs \{(.*?)\};", src, re.S).group(1)
    want = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if not decl:
            continue
        m = re.match(r"(?:const )?(void\*|float\*|long long\*|long long|int|"
                     r"float) (.+)", decl)
        ctype, names = m.group(1), [n.strip() for n in m.group(2).split(",")]
        for name in names:
            arr = re.match(r"(\w+)\[MAX_TERMS\]", name)
            want.append((arr.group(1), _CTYPE[ctype] * row_kernel.MAX_TERMS)
                        if arr else (name, _CTYPE[ctype]))
    got = row_kernel.RowArgs._fields_
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, t), (_, w) in zip(got, want):
        assert ctypes.sizeof(t) == ctypes.sizeof(w) and (
            t == w or t._type_ == w._type_), n
    assert re.search(r"constexpr int MAX_TERMS = (\d+);", src).group(1) == str(
        row_kernel.MAX_TERMS)


def _plan(B, N, dtype, offset=0, ring=3):
    """kernel.plan over x, the ring and an output, each `offset` elements
    past an aligned address."""
    def buf(*shape):
        n = int(np.prod(shape))
        return torch.empty(n + offset, dtype=dtype)[offset:].view(*shape)
    x, E, out = buf(B, N), buf(ring, B, N), torch.empty(B, N, dtype=dtype)
    return row_kernel.plan([x, E, out], B, N, x)


@pytest.mark.parametrize("B,N,dtype,offset,access,per_row", [
    (8, 8192, torch.float32, 0, 16, 16),     # the main state: 2048 float4s a row
    (8, 8192, torch.bfloat16, 0, 16, 8),     # 1024 accesses of 8 a row
    (8, 8199, torch.float32, 0, 4, 16),      # rows 12 bytes off 16: elements
    (8, 8198, torch.float32, 0, 8, 16),      # rows 8-byte aligned: pairs
    (8, 8192, torch.float32, 1, 4, 16),      # every operand 4 bytes off
    (8, 8192, torch.bfloat16, 1, 2, 16),     # 2 bytes off: bf16 elements
    (2, 100, torch.float32, 0, 16, 1),       # a short row: one block
    (200, 8192, torch.float32, 0, 16, 1),    # B over the SM count: a block a row
])
def test_row_plan_by_alignment_and_size(B, N, dtype, offset, access, per_row):
    p = _plan(B, N, dtype, offset)
    assert p == dict(access_bytes=access, threads=row_kernel.ROW_THREADS,
                     blocks_per_row=per_row)
    assert B * p["blocks_per_row"] <= max(B, build.H100_SMS)


def test_scan_with_a_device_index_equals_the_int_path():
    """A 0-d index tensor and a Python int give the same bits row by row,
    and `unipc_sample_scan` (a device arange) the same bits as the composed
    row driven by ints."""
    tab, sign = _table(2)
    sched = _schedule(2)
    x_T = torch.randn(3, 4, 6, generator=torch.Generator().manual_seed(4))
    K = sched.w_pred.shape[1]
    step = unipc.step_fn_over_rows(_stub([]), tab, sign=sign)
    old = _composed_step(_stub([]), tab, sign=sign)
    carry_i = carry_t = carry_o = (x_T, torch.zeros((K + 1,) + x_T.shape))
    for j in range(tab["t"].shape[0]):
        carry_i = step(carry_i, j)
        carry_t = step(carry_t, torch.tensor(j))
        carry_o = old(carry_o, j)
        for a, b in zip(carry_i + carry_i, carry_t + carry_o):
            _same(a, b)
    _same(unipc.unipc_sample_scan(_stub([]), x_T, sched), carry_o[0])


def test_engine_build_uploads_the_table_once(monkeypatch):
    """`SamplerEngine.build` builds the step and its device table once; its
    runs only loop over the rows (and agree bit for bit)."""
    uploads = []
    rows_on = unipc.rows_on
    monkeypatch.setattr(unipc, "rows_on",
                        lambda *a, **kw: uploads.append(1) or rows_on(*a, **kw))
    eng = SamplerEngine(VPLinear(), eps=lambda x, t: 0.3 * x, device="cpu")
    run = eng.build(EngineSpec(nfe=6, order=3))
    x_T = torch.randn(2, 8, generator=torch.Generator().manual_seed(2))
    first, second = run(x_T), run(x_T)
    assert len(uploads) == 1
    _same(first, second)


# ---------------------------------------------------------------------------
# the kernel against its plain version (card only)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_operands(K, B, N, dtype, layout, device, seed):
    """x, E, e_new, x_pred on the card: contiguous, or every one a view one
    element past an aligned address ("unaligned")."""
    g = torch.Generator(device=device).manual_seed(seed)
    off = 1 if layout == "unaligned" else 0

    def buf(*shape):
        n = int(np.prod(shape))
        return torch.randn(n + off, generator=g, device=device).to(
            dtype)[off:].view(*shape)
    return buf(B, N), buf(K + 1, B, N), buf(B, N), buf(B, N)


def _card_check(got, want, dtype):
    torch.cuda.synchronize()
    got, want = got.float().cpu(), want.float().cpu()
    if dtype == torch.float32:
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    else:
        rel = (got - want).abs().max() / want.abs().max().clamp_min(1e-30)
        assert float(rel) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("N", [8192, 8192 + 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["contiguous", "unaligned"])
@pytest.mark.parametrize("kind", ["uniform", "per-slot"])
def test_card_row_ops_match_plain(cuda, N, dtype, layout, kind):
    K, B = 2, 8
    tab, sign = _table(K, cuda)
    rows = row_ops.pack_weight_rows(tab)
    x, E, e_new, x_pred = _card_operands(K, B, N, dtype, layout, cuda, 3)
    for idx in ([torch.tensor(i, device=cuda) for i in (0, 1, 5, 40)]
                if kind == "uniform" else
                [torch.tensor([0, 1, 2, 3, 5, 8, 9, 40], device=cuda)]):
        _card_check(row_ops.unipc_row_predict(x, E, rows, idx, sign),
                    row_ops.unipc_row_predict(x, E, rows, idx, sign,
                                              backend="plain"), dtype)
        got = row_ops.unipc_row_correct(x, E, e_new, x_pred, rows, idx, sign)
        want = row_ops.unipc_row_correct(x, E, e_new, x_pred, rows, idx, sign,
                                         backend="plain")
        _card_check(got[0], want[0], dtype)
        _card_check(got[1], want[1], dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 3, 5])
def test_card_row_ops_every_ring_depth_bit_equal(cuda, K):
    tab, sign = _table(K, cuda)
    rows = row_ops.pack_weight_rows(tab)
    x, E, e_new, x_pred = _card_operands(K, 4, 1000, torch.float32,
                                         "contiguous", cuda, K)
    idx = torch.tensor([0, 2, K + 1, 7], device=cuda)
    _card_check(row_ops.unipc_row_predict(x, E, rows, idx, sign),
                row_ops.unipc_row_predict(x, E, rows, idx, sign,
                                          backend="plain"), torch.float32)
    got = row_ops.unipc_row_correct(x, E, e_new, x_pred, rows, idx, sign)
    want = row_ops.unipc_row_correct(x, E, e_new, x_pred, rows, idx, sign,
                                     backend="plain")
    for a, b in zip(got, want):
        _card_check(a, b, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("per_slot", [False, True])
def test_card_weighted_combine_is_bit_equal_at_fp32(cuda, per_slot):
    g = torch.Generator(device=cuda).manual_seed(5)
    terms = torch.randn(6, 8, 8192 + 3, generator=g, device=cuda)
    w = torch.randn((6, 8) if per_slot else (6,), generator=g, device=cuda)
    _card_check(row_ops.weighted_combine(terms, w),
                row_ops.weighted_combine(terms, w, backend="plain"),
                torch.float32)


@pytest.mark.gpu
def test_card_row_ops_refuse_what_they_cannot_take(cuda):
    K, B, N = 2, 8, 8192
    tab, sign = _table(K, cuda)
    rows = row_ops.pack_weight_rows(tab)
    x, E, e_new, x_pred = _card_operands(K, B, N, torch.float32,
                                         "contiguous", cuda, 4)
    idx = torch.tensor(3, device=cuda)
    with pytest.raises(ValueError, match="ring"):        # ring of x's shape
        row_ops.unipc_row_predict(x, E[:, :4], rows, idx, sign)
    with pytest.raises(ValueError, match="rows"):        # table of another K
        row_ops.unipc_row_predict(x, E[:2], rows, idx, sign)
    with pytest.raises(ValueError, match="index"):       # a host int
        row_ops.unipc_row_predict(x, E, rows, 3, sign)
    with pytest.raises(ValueError, match="dtype"):
        row_ops.unipc_row_correct(x, E, e_new.bfloat16(), x_pred, rows, idx,
                                  sign)
    # the C entry itself: more terms than MAX_TERMS, a ring the table does
    # not describe, and an access width some pointer is not aligned to
    out = torch.empty_like(x)
    args, bits = row_kernel._row_args(x, E, rows, idx, sign, out)
    p = row_kernel._plan(bits, 4, B, N, x)
    assert p == row_kernel.plan([x, E.view(K + 1, B, N), out], B, N, x)
    row_kernel._launch(row_kernel.PREDICT, args, x, p)     # the plan launches
    for field, value in (("K", 7), ("K", 3), ("cols", 9)):
        bad, _ = row_kernel._row_args(x, E, rows, idx, sign, out)
        setattr(bad, field, value)
        with pytest.raises(RuntimeError, match="launch failed"):
            row_kernel._launch(row_kernel.PREDICT, bad, x, p)
    terms = torch.randn(9, B, N, device=cuda)
    comb = row_kernel.RowArgs(out=out.data_ptr(), weights=terms.data_ptr(),
                              N=N, rs_ring=N, K=9, B=B)
    for k in range(8):
        comb.ring[k] = terms[k].data_ptr()
    with pytest.raises(RuntimeError, match="launch failed"):
        row_kernel._launch(row_kernel.COMBINE, comb, x, p)
    xu, Eu, _, _ = _card_operands(K, B, N, torch.float32, "unaligned", cuda, 4)
    args, _ = row_kernel._row_args(xu, Eu, rows, idx, sign, out)
    with pytest.raises(RuntimeError, match="launch failed"):
        row_kernel._launch(row_kernel.PREDICT, args, x, p)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["uniform", "per-slot"])
def test_card_row_graph_replays_the_row_its_index_holds(cuda, kind):
    """predict -> stub eval -> correct captured once in a CUDA graph,
    replayed after writing new row numbers into the captured index tensor:
    bit-equal to the same row run eagerly."""
    K, B, N = 2, 8, 8192
    tab, sign = _table(K, cuda)
    rows = row_ops.pack_weight_rows(tab)
    x, E, _, _ = _card_operands(K, B, N, torch.float32, "contiguous", cuda, 6)
    idx = torch.zeros((B,) if kind == "per-slot" else (), dtype=torch.long,
                      device=cuda)

    def row():
        x_pred = row_ops.unipc_row_predict(x, E, rows, idx, sign)
        e_new = 0.5 * x_pred - 0.25
        return row_ops.unipc_row_correct(x, E, e_new, x_pred, rows, idx, sign)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        row()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = row()
    for r in (5, 1, 9, 40):
        idx.copy_(torch.arange(r, r + B) % 12 if kind == "per-slot"
                  else torch.tensor(r))
        graph.replay()
        eager = row()
        for a, b in zip(captured, eager):
            _card_check(a, b, torch.float32)
