"""The gradients of the port's kernel ops: the plain backward formulas, the
autograd Functions over the kernels, and the refusals.

On the CPU each op runs its plain PyTorch version under autograd, as the
reference's gradient is XLA's derivative of its forward. The backward
formulas written out in `ref.py` (`modulate_bwd`, `gate_residual_bwd`,
`attention_bwd`), which the backward kernels compute, are held against
`torch.autograd.grad` through the forward `ref.py`:

* fp32: <= 1e-6 relative L-inf (the same fp32 arithmetic in another order);
* bf16 inputs: both compute in fp32 and round once to bf16 at the end, and
  fp32 values a few ulps apart can round to neighbouring bf16 values: one
  bf16 ulp, 2^-7 relative L-inf (8 significant bits). Attention's Delta = rowsum(do * o)
  uses the saved bf16 output, as the kernels do, where autograd's softmax
  backward uses the unrounded one: given the unrounded output the formula
  is held to one bf16 ulp; given the bf16 output, as the kernel sees
  it, to 1e-2 relative L2 (measured 1.0e-3 to 1.4e-3).

The `gpu` tests hold each backward kernel against its plain version on the
card (1e-5 relative L-inf at fp32; 1e-2 relative L2 at bf16, where the
kernels take P and dS as bf16 hi + lo halves on the tensor cores and
round each output once; gate_residual's dy bit-equal) and pin the
grad-mode rules, and skip elsewhere.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.adaln_modulate import kernel as adaln_kernel
from repro_torch.kernels.adaln_modulate import ops as adaln_ops
from repro_torch.kernels.adaln_modulate import ref as adaln_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.quant_matmul import ops as qmm_ops
from repro_torch.kernels.quant_matmul import ref as qmm_ref
from repro_torch.kernels.unipc_update import ops as uni_ops

torch.set_num_threads(2)

FP32_TOL = 1e-6
BF16_ULP = 2.0 ** -7
BF16_O_TOL = 1e-2


def _linf(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _randn(shape, seed, dtype=torch.float32):
    """Inputs made with numpy from a seed, rounded once to `dtype`."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


# (B, T, D): the DiT's head width, a ragged width, odd T throughout
ROW_SHAPES = [(2, 7, 72), (3, 5, 100), (2, 33, 1152)]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,T,D", ROW_SHAPES)
def test_modulate_bwd_formula_matches_autograd(B, T, D, dtype):
    """dx, dshift, dscale written out against autograd through
    `ref.modulate`, shift/scale as strided views of a (B, 6D) modulation
    as the DiT passes them."""
    x = _randn((B, T, D), 0, dtype).requires_grad_()
    mod = _randn((B, 6 * D), 1, dtype).requires_grad_()
    shift, scale = mod[:, :D], mod[:, D:2 * D]
    out = adaln_ref.modulate(x, shift, scale)
    g = _randn(out.shape, 2, dtype)
    gx, gmod = torch.autograd.grad(out, (x, mod), g)
    dx, dshift, dscale = adaln_ref.modulate_bwd(g, x.detach(),
                                                scale.detach())
    assert dx.dtype == dshift.dtype == dscale.dtype == dtype
    assert dshift.shape == dscale.shape == (B, D)
    tol = FP32_TOL if dtype == torch.float32 else BF16_ULP
    for got, want in ((dx, gx), (dshift, gmod[:, :D]),
                      (dscale, gmod[:, D:2 * D])):
        assert _linf(got, want) <= tol
    assert not gmod[:, 2 * D:].any()


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,T,D", ROW_SHAPES)
def test_gate_residual_bwd_formula_matches_autograd(B, T, D, dtype):
    resid = _randn((B, T, D), 3, dtype).requires_grad_()
    y = _randn((B, T, D), 4, dtype).requires_grad_()
    mod = _randn((B, 6 * D), 5, dtype).requires_grad_()
    gate = mod[:, 2 * D:3 * D]
    out = adaln_ref.gate_residual(resid, gate, y)
    g = _randn(out.shape, 6, dtype)
    want = torch.autograd.grad(out, (resid, gate, y), g)
    got = adaln_ref.gate_residual_bwd(g, gate.detach(), y.detach())
    assert got[0] is g
    tol = FP32_TOL if dtype == torch.float32 else BF16_ULP
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _linf(a, b) <= tol


# (B, H, Sq, Skv, D): dit-i256's head dim at a ragged Sq, Sq != Skv at a
# ragged D, dit-cifar's head dim 64, D = 128
ATTN_SHAPES = [(2, 3, 67, 67, 72), (1, 2, 33, 50, 100), (2, 2, 64, 64, 64),
               (1, 2, 19, 70, 128)]


def _attn_inputs(B, H, Sq, Skv, D, dtype, seed=10):
    """q, k, v as head-major views of (B, S, H, D) projections."""
    q = _randn((B, Sq, H, D), seed, dtype).transpose(1, 2)
    k = _randn((B, Skv, H, D), seed + 1, dtype).transpose(1, 2)
    v = _randn((B, Skv, H, D), seed + 2, dtype).transpose(1, 2)
    do = _randn((B, Sq, H, D), seed + 3, dtype).transpose(1, 2)
    return q, k, v, do


@pytest.mark.parametrize("B,H,Sq,Skv,D", ATTN_SHAPES)
def test_attention_bwd_formula_matches_autograd_fp32(B, H, Sq, Skv, D):
    q, k, v, do = _attn_inputs(B, H, Sq, Skv, D, torch.float32)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o = fa_ref.attention(*leaves, causal=False)
    want = torch.autograd.grad(o, leaves, do)
    lse = fa_ref.attention_lse(q, k, causal=False)
    got = fa_ref.attention_bwd(q, k, v, o.detach(), lse, do)
    for a, b in zip(got, want):
        assert a.shape == b.shape and _linf(a, b) <= FP32_TOL


@pytest.mark.parametrize("B,H,Sq,Skv,D", ATTN_SHAPES)
def test_attention_bwd_formula_matches_autograd_bf16(B, H, Sq, Skv, D):
    q, k, v, do = _attn_inputs(B, H, Sq, Skv, D, torch.bfloat16)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(fa_ref.attention(*leaves, causal=False),
                               leaves, do)
    lse = fa_ref.attention_lse(q, k, causal=False)
    # the unrounded output: autograd's own Delta, one bf16 rounding apart
    o32 = fa_ref.attention(q.float(), k.float(), v.float(), causal=False)
    got = fa_ref.attention_bwd(q, k, v, o32, lse, do)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and _linf(a, b) <= BF16_ULP
    # the bf16 output, as the kernels see it
    o16 = fa_ref.attention(q, k, v, causal=False)
    got = fa_ref.attention_bwd(q, k, v, o16, lse, do)
    for a, b in zip(got, want):
        assert _l2(a, b) <= BF16_O_TOL


@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 5)])
def test_attention_lse_is_the_masked_logsumexp(causal, window):
    q, k, _, _ = _attn_inputs(2, 4, 21, 21, 72, torch.float32, seed=20)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(72)
    pos = torch.arange(21)
    ok = torch.ones(21, 21, dtype=torch.bool)
    if causal:
        ok &= pos[None, :] <= pos[:, None]
    if window:
        ok &= pos[None, :] > pos[:, None] - window
    want = torch.logsumexp(s.masked_fill(~ok, -1e30), dim=-1)
    got = fa_ref.attention_lse(q, k, causal=causal, window=window)
    assert _linf(got, want) <= FP32_TOL


def test_plain_path_keeps_autograd():
    """On the CPU every op is its plain version, differentiable as it is:
    the ops with a backward kernel and the two without one."""
    x = _randn((2, 5, 72), 30).requires_grad_()
    mod = _randn((2, 6 * 72), 31).requires_grad_()
    h = adaln_ops.modulate(x, mod[:, :72], mod[:, 72:144])
    h = adaln_ops.gate_residual(h, mod[:, 144:216], h)
    qkv = h.reshape(2, 5, 1, 72).transpose(1, 2)
    a = fa_ops.attention(qkv, qkv, qkv, causal=False)
    terms = torch.stack([a.reshape(2, -1), h.reshape(2, -1)])
    c = uni_ops.weighted_combine(terms, torch.tensor([0.5, 0.25]))
    qw, ws = qmm_ref.quantize(_randn((72, 8), 32))
    out = qmm_ops.quant_matmul(c.reshape(2, 5, 72), qw, ws.float())
    for t in (h, a, c, out):
        assert t.requires_grad and t.grad_fn is not None
    gx, gmod = torch.autograd.grad(out.square().sum(), (x, mod))
    assert gx.abs().sum() > 0 and gmod.abs().sum() > 0


def test_refuse_grad_only_under_grad():
    w = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        dispatch.refuse_grad("unipc_update", torch.ones(3), w)
    with torch.no_grad():
        dispatch.refuse_grad("unipc_update", w)
    dispatch.refuse_grad("unipc_update", w.detach(), 0.5, None)
    assert dispatch.needs_grad(None, w) and not dispatch.needs_grad(0.5)


@pytest.mark.parametrize("dtype,D,chunks,vec,body", [
    (torch.bfloat16, 72, 9, True, "wgmma"), (torch.bfloat16, 64, 8, True, "wgmma"),
    (torch.bfloat16, 100, 16, False, "mma"),
    (torch.float32, 72, 0, False, "cuda_cores")])
def test_attention_bwd_plan(dtype, D, chunks, vec, body):
    """bf16 with 16-byte rows takes the wgmma body (D 72 in 9 chunks, its
    contraction padded to 10), a ragged D the mma body, fp32 CUDA cores;
    the grids are the same at one q head a kv head."""
    q, k, v, do = _attn_inputs(2, 3, 130, 70, D, dtype)
    p = fa_kernel.plan_bwd(q, k, v, do)
    assert p["chunks"] == chunks and p["vec_in"] == vec
    assert p["body"] == body
    assert p["blocks"] == (2 * 3 * 3, 2 * 3 * 2)


def _heads(B, H, S, D, dtype=torch.bfloat16):
    """A head-major view of an uninitialised (B, S, H, D) projection."""
    return torch.empty(B, S, H, D, dtype=dtype).transpose(1, 2)


# (B, Hq, Hkv, Sq, Skv, D, chunks): qwen2-0.5b's AR step, granite's, the
# DiT's, zamba2's D 112, D 128, whisper's cross-attention
WGMMA_GRIDS = [(8, 14, 2, 512, 512, 64, 8), (4, 24, 8, 256, 256, 64, 8),
               (8, 16, 16, 256, 256, 72, 9), (8, 32, 32, 512, 512, 112, 14),
               (1, 2, 2, 130, 70, 128, 16), (8, 12, 12, 384, 1500, 64, 8)]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,chunks", WGMMA_GRIDS)
def test_attention_bwd_wgmma_grid(B, Hq, Hkv, Sq, Skv, D, chunks):
    """The wgmma body's grid: the dq pass a block per (b, q head, 64
    queries), the dk/dv pass a block per (b, q head, 64 keys), the group's
    q heads one cluster (qwen2: 7 a cluster, 896 blocks for 132 SMs, where
    the mma body's dk/dv pass had 128)."""
    q, do = _heads(B, Hq, Sq, D), _heads(B, Hq, Sq, D)
    k, v = _heads(B, Hkv, Skv, D), _heads(B, Hkv, Skv, D)
    o32 = torch.empty(B, Hq, Sq, D)
    p = fa_kernel.plan_bwd(q, k, v, do, o32)
    assert p["body"] == "wgmma" and p["chunks"] == chunks and p["vec_in"]
    assert p["cluster"] == Hq // Hkv
    assert p["blocks"] == (B * Hq * -(-Sq // 64), B * Hq * -(-Skv // 64))


@pytest.mark.parametrize("case", ["q off 16 bytes", "o32 off 16 bytes",
                                  "group of 16", "D 100", "D 48"])
def test_attention_bwd_misaligned_keeps_mma(case):
    """Operands the wgmma body cannot take keep the mma body: a q or o32
    row off a 16-byte boundary, a group past the cluster size, D % 8, D
    under 64 (a 64-column box a tile row)."""
    B, Hq, Hkv, S, D = 2, 4, 2, 70, 64
    if case == "group of 16":
        Hq, Hkv = 16, 1
    if case.startswith("D "):
        D = int(case[2:])
    q, do = _heads(B, Hq, S, D), _heads(B, Hq, S, D)
    k, v = _heads(B, Hkv, S, D), _heads(B, Hkv, S, D)
    o32 = torch.empty(B, Hq, S, D)
    if case == "q off 16 bytes":
        q = torch.empty(B * S * Hq * D + 1, dtype=torch.bfloat16)[1:].view(
            B, S, Hq, D).transpose(1, 2)
    if case == "o32 off 16 bytes":
        o32 = torch.empty(B * Hq * S * D + 1)[1:].view(B, Hq, S, D)
    p = fa_kernel.plan_bwd(q, k, v, do, o32)
    assert p["body"] == "mma"
    assert p["chunks"] == (16 if D == 100 else 8)
    assert p["blocks"] == (B * Hq * 2, B * Hkv * 2)


# (B, Hq, Hkv, Sq, Skv, D, body): at one query tile a group takes the mma
# body (llama-vision's diffusion LM, 64 queries over 1600, GQA 64/8), one
# head a kv head the wgmma body (whisper's, 64 over 1500), two query tiles
# of a group the wgmma body (qwen2's diffusion LM at 128)
ONE_TILE_PLANS = [(8, 64, 8, 64, 1600, 128, "mma"),
                  (8, 12, 12, 64, 1500, 64, "wgmma"),
                  (8, 14, 2, 128, 128, 64, "wgmma"),
                  (2, 4, 2, 65, 65, 64, "wgmma")]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,body", ONE_TILE_PLANS)
def test_attention_bwd_one_query_tile_plan(B, Hq, Hkv, Sq, Skv, D, body):
    """Where Sq fits one 64-query tile, the wgmma body takes no group
    past WGMMA_ONE_TILE_MAX_GROUP (each dk/dv block would do one tile of
    work before its cluster's sum); the mma body takes the group."""
    q, do = _heads(B, Hq, Sq, D), _heads(B, Hq, Sq, D)
    k, v = _heads(B, Hkv, Skv, D), _heads(B, Hkv, Skv, D)
    p = fa_kernel.plan_bwd(q, k, v, do, torch.empty(B, Hq, Sq, D))
    assert p["body"] == body
    if body == "mma":
        assert p["blocks"] == (B * Hq * -(-Sq // 64), B * Hkv * -(-Skv // 64))
    else:
        assert p["cluster"] == Hq // Hkv


def _rows_like(B, T, D, dtype):
    """x-like (B, T, D) operands and a (B, D) scale view of a (B, 6D)
    modulation, none of them allocated at full size."""
    x = torch.empty(1, 1, D, dtype=dtype).expand(B, T, D)
    return x, torch.empty(B, 6 * D, dtype=dtype)[:, D:2 * D]


# (B, T, rows, turns, tiles): rows, the tile of modulate_bwd's generic
# body, the only user of bwd_rows (about two blocks an SM, 132 on a CPU
# tensor's plan, at most 64 rows); turns and tiles, modulate_bwd's
# register body at the DiT's D 1152 bf16 (16 rows a block at once,
# `turns` rows a warp, the tiles about one block an SM)
@pytest.mark.parametrize("B,T,rows,turns,tiles", [
    (8, 256, 8, 1, 16), (1, 1, 1, 1, 1), (16, 256, 16, 2, 8),
    (64, 4096, 64, 125, 3), (2, 37, 1, 1, 3)])
def test_adaln_bwd_rows(B, T, rows, turns, tiles):
    assert adaln_kernel.bwd_rows(torch.empty(B, T, 8)) == rows
    x, scale = _rows_like(B, T, 1152, torch.bfloat16)
    p = adaln_kernel.plan_bwd(x, x, scale, x)
    assert (p["body"], p["lanes"], p["chunks"]) == ("registers", 32, 5)
    assert p["rows_per_group"] == turns and p["tiles"] == tiles
    assert p["blocks"] == B * tiles and p["tile_rows"] == 16 * turns


@pytest.mark.parametrize("D,dtype,body,lanes,chunks", [
    (1152, torch.float32, "registers", 32, 9),
    (384, torch.bfloat16, "registers", 16, 3),
    (72, torch.float32, "registers", 16, 2),
    (100, torch.bfloat16, "generic", 32, 0),
    (8192, torch.bfloat16, "generic", 32, 0)])
def test_adaln_bwd_plan_bodies(D, dtype, body, lanes, chunks):
    """modulate_bwd reads each row once where the forward has a register
    body (the path's widths); other widths walk the row from memory."""
    x, scale = _rows_like(2, 33, D, dtype)
    p = adaln_kernel.plan_bwd(x, x, scale, x)
    assert (p["body"], p["lanes"], p["chunks"]) == (body, lanes, chunks)
    if body == "generic":
        assert p["tile_rows"] == adaln_kernel.bwd_rows(x)


def _gate_bwd_operands(B, T, D, dtype, layout):
    """(g, gate, y) of gate_residual_bwd: contiguous g and y, the gate the
    third D columns of a (B, 6D) modulation as the DiT passes it; "view":
    y starting one element past an aligned address."""
    n = B * T * D
    y = torch.zeros(n + 1, dtype=dtype)
    y = y[1:].view(B, T, D) if layout == "view" else y[:n].view(B, T, D)
    gate = torch.zeros(B, 6 * D, dtype=dtype)[:, 2 * D:3 * D]
    return torch.zeros(B, T, D, dtype=dtype), gate, y


# (B, T, D, dtype, layout, access bytes, cols, groups, rows a thread,
# tiles, blocks): gate_residual_bwd's plan on a CPU tensor (132 SMs) at
# the DiT's training shape in bf16 and fp32 (two strips of 144 chunks),
# serving batch 16, a ragged T, D 100 in both dtypes (8-byte accesses in
# bf16: 200-byte rows) and y a view 2 bytes off (2-byte accesses)
@pytest.mark.parametrize(
    "B,T,D,dtype,layout,access,cols,groups,rows,tiles,blocks", [
        (8, 256, 1152, torch.bfloat16, "dit", 16, 144, 2, 4, 32, 256),
        (8, 256, 1152, torch.float32, "dit", 16, 144, 2, 8, 16, 256),
        (16, 256, 1152, torch.bfloat16, "dit", 16, 144, 2, 8, 16, 256),
        (2, 37, 1152, torch.bfloat16, "dit", 16, 144, 2, 4, 5, 10),
        (2, 33, 100, torch.bfloat16, "dit", 8, 25, 10, 4, 1, 2),
        (3, 37, 100, torch.float32, "dit", 16, 25, 10, 4, 1, 3),
        (8, 256, 1152, torch.bfloat16, "view", 2, 231, 1, 40, 7, 280)])
def test_gate_bwd_plan(B, T, D, dtype, layout, access, cols, groups, rows,
                       tiles, blocks):
    """plan_gate_bwd: the access width every operand allows, a thread a
    chunk of a row over `rows` rows (a multiple of the unroll), the tiles
    covering T, the strips covering D, and blocks the source takes."""
    g, gate, y = _gate_bwd_operands(B, T, D, dtype, layout)
    p = adaln_kernel.plan_gate_bwd(g, gate, y, g)
    assert (p["access_bytes"], p["cols"], p["groups"]) == (access, cols,
                                                           groups)
    assert (p["rows_per_thread"], p["tiles"], p["blocks"]) == (rows, tiles,
                                                               blocks)
    nvec = D * y.element_size() // access
    assert p["strips"] * p["cols"] >= nvec > (p["strips"] - 1) * p["cols"]
    assert p["tile_rows"] == p["groups"] * rows
    assert p["tiles"] * p["tile_rows"] >= T > (p["tiles"] - 1) * p["tile_rows"]
    assert rows % adaln_kernel.GATE_BWD_UNROLL == 0
    assert p["threads"] == cols * groups <= 512
    assert p["blocks"] == B * p["strips"] * p["tiles"]


@pytest.mark.parametrize("B,T,D,dtype", [(2, 37, 72, torch.bfloat16),
                                         (3, 37, 100, torch.float32),
                                         (2, 33, 1152, torch.bfloat16),
                                         (8, 256, 1152, torch.float32)])
def test_gate_bwd_order_of_sums_matches_plain(B, T, D, dtype):
    """gate_residual_bwd's dgate summed in the kernel's order on its plan,
    in fp32: each group's rows in order, the block's groups in order, b's
    tiles in order, rounded once. Every row counts once (the tiles cover
    T), and the result is the plain version's up to the order of fp32
    sums: 1e-5 relative L-inf at fp32, one bf16 ulp at bf16."""
    g, y = (_randn((B, T, D), s, dtype) for s in (90, 91))
    gate = _randn((B, 6 * D), 92, dtype)[:, 2 * D:3 * D]
    p = adaln_kernel.plan_gate_bwd(g, gate, y, g)
    prod = (g.float() * y.float()).numpy()
    rows = p["rows_per_thread"]
    dgate = np.zeros((B, D), np.float32)
    for b in range(B):
        for tile in range(p["tiles"]):
            part = np.zeros(D, np.float32)
            for grp in range(p["groups"]):
                acc = np.zeros(D, np.float32)
                t0 = (tile * p["groups"] + grp) * rows
                for t in range(t0, min(t0 + rows, T)):
                    acc += prod[b, t]
                part += acc
            dgate[b] += part
    want = adaln_ref.gate_residual_bwd(g, gate, y)[1]
    got = torch.from_numpy(dgate).to(dtype)
    tol = FP32_TOL * 10 if dtype == torch.float32 else BF16_ULP
    assert _linf(got, want) <= tol


# ---------------------------------------------------------------------------
# the backward kernels against their plain versions (card only)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_tol(dtype):
    return 1e-5 if dtype == torch.float32 else 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,T,D", ROW_SHAPES + [(8, 256, 1152), (2, 3, 8192)])
def test_card_adaln_bwd_kernels_match_plain(cuda, B, T, D, dtype):
    x, y, g = (_randn((B, T, D), s, dtype).to(cuda) for s in (40, 41, 42))
    mod = _randn((B, 6 * D), 43, dtype).to(cuda)
    scale, gate = mod[:, D:2 * D], mod[:, 2 * D:3 * D]
    gate_got = adaln_kernel.gate_residual_bwd(g, gate, y)
    gate_want = adaln_ref.gate_residual_bwd(g, gate, y)
    for got, want in ((adaln_kernel.modulate_bwd(g, x, scale),
                       adaln_ref.modulate_bwd(g, x, scale)),
                      (gate_got, gate_want)):
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == b.dtype
            tol = _card_tol(dtype)
            assert (_linf(a, b) if dtype == torch.float32
                    else _l2(a, b)) <= tol
    assert torch.equal(gate_got[2], gate_want[2])     # dy = gate * g
    again = adaln_kernel.modulate_bwd(g, x, scale)
    assert all(torch.equal(a, b) for a, b in
               zip(again, adaln_kernel.modulate_bwd(g, x, scale)))
    assert all(torch.equal(a, b) for a, b in
               zip(gate_got, adaln_kernel.gate_residual_bwd(g, gate, y)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,T,D,where", [(8, 256, 1152, "y"),
                                         (8, 256, 1152, "gate"),
                                         (3, 37, 100, "y"),
                                         (2, 5, 1003, "gate")])
def test_card_gate_bwd_misaligned_views(cuda, B, T, D, dtype, where):
    """gate_residual_bwd where y starts one element past an aligned
    address, or the gate is a (B, D + 1) row's columns 1..D: the narrower
    accesses plan_gate_bwd picks give dy bit-equal to plain, dgate within
    the card tolerance, and the same bits twice."""
    g = _randn((B, T, D), 80, dtype).to(cuda)
    y = _randn((B * T * D + 1,), 81, dtype).to(cuda)
    y = y[1:].view(B, T, D) if where == "y" else y[:-1].view(B, T, D)
    gate = _randn((B, D + 1), 82, dtype).to(cuda)
    gate = gate[:, 1:] if where == "gate" else gate[:, :D]
    p = adaln_kernel.plan_gate_bwd(g, gate, y, g)
    assert p["access_bytes"] == g.element_size()
    got = adaln_kernel.gate_residual_bwd(g, gate, y)
    want = adaln_ref.gate_residual_bwd(g, gate, y)
    assert torch.equal(got[2], want[2])
    assert (_linf(got[1], want[1]) if dtype == torch.float32
            else _l2(got[1], want[1])) <= _card_tol(dtype)
    assert all(torch.equal(a, b) for a, b in
               zip(got, adaln_kernel.gate_residual_bwd(g, gate, y)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,H,Sq,Skv,D", ATTN_SHAPES + [(8, 16, 256, 256, 72)])
def test_card_attention_bwd_matches_plain(cuda, B, H, Sq, Skv, D, dtype):
    q, k, v, do = (t.to(cuda) for t in _attn_inputs(B, H, Sq, Skv, D, dtype))
    out0 = fa_kernel.flash_attention(q, k, v, causal=False)
    out, lse, o32 = fa_kernel.flash_attention(q, k, v, causal=False,
                                              lse=True)
    assert torch.equal(out, out0) and torch.equal(o32.to(dtype), out)
    assert _linf(lse, fa_ref.attention_lse(q, k, causal=False)) <= 1e-5
    got = fa_kernel.flash_attention_bwd(q, k, v, o32, lse, do)
    want = fa_ref.attention_bwd(q, k, v, o32, lse, do)
    for a, b, src in zip(got, want, (q, k, v)):
        assert a.stride() == src.stride()
        assert (_linf(a, b) if dtype == torch.float32
                else _l2(a, b)) <= _card_tol(dtype)
    again = fa_kernel.flash_attention_bwd(q, k, v, o32, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# (B, Hq, Hkv, Sq, Skv, D, causal, window) for the wgmma body on the card:
# causal GQA (groups 7 and 3, ragged S), windows (one with queries whose
# every key is masked), cross-attention (Sq != Skv, a group of 8 at D 128),
# zamba2's D 112, the DiT's D 72
WGMMA_CASES = [(2, 14, 2, 130, 130, 64, True, None),
               (2, 24, 8, 70, 70, 64, True, None),
               (2, 14, 2, 150, 150, 64, True, 32),
               (1, 4, 4, 200, 40, 64, True, 16),
               (2, 12, 12, 96, 300, 64, False, None),
               (1, 16, 2, 70, 90, 128, False, None),
               (2, 8, 8, 100, 100, 112, True, None),
               (2, 4, 4, 67, 67, 72, False, None)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,window", WGMMA_CASES)
def test_card_attention_bwd_wgmma_masks_and_groups(cuda, B, Hq, Hkv, Sq, Skv,
                                                   D, causal, window):
    """The wgmma body within 1e-2 relative L2 of the plain backward, and
    bit-equal run to run (the group's sum in a fixed order)."""
    q = _randn((B, Sq, Hq, D), 60, torch.bfloat16).to(cuda).transpose(1, 2)
    do = _randn((B, Sq, Hq, D), 61, torch.bfloat16).to(cuda).transpose(1, 2)
    k = _randn((B, Skv, Hkv, D), 62, torch.bfloat16).to(cuda).transpose(1, 2)
    v = _randn((B, Skv, Hkv, D), 63, torch.bfloat16).to(cuda).transpose(1, 2)
    kw = dict(causal=causal, window=window)
    _, lse, o32 = fa_kernel.flash_attention(q, k, v, lse=True, **kw)
    assert fa_kernel.plan_bwd(q, k, v, do, o32)["body"] == "wgmma"
    got = fa_kernel.flash_attention_bwd(q, k, v, o32, lse, do, **kw)
    again = fa_kernel.flash_attention_bwd(q, k, v, o32, lse, do, **kw)
    want = fa_ref.attention_bwd(q, k, v, o32, lse, do, **kw)
    for a, b, src in zip(got, want, (q, k, v)):
        assert a.stride() == src.stride() and torch.isfinite(a.float()).all()
        assert _l2(a, b) <= _card_tol(torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,T,D", [(3, 37, 1152), (2, 5, 384), (5, 129, 1152),
                                   (4, 3, 72)])
def test_card_modulate_bwd_ragged_t(cuda, B, T, D, dtype):
    """The register body at ragged T (rows past T add nothing to the
    sums) against the plain version, and bit-equal run to run."""
    x, g = (_randn((B, T, D), s, dtype).to(cuda) for s in (70, 71))
    scale = _randn((B, 6 * D), 72, dtype).to(cuda)[:, D:2 * D]
    p = adaln_kernel.plan_bwd(g, x, scale, torch.empty_like(x))
    assert p["body"] == "registers"
    got = adaln_kernel.modulate_bwd(g, x, scale)
    again = adaln_kernel.modulate_bwd(g, x, scale)
    want = adaln_ref.modulate_bwd(g, x, scale)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert (_linf(a, b) if dtype == torch.float32
                else _l2(a, b)) <= _card_tol(dtype)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
def test_card_functions_carry_grad_and_count(cuda):
    """Under grad each op's output requires grad and its backward launches
    the backward kernel; under no_grad the forward kernel alone runs."""
    x = _randn((2, 37, 72), 50, torch.bfloat16).to(cuda).requires_grad_()
    mod = _randn((2, 6 * 72), 51, torch.bfloat16).to(cuda).requires_grad_()
    dispatch.LAUNCHES.clear()
    h = adaln_ops.modulate(x, mod[:, :72], mod[:, 72:144])
    qkv = h.reshape(2, 37, 1, 72).transpose(1, 2)
    a = fa_ops.attention(qkv, qkv, qkv, causal=False)
    out = adaln_ops.gate_residual(h, mod[:, 144:216],
                                  a.transpose(1, 2).reshape(2, 37, 72))
    assert h.requires_grad and a.requires_grad and out.requires_grad
    out.float().square().sum().backward()
    assert x.grad is not None and mod.grad is not None
    assert dict(dispatch.LAUNCHES) == {
        "adaln_modulate": 1, "gate_residual": 1, "flash_attention": 1,
        "adaln_modulate_bwd": 1, "gate_residual_bwd": 1,
        "flash_attention_bwd": 1}
    dispatch.LAUNCHES.clear()
    with torch.no_grad():
        h = adaln_ops.modulate(x, mod[:, :72], mod[:, 72:144])
    assert not h.requires_grad and dict(dispatch.LAUNCHES) == {
        "adaln_modulate": 1}


@pytest.mark.gpu
def test_card_refusals_under_grad(cuda):
    """No detached results: the kernels without a backward raise under
    grad (attention has one for every mask and group size)."""
    w = torch.tensor([0.5, 0.5], device=cuda)
    terms = torch.randn(2, 2, 64, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        uni_ops.weighted_combine(terms, w)
    with torch.no_grad():
        uni_ops.weighted_combine(terms, w)
    qw, ws = qmm_ref.quantize(torch.randn(64, 32, device=cuda))
    x = torch.randn(4, 64, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        qmm_ops.quant_matmul(x, qw, ws.float())
