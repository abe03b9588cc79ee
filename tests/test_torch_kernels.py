"""The port's kernel ops against the JAX reference's, on the same inputs.

On the CPU every op runs its plain PyTorch version (the CUDA kernels run
only on the card); here each is held against the reference's Pallas
kernel in interpret mode and its jnp oracle. Tolerances: fp32 <= 1e-5
relative L-inf (sums in another order), bf16 <= 1e-2 (one bf16 rounding of
the same fp32 value can land on either side). The `gpu` tests hold each
CUDA kernel against its plain version on the card and skip elsewhere.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.adaln_modulate import ops as j_adaln
from repro.kernels.flash_attention import ops as j_fa
from repro.kernels.unipc_update import ops as j_uni
from repro_torch.kernels.adaln_modulate import kernel as adaln_kernel
from repro_torch.kernels.adaln_modulate import ops as t_adaln
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as t_fa
from repro_torch.kernels.unipc_update import ops as t_uni

torch.set_num_threads(2)

TOL = {np.float32: 1e-5, "bfloat16": 1e-2}


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _rng(seed):
    return np.random.default_rng(seed)


def _pair(x: np.ndarray, bf16: bool = False):
    """The same values as a jnp array and a torch tensor (bf16 rounded once
    on the numpy side of both)."""
    if bf16:
        j = jnp.asarray(x, jnp.bfloat16)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
            torch.bfloat16)
    return jnp.asarray(x), torch.as_tensor(x)


def _np(t: torch.Tensor):
    return t.to(torch.float32).numpy()


# ---------------------------------------------------------------------------
# B1 unipc_update
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jbackend", ["interpret", "jnp"])
@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("shape,bf16", [
    ((3, 256, 32), False),       # main-path layout (B, T, latent)
    ((2, 1000), False),          # ragged N, not a tile multiple
    ((3, 37, 5), True),          # bf16 terms, ragged
])
def test_weighted_combine_matches_reference(jbackend, per_slot, shape, bf16):
    rng = _rng(0)
    K = 5
    terms = rng.normal(size=(K,) + shape).astype(np.float32)
    w = rng.normal(size=(K, shape[0]) if per_slot else (K,)).astype(np.float32)
    jt, tt = _pair(terms, bf16)
    want = j_uni.weighted_combine(jt, jnp.asarray(w), backend=jbackend)
    got = t_uni.weighted_combine(tt, torch.as_tensor(w))
    assert got.dtype == tt.dtype and tuple(got.shape) == shape
    tol = TOL["bfloat16" if bf16 else np.float32]
    assert _rel(_np(got), np.asarray(want.astype(jnp.float32))) <= tol


def test_weighted_combine_rejects_mismatched_per_slot_weights():
    with pytest.raises(ValueError, match="per-slot"):
        t_uni.weighted_combine(torch.zeros(3, 4, 8), torch.zeros(3, 5))


# ---------------------------------------------------------------------------
# B2/B3 adaln_modulate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D,T", [(1152, 5), (72, 37)])
@pytest.mark.parametrize("bf16", [False, True])
def test_modulate_and_gate_residual_match_reference(D, T, bf16):
    rng = _rng(1)
    B = 2
    x, y = (rng.normal(size=(B, T, D)).astype(np.float32) for _ in range(2))
    sh, sc, g = (0.5 * rng.normal(size=(B, D)).astype(np.float32)
                 for _ in range(3))
    (jx, tx), (jy, ty) = _pair(x, bf16), _pair(y, bf16)
    (jsh, tsh), (jsc, tsc), (jg, tg) = (_pair(a, bf16) for a in (sh, sc, g))
    tol = TOL["bfloat16" if bf16 else np.float32]

    want = j_adaln.modulate(jx, jsh, jsc, backend="interpret")
    got = t_adaln.modulate(tx, tsh, tsc)
    assert got.dtype == tx.dtype
    assert _rel(_np(got), np.asarray(want.astype(jnp.float32))) <= tol

    want = j_adaln.gate_residual(jx, jg, jy, backend="interpret")
    got = t_adaln.gate_residual(tx, tg, ty)
    assert _rel(_np(got), np.asarray(want.astype(jnp.float32))) <= tol


def test_modulate_takes_strided_conditioning_rows():
    """The DiT passes chunks of its (B, 6D) modulation vector in place."""
    rng = _rng(2)
    x = torch.as_tensor(rng.normal(size=(2, 9, 16)).astype(np.float32))
    mod = torch.as_tensor(rng.normal(size=(2, 6 * 16)).astype(np.float32))
    sh, sc = mod[:, :16], mod[:, 16:32]
    np.testing.assert_array_equal(
        t_adaln.modulate(x, sh, sc).numpy(),
        t_adaln.modulate(x, sh.contiguous(), sc.contiguous()).numpy())


# ---------------------------------------------------------------------------
# B4 flash_attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jbackend", ["interpret", "jnp"])
@pytest.mark.parametrize("S", [64, 100])
@pytest.mark.parametrize("Hq,Hkv,D", [(4, 2, 32), (2, 2, 72)])
def test_attention_matches_reference(jbackend, S, Hq, Hkv, D):
    rng = _rng(3)
    B = 2
    q = rng.normal(size=(B, Hq, S, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
            for _ in range(2))
    want = j_fa.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=False, backend=jbackend)
    got = t_fa.attention(torch.as_tensor(q), torch.as_tensor(k),
                         torch.as_tensor(v), causal=False)
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-5


def test_attention_head_major_views_of_seq_major_projections():
    """The model hands the op (B, H, S, D) views of (B, S, H, D) tensors."""
    rng = _rng(4)
    q, k, v = (torch.as_tensor(rng.normal(size=(2, 50, 4, 72)).astype(
        np.float32)) for _ in range(3))
    views = [a.transpose(1, 2) for a in (q, k, v)]
    dense = [a.contiguous() for a in views]
    np.testing.assert_allclose(
        t_fa.attention(*views, causal=False).numpy(),
        t_fa.attention(*dense, causal=False).numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("Sq,Skv,causal,window", [
    (64, 64, True, None), (40, 100, False, None), (90, 90, True, 16)])
def test_plain_attention_rounding_p_as_the_bf16_kernel(Sq, Skv, causal,
                                                       window):
    """round_p=True rounds P = exp(s - rowmax) to bf16 before P.V and sums
    the denominator from the fp32 P: at most bf16's half-ulp (2^-8
    relative) of each P away from plain, so |o - plain| <= 2^-8 max|v|
    (plus fp32 rounding); off by default, and then plain bit for bit."""
    from repro_torch.kernels.flash_attention import ref as fa_ref

    rng = _rng(5)
    q = torch.as_tensor(rng.normal(size=(2, 4, Sq, 32)).astype(np.float32))
    k, v = (torch.as_tensor(rng.normal(size=(2, 2, Skv, 32)).astype(
        np.float32)) for _ in range(2))
    kw = dict(causal=causal, window=window)
    plain = fa_ref.attention(q, k, v, **kw)
    assert torch.equal(fa_ref.attention(q, k, v, round_p=False, **kw), plain)
    assert torch.equal(t_fa.attention(q, k, v, **kw), plain)
    rounded = fa_ref.attention(q, k, v, round_p=True, **kw)
    diff = (rounded - plain).abs().max().item()
    assert 0 < diff <= 2.0 ** -8 * v.abs().max().item() + 1e-6
    # by hand: the same rounding written out for one (b, h, query) row
    s = (q[0, 1, 7] @ k[0, 0].T) / math.sqrt(32)
    ok = fa_ref._visible(Sq, Skv, causal, window, "cpu")[7]
    s = torch.where(ok, s, torch.tensor(-1e30))
    p = torch.exp(s - s.max())
    want = (p.to(torch.bfloat16).float() @ v[0, 0]) / p.sum()
    torch.testing.assert_close(rounded[0, 1, 7], want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (card only)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_pair(fn, *args, **kw):
    got = fn(*args, **kw)
    want = fn(*args, backend="plain", **kw)
    torch.cuda.synchronize()
    return got.float().cpu(), want.float().cpu()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_unipc_update_matches_plain(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    terms = torch.randn(5, 8, 8192 + 7, generator=g, device=cuda).to(dtype)
    for w in (torch.randn(5, generator=g, device=cuda),
              torch.randn(5, 8, generator=g, device=cuda)):
        got, want = _card_pair(t_uni.weighted_combine, terms, w)
        assert _rel(got, want) <= TOL["bfloat16" if dtype == torch.bfloat16
                                      else np.float32]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_adaln_matches_plain(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    x, y = (torch.randn(4, 37, 1152, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    mod = torch.randn(4, 6 * 1152, generator=g, device=cuda).to(dtype)
    tol = TOL["bfloat16" if dtype == torch.bfloat16 else np.float32]
    got, want = _card_pair(t_adaln.modulate, x, mod[:, :1152],
                           mod[:, 1152:2304])
    assert _rel(got, want) <= tol
    got, want = _card_pair(t_adaln.gate_residual, x, mod[:, 2304:3456], y)
    assert _rel(got, want) <= tol


def _modulate_operands(B, T, D, dtype, layout, device, seed):
    """x (B, T, D) and shift/scale views of a conditioning tensor: "dit"
    the block's (B, 6D) modulation, "head" the final layer's (B, 2D),
    "unaligned" mod[:, 1:D+1] and [:, D+1:2D+1] of a (B, 2D+1) tensor."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(B, T, D, generator=g, device=device).to(dtype)
    width, off = {"dit": (6 * D, 0), "head": (2 * D, 0),
                  "unaligned": (2 * D + 1, 1)}[layout]
    mod = torch.randn(B, width, generator=g, device=device).to(dtype)
    return x, mod[:, off:off + D], mod[:, off + D:off + 2 * D]


# the phase-3 cases of chip_smoke.py at test size: (B, T, D, dtype, layout)
MODULATE_EDGES = [
    (2, 37, 1152, torch.float32, "dit"),       # phase 5's fp32 width
    (4, 64, 384, torch.bfloat16, "dit"),       # dit-cifar
    (2, 37, 128, torch.float32, "dit"),        # reduced
    (2, 37, 72, torch.bfloat16, "dit"),
    (2, 37, 1004, torch.bfloat16, "dit"),      # rows no 16-byte multiple
    (2, 5, 8192, torch.bfloat16, "dit"),       # MAX_D
    (4, 37, 1152, torch.bfloat16, "head"),
    (4, 37, 1152, torch.bfloat16, "unaligned"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,D,dtype,layout", MODULATE_EDGES)
def test_card_modulate_edges_match_plain(cuda, B, T, D, dtype, layout):
    """Each body plan() picks, against the plain version on the card."""
    x, sh, sc = _modulate_operands(B, T, D, dtype, layout, cuda, 7)
    got, want = _card_pair(t_adaln.modulate, x, sh, sc)
    assert _rel(got, want) <= TOL["bfloat16" if dtype == torch.bfloat16
                                  else np.float32]


@pytest.mark.gpu
def test_card_modulate_refuses_what_it_cannot_take(cuda):
    x, sh, sc = _modulate_operands(2, 3, 1152, torch.bfloat16, "dit", cuda, 8)
    with pytest.raises(ValueError, match="D <="):
        t_adaln.modulate(torch.zeros(1, 2, 8200, device=cuda), *(
            torch.zeros(1, 8200, device=cuda),) * 2)
    out = torch.empty_like(x)
    p = adaln_kernel.plan(x, sh, sc, out)
    with pytest.raises(RuntimeError, match="launch failed"):   # chunks wrong
        adaln_kernel._launch_modulate(x, sh, sc, out, 1e-5,
                                      dict(p, chunks=p["chunks"] + 1))
    xu, shu, scu = _modulate_operands(2, 3, 1152, torch.bfloat16,
                                      "unaligned", cuda, 8)
    with pytest.raises(RuntimeError, match="launch failed"):   # misaligned
        adaln_kernel._launch_modulate(xu, shu, scu, out, 1e-5, p)


def _gate_operands(B, T, D, dtype, layout, device, seed):
    """resid, gate, y: resid and y (B, T, D) contiguous, the gate a (B, D)
    view of a conditioning tensor. "dit": mod[:, 2D:3D] of the block's
    (B, 6D) modulation; "unaligned": mod[:, 1:D+1] of a (B, D+1) tensor;
    "rows": as "dit", with resid and y starting one element past an
    aligned address (contiguous views at offset 1)."""
    g = torch.Generator(device=device).manual_seed(seed)
    off = 1 if layout == "rows" else 0
    resid, y = (torch.randn(B * T * D + off, generator=g, device=device).to(
        dtype)[off:].view(B, T, D) for _ in range(2))
    width, col = (D + 1, 1) if layout == "unaligned" else (6 * D, 2 * D)
    mod = torch.randn(B, width, generator=g, device=device).to(dtype)
    return resid, mod[:, col:col + D], y


# (B, T, D, dtype, layout): each body plan_gate() picks
GATE_EDGES = [
    (16, 256, 1152, torch.bfloat16, "dit"),    # the main path
    (2, 37, 1152, torch.float32, "dit"),       # phase 5's fp32 width
    (4, 64, 384, torch.bfloat16, "dit"),       # dit-cifar
    (2, 37, 128, torch.float32, "dit"),        # reduced
    (2, 37, 72, torch.bfloat16, "dit"),
    (2, 37, 72, torch.float32, "dit"),
    (2, 37, 1004, torch.bfloat16, "dit"),      # rows no 16-byte multiple
    (2, 5, 8192, torch.bfloat16, "dit"),       # MAX_D
    (4, 37, 1152, torch.bfloat16, "unaligned"),
    (4, 37, 1003, torch.float32, "unaligned"),
    (4, 37, 1152, torch.bfloat16, "rows"),
    (4, 37, 1152, torch.float32, "rows"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,D,dtype,layout", GATE_EDGES)
def test_card_gate_residual_edges_match_plain(cuda, B, T, D, dtype, layout):
    resid, gate, y = _gate_operands(B, T, D, dtype, layout, cuda, 12)
    got, want = _card_pair(t_adaln.gate_residual, resid, gate, y)
    assert _rel(got, want) <= TOL["bfloat16" if dtype == torch.bfloat16
                                  else np.float32]


@pytest.mark.gpu
def test_card_gate_residual_refuses_what_it_cannot_take(cuda):
    resid, gate, y = _gate_operands(2, 3, 1152, torch.bfloat16, "dit", cuda,
                                    13)
    out = torch.empty_like(resid)
    p = adaln_kernel.plan_gate(resid, gate, y, out)
    adaln_kernel._launch_gate(resid, gate, y, out, p)   # the plan launches
    for bad in (dict(p, chunks=p["chunks"] + 1), dict(p, lanes=12),
                dict(p, access_bytes=32), dict(p, rows_per_block=16)):
        with pytest.raises(RuntimeError, match="launch failed"):
            adaln_kernel._launch_gate(resid, gate, y, out, bad)
    for layout in ("unaligned", "rows"):                 # misaligned
        ru, gu, yu = _gate_operands(2, 3, 1152, torch.bfloat16, layout,
                                    cuda, 13)
        with pytest.raises(RuntimeError, match="launch failed"):
            adaln_kernel._launch_gate(ru, gu, yu, out, p)
    with pytest.raises(ValueError, match="D <="):
        t_adaln.gate_residual(torch.zeros(1, 2, 8200, device=cuda),
                              torch.zeros(1, 8200, device=cuda),
                              torch.zeros(1, 2, 8200, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,D,S", [(16, 16, 72, 256), (4, 2, 32, 100)])
def test_card_attention_matches_plain(cuda, dtype, Hq, Hkv, D, S):
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(2, Hq, S, D, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(2, Hkv, S, D, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    got, want = _card_pair(t_fa.attention, q, k, v, causal=False)
    assert _rel(got, want) <= TOL["bfloat16" if dtype == torch.bfloat16
                                  else np.float32]


@pytest.mark.gpu
@pytest.mark.parametrize("label,Hq,Hkv,Sq,Skv,D,causal,window", [
    ("ragged S=200", 4, 4, 200, 200, 72, False, None),
    ("ragged S=257", 4, 4, 257, 257, 72, False, None),
    ("D=64 GQA causal", 4, 2, 300, 300, 64, True, None),
    ("D=64 GQA window 40", 4, 2, 300, 300, 64, False, 40),
    ("D=72 GQA causal", 4, 2, 300, 300, 72, True, None),
    ("D=72 GQA causal window 40", 4, 2, 300, 300, 72, True, 40),
    ("Skv off the key tile", 4, 4, 100, 150, 72, False, None),
    ("queries with no unmasked key", 2, 2, 300, 100, 64, False, 30),
    ("D=36, 2-byte loads", 4, 2, 100, 100, 36, True, None),
    ("D=128", 2, 2, 130, 130, 128, True, None),
])
def test_card_attention_edges_match_plain(cuda, label, Hq, Hkv, Sq, Skv, D,
                                          causal, window):
    """The bf16 mma body at ragged lengths, masks, GQA and head dims."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(2, Hq, Sq, D, generator=g, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn(2, Hkv, Skv, D, generator=g, device=cuda).to(
        torch.bfloat16) for _ in range(2))
    got, want = _card_pair(t_fa.attention, q, k, v, causal=causal,
                           window=window)
    assert fa_kernel.plan(q, k, v, q)["body"] == "mma"
    assert _rel(got, want) <= TOL["bfloat16"]


@pytest.mark.gpu
def test_card_attention_main_shape_views_and_contiguous(cuda):
    """The main path's head-major views of (B, S, H, D) projections and the
    same values contiguous give the same output."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn(16, 256, 16, 72, generator=g, device=cuda).to(
        torch.bfloat16).transpose(1, 2) for _ in range(3))
    got, want = _card_pair(t_fa.attention, q, k, v, causal=False)
    assert _rel(got, want) <= TOL["bfloat16"]
    dense = t_fa.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=False)
    torch.testing.assert_close(dense.float().cpu(), got, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", [
    (16, 16, 16, 256, 256, 72, False),   # the DiT's
    (8, 14, 2, 512, 512, 64, True),      # qwen2-0.5b's prefill, GQA 14/2
    (2, 4, 4, 100, 150, 72, False)])     # ragged, Sq != Skv
def test_card_attention_pv_keeps_p_at_fp32_precision(cuda, B, Hq, Hkv, Sq,
                                                     Skv, D, causal):
    """The bf16 kernel's P V takes P as bf16 hi + lo halves, so its fp32
    output copy sits at most 1/8 as far (relative L-inf) from the fp32-P
    plain output as the variant that rounds P once to bf16 does (the TPU
    kernel computes p @ v with fp32 p)."""
    from repro_torch.kernels.flash_attention import ref as fa_ref

    g = torch.Generator(device=cuda).manual_seed(9)
    q = torch.randn(B, Sq, Hq, D, generator=g, device=cuda).to(
        torch.bfloat16).transpose(1, 2)
    k, v = (torch.randn(B, Skv, Hkv, D, generator=g, device=cuda).to(
        torch.bfloat16).transpose(1, 2) for _ in range(2))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        o32 = fa_kernel.flash_attention(q, k, v, causal=causal, lse=True)[2]
        exact = fa_ref.attention32(q, k, v, causal=causal)
        rounded = fa_ref.attention32(q, k, v, causal=causal, round_p=True)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    exact = exact.double().cpu().numpy()
    assert _rel(o32.double().cpu().numpy(), exact) <= _rel(
        rounded.double().cpu().numpy(), exact) / 8


# ---------------------------------------------------------------------------
# the bodies the wrappers choose (host side, so testable on the CPU)
# ---------------------------------------------------------------------------


def _heads(B, H, S, D, dtype=torch.bfloat16):
    return torch.zeros(B, H, S, D, dtype=dtype)


@pytest.mark.parametrize("D,chunks", [(8, 4), (32, 4), (36, 8), (64, 8),
                                      (72, 9), (80, 16), (128, 16)])
def test_attention_plan_compiles_head_dim_in_chunks(D, chunks):
    q = _heads(2, 4, 100, D)
    p = fa_kernel.plan(q, q, q, q)
    assert p["body"] == "mma" and p["chunks"] == chunks
    assert p["vec_in"] == p["vec_out"] == (D % 8 == 0)
    assert p["blocks"] == 2 * 4 * 1          # one 128-query tile per head


def test_attention_plan_main_path_shape():
    """dit-i256: head-major views of (16, 256, 16, 72) projections ->
    16-byte rows, 9 chunks, 512 blocks of 128 queries."""
    q = torch.zeros(16, 256, 16, 72, dtype=torch.bfloat16).transpose(1, 2)
    assert fa_kernel.plan(q, q, q, torch.empty_like(q)) == dict(
        body="mma", chunks=9, vec_in=True, vec_out=True, blocks=512)


def test_attention_plan_unaligned_rows_and_fp32():
    wide = torch.zeros(2, 4, 100, 80, dtype=torch.bfloat16)
    q = wide[..., 1:73]                      # rows start 2 bytes off 16
    p = fa_kernel.plan(q, q, q, torch.empty_like(q))
    assert p["body"] == "mma" and not p["vec_in"] and p["vec_out"]
    p32 = fa_kernel.plan(*(_heads(2, 4, 100, 72, torch.float32),) * 4)
    assert p32["body"] == "cuda_cores" and p32["blocks"] == 2 * 4 * 2


@pytest.mark.parametrize("D,dtype,body,access,lanes,chunks", [
    (1152, torch.bfloat16, "registers", 16, 32, 5),   # dit-i256
    (1152, torch.float32, "registers", 16, 32, 9),    # its fp32 serving
    (384, torch.bfloat16, "registers", 16, 16, 3),    # dit-cifar
    (384, torch.float32, "registers", 16, 32, 3),
    (128, torch.bfloat16, "registers", 16, 16, 1),    # reduced
    (128, torch.float32, "registers", 16, 16, 2),
    (72, torch.bfloat16, "registers", 16, 16, 1),     # 9 of 16 lanes
    (1004, torch.bfloat16, "generic", 8, 32, 0),      # 2008-byte rows
    (8192, torch.bfloat16, "generic", 16, 32, 0),     # MAX_D
    (1003, torch.bfloat16, "generic", 2, 32, 0),
    (1003, torch.float32, "generic", 4, 32, 0),
    (1000, torch.float32, "generic", 16, 32, 0),
])
def test_modulate_plan_by_width_and_dtype(D, dtype, body, access, lanes,
                                          chunks):
    x, sh, sc = _modulate_operands(2, 9, D, dtype, "dit", "cpu", 0)
    p = adaln_kernel.plan(x, sh, sc, torch.empty_like(x))
    assert (p["body"], p["access_bytes"], p["lanes"], p["chunks"]) == (
        body, access, lanes, chunks)
    assert p["rows_per_block"] == adaln_kernel.MOD_THREADS // lanes
    assert p["blocks"] == 2 * -(-9 // p["rows_per_block"])   # a wave


def test_modulate_plan_main_path_shape():
    """dit-i256: 4096 rows of 1152 bf16 with shift/scale read in place
    from the (16, 6912) modulation -> one warp a row, 16-byte chunks, five
    a lane (the fifth masked), 8 rows a block; a block per 8 rows would be
    512 blocks, two waves of 2 blocks on 132 SMs, so 256 blocks whose
    warps take 2 rows each."""
    x, sh, sc = _modulate_operands(16, 256, 1152, torch.bfloat16, "dit",
                                   "cpu", 0)
    assert adaln_kernel.plan(x, sh, sc, torch.empty_like(x)) == dict(
        body="registers", access_bytes=16, lanes=32, chunks=5,
        rows_per_block=8, blocks=256)


@pytest.mark.parametrize("B,T,blocks", [
    (16, 64, 16 * 8),         # dit-cifar's 1024 rows: one row a warp
    (16, 256, 16 * 16),       # 2 rows a warp
    (8, 256, 8 * 32),         # 2048 rows in 256 blocks: one wave
    (16, 1024, 16 * 16),      # 8 rows a warp
    (1, 4097, 1 * 257),       # 513 blocks' rows in 2 turns
])
def test_modulate_plan_grid_fills_one_wave(B, T, blocks):
    x, sh, sc = _modulate_operands(B, T, 1152, torch.bfloat16, "dit", "cpu",
                                   0)
    p = adaln_kernel.plan(x, sh, sc, torch.empty_like(x))
    assert p["blocks"] == blocks
    assert p["blocks"] <= max(B, adaln_kernel.BLOCKS_PER_SM
                              * adaln_kernel.H100_SMS)


def test_modulate_plan_conditioning_layouts():
    """The head's (B, 2D) rows keep 16-byte accesses; rows at a 2-byte
    offset take the generic body's 2-byte accesses for every operand, as
    does a row stride that is no multiple of 16 bytes."""
    for layout, body, access in (("head", "registers", 16),
                                 ("unaligned", "generic", 2)):
        x, sh, sc = _modulate_operands(4, 5, 1152, torch.bfloat16, layout,
                                       "cpu", 0)
        p = adaln_kernel.plan(x, sh, sc, torch.empty_like(x))
        assert (p["body"], p["access_bytes"]) == (body, access), layout
    x = torch.zeros(4, 5, 1152, dtype=torch.bfloat16)
    mod = torch.zeros(4, 2 * 1152 + 4, dtype=torch.bfloat16)  # stride 4616 B
    p = adaln_kernel.plan(x, mod[:, :1152], mod[:, 1152:2304],
                          torch.empty_like(x))
    assert (p["body"], p["access_bytes"]) == ("generic", 8)


def test_modulate_plan_refuses_d_above_max_d():
    D = adaln_kernel.MAX_D + 8
    x, sh, sc = _modulate_operands(1, 2, D, torch.bfloat16, "dit", "cpu", 0)
    with pytest.raises(ValueError, match=f"D <= {adaln_kernel.MAX_D}"):
        adaln_kernel.plan(x, sh, sc, torch.empty_like(x))


@pytest.mark.parametrize("D,dtype,body,access,lanes,chunks", [
    (1152, torch.bfloat16, "registers", 16, 32, 5),   # dit-i256
    (1152, torch.float32, "registers", 16, 32, 9),
    (384, torch.bfloat16, "registers", 16, 16, 3),    # dit-cifar
    (72, torch.bfloat16, "registers", 16, 16, 1),     # 9 of 16 lanes
    (72, torch.float32, "registers", 16, 16, 2),
    (1004, torch.bfloat16, "generic", 8, 32, 0),      # 2008-byte rows
    (1004, torch.float32, "generic", 16, 32, 0),
])
def test_gate_plan_by_width_and_dtype(D, dtype, body, access, lanes, chunks):
    """gate_residual's plan at the configs' widths, the gate read in place
    from the (B, 6D) modulation (its row stride 6D)."""
    resid, gate, y = _gate_operands(2, 9, D, dtype, "dit", "cpu", 0)
    p = adaln_kernel.plan_gate(resid, gate, y, torch.empty_like(resid))
    assert (p["body"], p["access_bytes"], p["lanes"], p["chunks"]) == (
        body, access, lanes, chunks)
    assert gate.stride(0) == 6 * D
    assert p["rows_per_block"] == adaln_kernel.MOD_THREADS // lanes


def test_gate_plan_main_path_shape_fills_one_wave():
    """dit-i256: 4096 rows of 1152 bf16 -> a warp a row, five 16-byte
    chunks a lane, 8 rows a block; 512 blocks would be two waves of 2
    blocks on 132 SMs, so 256 blocks whose warps take 2 rows each."""
    resid, gate, y = _gate_operands(16, 256, 1152, torch.bfloat16, "dit",
                                    "cpu", 0)
    assert adaln_kernel.plan_gate(resid, gate, y,
                                  torch.empty_like(resid)) == dict(
        body="registers", access_bytes=16, lanes=32, chunks=5,
        rows_per_block=8, blocks=256)


@pytest.mark.parametrize("layout,dtype,body,access", [
    ("unaligned", torch.bfloat16, "generic", 2),   # gate 2 bytes off
    ("unaligned", torch.float32, "generic", 4),
    ("rows", torch.bfloat16, "generic", 2),        # resid/y 2 bytes off
    ("rows", torch.float32, "generic", 4),
])
def test_gate_plan_narrows_to_what_every_operand_allows(layout, dtype, body,
                                                        access):
    resid, gate, y = _gate_operands(4, 5, 1152, dtype, layout, "cpu", 0)
    p = adaln_kernel.plan_gate(resid, gate, y, torch.empty_like(resid))
    assert (p["body"], p["access_bytes"]) == (body, access)
    out = torch.empty(4 * 5 * 1152 + 8, dtype=dtype)[8 // dtype.itemsize + 1:]
    p = adaln_kernel.plan_gate(*_gate_operands(4, 5, 1152, dtype, "dit",
                                               "cpu", 0)[:3],
                               out[:4 * 5 * 1152].view(4, 5, 1152))
    assert p["access_bytes"] == dtype.itemsize     # the output's too


def test_gate_residual_kernel_arithmetic_is_the_plain_versions():
    """The kernel rounds resid + gate * y as the plain version does: the
    product, then the sum, each to fp32 (no fused multiply-add), then once
    to the output type. On the CPU the op is the plain version, so this
    pins that version's order against a float64 reference rounded the same
    way."""
    rng = _rng(14)
    r, g, y = (rng.normal(size=s_).astype(np.float32)
               for s_ in ((2, 7, 72), (2, 72), (2, 7, 72)))
    prod = (g[:, None].astype(np.float64) * y).astype(np.float32)
    want = (prod.astype(np.float64) + r).astype(np.float32)
    got = t_adaln.gate_residual(torch.as_tensor(r), torch.as_tensor(g),
                                torch.as_tensor(y))
    np.testing.assert_array_equal(got.numpy(), want)
