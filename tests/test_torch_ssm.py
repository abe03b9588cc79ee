"""The port's Mamba2 / SSD block (`repro_torch.models.ssm`) against the JAX
reference's (`repro.models.ssm`), function by function, on the same inputs.

Inputs are drawn with numpy from a seed; block params come from the
reference's `mamba2_init`, every leaf perturbed by 0.05 N(0, 1) (the zero
conv bias and the unit norm and D would otherwise leave parts of the
comparison vacuous). fp32 on the CPU; tolerance 1e-5 relative L-inf
(matmul and reduction order differ between XLA and PyTorch). Covered: the
chunked scan over (length, chunk, groups), the zero-dt pad to a whole
chunk included, and its gradients against `jax.vjp`; the block with and
without its decode state, a prompt shorter than the conv window
included; the one-token decode, which writes its state in place; decode
over a sequence against the full block and the prefill state against the
decode state (the reference's tests/test_ssd_moe.py, here against the
port's own full block at 1e-5); the conv window sliced from the prefill's
projection bit-equal to the reference's recomputation of it; and the block
and its decode at bf16 activations against the reference at bf16 (2e-2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.models import ssm as j_ssm
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.models import ssm as t_ssm

torch.set_num_threads(2)

TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _t(a):
    return torch.as_tensor(np.array(a))


def _cfgs(**over):
    kw = dict(arch_id="t", family="ssm", num_layers=1, d_model=64,
              num_heads=0, head_dim=0, d_ff=0, vocab_size=64, ssm_state=16,
              ssm_head_dim=16, ssm_expand=2, ssm_chunk=8, dtype="float32",
              param_dtype="float32")
    kw.update(over)
    return JConfig(**kw), TConfig(**kw)


def _block_params(jcfg, seed=0, scale=0.05):
    """(jax params, port params): mamba2_init perturbed with numpy."""
    tree = jax.tree.map(np.asarray, j_ssm.mamba2_init(
        jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 1)
    tree = jax.tree.map(
        lambda a: (a + scale * rng.normal(size=a.shape)).astype(a.dtype), tree)
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree))


def _scan_inputs(b, l, h, p, g, n, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(size=(b, l, h, p)).astype(np.float32),
        dt=(0.1 + 0.5 * rng.random((b, l, h))).astype(np.float32),
        A=-np.exp(rng.normal(size=(h,))).astype(np.float32),
        B=rng.normal(size=(b, l, g, n)).astype(np.float32),
        C=rng.normal(size=(b, l, g, n)).astype(np.float32),
        D=rng.normal(size=(h,)).astype(np.float32))


# (length, chunk, groups): whole chunks, the pad path (a ragged last
# chunk, and a sequence shorter than one chunk), groups of 2 and 4 heads
SCAN_CASES = [(32, 8, 1), (24, 8, 2), (20, 8, 1), (20, 8, 2), (5, 8, 4),
              (37, 16, 4), (64, 64, 1)]


@pytest.mark.parametrize("l,chunk,g", SCAN_CASES)
def test_ssd_scan_matches_reference(l, chunk, g):
    inp = _scan_inputs(2, l, 8, 8, g, 8)
    y_j, S_j = j_ssm.ssd_scan(*(jnp.asarray(inp[k]) for k in "x dt A B C D"
                                .split()), chunk)
    y_t, S_t = t_ssm.ssd_scan(*(_t(inp[k]) for k in "x dt A B C D".split()),
                              chunk)
    assert y_t.shape == y_j.shape and S_t.shape == S_j.shape
    assert y_t.dtype == S_t.dtype == torch.float32
    assert _rel(y_t, y_j) <= TOL
    assert _rel(S_t, S_j) <= TOL


@pytest.mark.parametrize("l,chunk,g", [(20, 8, 2), (16, 8, 1)])
def test_ssd_scan_gradients_match_jax_vjp(l, chunk, g):
    """The scan's gradients (x, dt, A, B, C, D) through a cotangent on y and
    on the final state, against jax.vjp, the pad path included."""
    inp = _scan_inputs(2, l, 8, 8, g, 8, seed=1)
    rng = np.random.default_rng(2)
    dy = rng.normal(size=inp["x"].shape).astype(np.float32)
    dS = rng.normal(size=(2, 8, 8, 8)).astype(np.float32)
    names = "x dt A B C D".split()
    _, vjp = jax.vjp(lambda *a: j_ssm.ssd_scan(*a, chunk),
                     *(jnp.asarray(inp[k]) for k in names))
    want = vjp((jnp.asarray(dy), jnp.asarray(dS)))
    leaves = [_t(inp[k]).requires_grad_() for k in names]
    y, S = t_ssm.ssd_scan(*leaves, chunk)
    got = torch.autograd.grad((y * _t(dy)).sum() + (S * _t(dS)).sum(),
                              leaves)
    for name, a, b in zip(names, got, want):
        assert torch.isfinite(a).all(), name
        assert _rel(a, b) <= TOL, (name, _rel(a, b))


def test_segsum_and_softplus_match_reference():
    a = np.random.default_rng(3).normal(size=(2, 3, 9)).astype(np.float32)
    want = np.asarray(j_ssm._segsum(jnp.asarray(a)))
    got = t_ssm._segsum(_t(a)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert _rel(got[fin], want[fin]) <= TOL
    # torch's F.softplus is x itself above 20; the reference's is not
    x = np.array([-80.0, -20.5, -1.0, 0.0, 0.3, 19.0, 21.0, 35.0, 90.0],
                 np.float32)
    np.testing.assert_allclose(t_ssm.softplus(_t(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-7, atol=0)


def test_causal_conv_and_init_layout_match_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _block_params(jcfg)
    xbc = np.random.default_rng(4).normal(size=(2, 11, 64 * 2 + 32)).astype(
        np.float32)
    want = j_ssm._causal_conv(jp, jnp.asarray(xbc), jcfg)
    got = t_ssm._causal_conv(tp, _t(xbc), tcfg)
    assert _rel(got, want) <= TOL
    mine = t_ssm.mamba2_init(torch.Generator().manual_seed(0), tcfg, "cpu")
    ref = jax.tree.map(np.asarray, j_ssm.mamba2_init(jax.random.PRNGKey(0),
                                                     jcfg))
    assert jax.tree.structure(jax.tree.map(lambda a: 0, mine)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, ref))
    for k in ("A_log", "D", "dt_bias", "conv_b"):     # the deterministic ones
        np.testing.assert_allclose(mine[k].numpy(), ref[k], rtol=1e-6)
    for k in ref:
        if k != "out_norm":
            assert tuple(mine[k].shape) == ref[k].shape, k


@pytest.mark.parametrize("S", [13, 16, 2])
@pytest.mark.parametrize("return_state", [False, True])
def test_mamba2_apply_matches_reference(S, return_state):
    """The full block, with its decode state (S 2: a prompt shorter than
    the conv window, zero rows in front)."""
    jcfg, tcfg = _cfgs()
    jp, tp = _block_params(jcfg)
    u = np.random.default_rng(5).normal(size=(2, S, 64)).astype(np.float32)
    want = j_ssm.mamba2_apply(jp, jnp.asarray(u), jcfg,
                              return_state=return_state)
    got = t_ssm.mamba2_apply(tp, _t(u), tcfg, return_state=return_state)
    if not return_state:
        want, got = (want, {}), (got, {})
    assert _rel(got[0], want[0]) <= TOL
    for k in got[1]:
        assert got[1][k].shape == want[1][k].shape
        assert _rel(got[1][k], want[1][k]) <= TOL, k


@pytest.mark.parametrize("S", [9, 2])
def test_prefill_conv_window_is_bit_equal_to_recomputing_it(S):
    """The port slices the conv window from the in_proj it already took;
    the reference's `_conv_input_tail` takes in_proj again: the same bits."""
    _, tcfg = _cfgs()
    _, tp = _block_params(_cfgs()[0])
    u = _t(np.random.default_rng(6).normal(size=(2, S, 64)).astype(
        np.float32))
    _, st = t_ssm.mamba2_apply(tp, u, tcfg, return_state=True)
    _, xbc_raw, _ = t_ssm._split_proj(tp, u, tcfg)
    K = tcfg.ssm_conv
    want = torch.cat([torch.zeros(2, max(0, K - 1 - S), xbc_raw.shape[-1]),
                      xbc_raw[:, -(K - 1):]], dim=1)
    assert st["conv"].shape == (2, K - 1, xbc_raw.shape[-1])
    assert torch.equal(st["conv"], want)


def test_mamba2_decode_matches_reference_and_writes_in_place():
    jcfg, tcfg = _cfgs(ssm_groups=2)
    jp, tp = _block_params(jcfg, seed=3)
    rng = np.random.default_rng(7)
    u = rng.normal(size=(2, 5, 64)).astype(np.float32)
    jstate = j_ssm.init_mamba_state(jcfg, 2)
    tstate = t_ssm.init_mamba_state(tcfg, 2)
    held = dict(tstate)
    for i in range(5):
        jy, jstate = j_ssm.mamba2_decode(jp, jstate, jnp.asarray(u[:, i:i + 1]),
                                         jcfg)
        ty, out = t_ssm.mamba2_decode(tp, tstate, _t(u[:, i:i + 1]), tcfg)
        assert out is tstate and all(out[k] is held[k] for k in held)
        assert _rel(ty, jy) <= TOL, i
        for k in ("ssm", "conv"):
            assert _rel(tstate[k], jstate[k]) <= TOL, (i, k)


def test_decode_over_a_sequence_matches_the_full_block():
    """Token by token with the recurrent state against the chunked pass,
    and the prefill state against the decode state (the reference's
    tests/test_ssd_moe.py, at 1e-5 here)."""
    _, tcfg = _cfgs()
    _, tp = _block_params(_cfgs()[0], seed=4)
    B, S = 2, 24
    u = _t(0.5 * np.random.default_rng(8).normal(size=(B, S, 64)).astype(
        np.float32))
    y_full, st_full = t_ssm.mamba2_apply(tp, u, tcfg, return_state=True)
    state = t_ssm.init_mamba_state(tcfg, B)
    ys = [t_ssm.mamba2_decode(tp, state, u[:, i:i + 1], tcfg)[0]
          for i in range(S)]
    assert _rel(torch.cat(ys, 1), y_full) <= TOL
    assert _rel(state["ssm"], st_full["ssm"]) <= TOL
    # one-row and many-row in_proj products differ in their last bits
    assert _rel(state["conv"], st_full["conv"]) <= TOL


BF16_TOL = 2e-2


def _as64(a):
    if torch.is_tensor(a):
        return a.double().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32), np.float64)


@pytest.mark.parametrize("groups", [1, 2])
def test_bf16_block_and_decode_match_the_reference(groups):
    """At bf16 activations the block (13 tokens, a padded chunk), its
    decode state and 16 decode steps after it run through both packages
    on the same params: every output and state has the reference's dtype
    (the state kept and rounded in bf16 each token, the scan's final state
    cast to it) and lies within BF16_TOL relative L-inf of the reference's.
    The two differ by single bf16 roundings (XLA fuses a bf16 silu in its
    own exp, and one-row products round apart): up to 1.2e-2, the size of
    the reference's own bf16 distance from its fp32 run (1.1e-2 to
    1.3e-2)."""
    jcfg, tcfg = _cfgs(dtype="bfloat16", ssm_groups=groups)
    jp, tp = _block_params(_cfgs(ssm_groups=groups)[0], seed=5)
    S, steps = 13, 16
    u = np.random.default_rng(9).normal(size=(2, S + steps, 64)).astype(
        np.float32)
    ju, tu = jnp.asarray(u, jnp.bfloat16), _t(u).to(torch.bfloat16)
    jy, jstate = j_ssm.mamba2_apply(jp, ju[:, :S], jcfg, return_state=True)
    ty, tstate = t_ssm.mamba2_apply(tp, tu[:, :S], tcfg, return_state=True)
    for i in range(S, S + steps + 1):
        for got, want in [(ty, jy)] + [(tstate[k], jstate[k])
                                       for k in ("ssm", "conv")]:
            assert str(got.dtype).split(".")[-1] == str(want.dtype)
            assert got.dtype == torch.bfloat16
            assert _rel(_as64(got), _as64(want)) <= BF16_TOL, i
        if i < S + steps:
            jy, jstate = j_ssm.mamba2_decode(jp, jstate, ju[:, i:i + 1],
                                             jcfg)
            ty, _ = t_ssm.mamba2_decode(tp, tstate, tu[:, i:i + 1], tcfg)
