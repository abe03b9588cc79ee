"""The port's step program, plan banks, eval precision and thresholding
against the JAX reference's.

* the coded done mask, `init_meta`, tier resolution and costs, and
  `default_tier_specs`: equal to the reference's;
* `step_flight` driven tick by tick beside JAX's on the same admissions and
  meta scatters: meta and done codes equal, states <= 1e-5 (fp32);
* plan banks: spans equal, a mixed-tier batch within 1e-5 of each tier's
  uniform run and of the JAX bank, and the bank validations;
* donation: `donate=True` returns the state buffers it was given, updated
  in place; `donate=False` leaves its input intact; both bit-identical;
* `eval_dtype`: `cast_params_for_eval` bit-equal as bf16 bits, the
  handshakes, and a bf16-eval sample within 1e-2 (DESIGN.md §11.3);
* the weights kept once: bit-equal latents, and the per-use casts gone;
* dynamic thresholding: <= 1e-6 on its own, <= 1e-5 through the engine.

The `gpu` tests hold the CUDA graph replays bit-equal to the eager runs.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.registry import get_config as j_get_config
from repro.diffusion import VPLinear as JVP
from repro.diffusion.guidance import dynamic_threshold as j_threshold
from repro.engine import EngineSpec as JSpec
from repro.engine import SamplerEngine as JEngine
from repro.engine import compiler as j_compiler
from repro.engine.specs import default_tier_specs as j_tier_specs
from repro.launch.sample import build_engine as j_build_engine
from repro.models import api as j_api
from repro_torch.configs import get_config as t_get_config
from repro_torch.diffusion import VPLinear as TVP
from repro_torch.diffusion.guidance import dynamic_threshold as t_threshold
from repro_torch.engine import EngineSpec as TSpec
from repro_torch.engine import SamplerEngine as TEngine
from repro_torch.engine import compiler as t_compiler
from repro_torch.engine.specs import default_tier_specs as t_tier_specs
from repro_torch.kernels.dispatch import LAUNCHES
from repro_torch.launch.sample import build_engine as t_build_engine
from repro_torch.models import api as t_api

torch.set_num_threads(2)

COND, UNCOND = (0.7, 0.35), (-0.4, 0.5)   # (mu, s) of the analytic data laws
D = 8                                      # sample width of the analytic runs


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _gauss_eps(mu, s, xp):
    """Exact eps of data ~ N(mu, s^2 I) under VPLinear; scalar or (B,) t.
    `xp` is (asarray, exp, sqrt, log_alpha) of one framework."""
    asarray, exp, sqrt, log_alpha = xp

    def eps(x, t, **_):
        t = asarray(t)
        a = exp(log_alpha(t))
        sig = sqrt(1 - a * a)
        if t.ndim == 1:
            a = a.reshape((-1,) + (1,) * (x.ndim - 1))
            sig = sig.reshape(a.shape)
        return sig * (x - a * mu) / (a * a * s ** 2 + sig * sig)

    return eps


def _j_eps(mu, s):
    sched = JVP()
    return _gauss_eps(mu, s, (jnp.asarray, jnp.exp, jnp.sqrt,
                              sched.log_alpha_jax))


def _t_eps(mu, s, device="cpu"):
    sched = TVP()
    return _gauss_eps(mu, s, (lambda t: torch.as_tensor(t, device=device),
                              torch.exp, torch.sqrt, sched.log_alpha_torch))


def _stacked(eps_c, eps_u, cat, split):
    def eps_stacked(xx, t, **_):
        x1, x2 = split(xx)
        t1, t2 = split(t) if np.ndim(t) == 1 else (t, t)
        return cat([eps_c(x1, t1), eps_u(x2, t2)])
    return eps_stacked


def j_engine():
    ec, eu = _j_eps(*COND), _j_eps(*UNCOND)
    return JEngine(JVP(), eps=ec, eps_stacked=_stacked(
        ec, eu, lambda a: jnp.concatenate(a, 0), lambda a: jnp.split(a, 2, 0)))


def t_engine(device="cpu"):
    ec, eu = _t_eps(*COND, device=device), _t_eps(*UNCOND, device=device)
    return TEngine(TVP(), eps=ec, eps_stacked=_stacked(
        ec, eu, lambda a: torch.cat(a, 0), lambda a: torch.chunk(a, 2, 0)),
        device=device)


def _x_T(rid):
    return np.random.default_rng(100 + rid).normal(size=(D,)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the done mask, the meta, tiers
# ---------------------------------------------------------------------------


def test_flag_done_and_finite_slots_match_reference():
    """Idle, finishing, NaN and Inf slots: the same codes."""
    x = np.random.default_rng(0).normal(size=(6, 3, 4)).astype(np.float32)
    x[2, 1, 0] = np.nan
    x[3, 0, 3] = np.inf
    x[5, 2, 2] = -np.inf
    done = np.array([True, False, True, True, False, False])
    np.testing.assert_array_equal(
        t_compiler.finite_slots(torch.as_tensor(x)).numpy(),
        np.asarray(j_compiler.finite_slots(jnp.asarray(x))))
    got = t_compiler.flag_done(torch.as_tensor(done), torch.as_tensor(x))
    want = np.asarray(j_compiler.flag_done(jnp.asarray(done), jnp.asarray(x)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (t_compiler.DONE_IDLE, t_compiler.DONE_OK,
            t_compiler.DONE_NONFINITE) == (j_compiler.DONE_IDLE,
                                           j_compiler.DONE_OK,
                                           j_compiler.DONE_NONFINITE)
    assert list(got.numpy()) == [1, 0, 2, 2, 0, 0]


def test_default_tier_specs_match_reference():
    for common in ({}, {"cfg_scale": 2.0, "thresholding": True}):
        got, want = t_tier_specs(**common), j_tier_specs(**common)
        assert list(got) == list(want)
        for name in want:
            for f in dataclasses.fields(got[name]):
                assert getattr(got[name], f.name) == getattr(want[name],
                                                             f.name), (
                    name, f.name)


@pytest.mark.parametrize("bank", [False, True])
def test_init_meta_tiers_and_costs_match_reference(bank):
    j_eng, t_eng = j_engine(), t_engine()
    if bank:
        jp = j_eng.build_bank(j_tier_specs(), jit=False)
        tp = t_eng.build_bank(t_tier_specs(), jit=False)
        assert tp.tiers == jp.tiers
        tags = [None, "fast", "balanced", "quality", "turbo"]
    else:
        jp = j_eng.build_step(JSpec(nfe=7, order=3), jit=False)
        tp = t_eng.build_step(TSpec(nfe=7, order=3), jit=False)
        assert tp.tiers is None
        tags = [None, "fast"]
    assert tp.n_rows == jp.n_rows and tp.ring == jp.ring
    meta = tp.init_meta(5)
    assert meta.dtype == torch.int32 and meta.device.type == "cpu"
    np.testing.assert_array_equal(meta.numpy(), np.asarray(jp.init_meta(5)))
    for tag in tags:
        try:
            want = (jp.resolve_tier(tag), jp.tier_eval_cost(tag))
        except ValueError as err:
            with pytest.raises(ValueError) as got_err:
                tp.resolve_tier(tag)
            assert str(got_err.value) == str(err)
            with pytest.raises(ValueError):
                tp.tier_eval_cost(tag)
            continue
        assert (tp.resolve_tier(tag), tp.tier_eval_cost(tag)) == want
    assert tp.span_cost(2, 5) == jp.span_cost(2, 5) == 5.0


def test_resolve_tier_raises_as_the_reference():
    """The three ValueErrors of the reference's tier tags."""
    t_eng = t_engine()
    bank = t_eng.build_bank({"fast": TSpec(nfe=4, order=2)})
    with pytest.raises(ValueError, match="unknown tier"):
        bank.resolve_tier("turbo")
    with pytest.raises(ValueError, match="tag requests"):
        bank.resolve_tier(None)
    single = t_eng.build_step(TSpec(nfe=4, order=2))
    with pytest.raises(ValueError, match="single plan"):
        single.resolve_tier("fast")


# ---------------------------------------------------------------------------
# step_flight beside the reference's, tick by tick
# ---------------------------------------------------------------------------

# (arrival tick, guidance scale, tier): six requests over three slots, so
# slots free and are re-admitted
TRACE = [(0, 1.0, "fast"), (0, 2.0, "quality"), (1, 3.5, "balanced"),
         (3, 0.5, "fast"), (4, 2.0, "balanced"), (9, 1.5, "fast")]


class _Side:
    """One framework's slot state under the same host-side admissions."""

    def __init__(self, program, slots, cfg, torch_side):
        self.p, self.cfg, self.t = program, cfg, torch_side
        self.state = program.init_state(slots, (D,))
        self.meta = program.init_meta(slots)
        self.g = program.init_g(slots)

    def admit(self, s, x_T, off, budget, scale):
        x, E = self.state
        col = np.array([0, off, budget, 1], np.int32)
        if self.t:     # in place, into whatever the program handed out
            x[s] = torch.as_tensor(x_T)
            E[:, s] = 0
            self.meta[:, s] = torch.as_tensor(col)
            self.g[s] = scale
        else:
            self.state = (x.at[s].set(jnp.asarray(x_T)), E.at[:, s].set(0.0))
            self.meta = self.meta.at[:, s].set(jnp.asarray(col))
            self.g = self.g.at[s].set(scale)

    def tick(self):
        self.state, self.meta, done = self.p.step_flight(
            self.state, self.meta, self.g if self.cfg else None)
        return np.asarray(done)


def _flight(t_prog, j_prog, cfg, slots=3, trace=TRACE):
    """Drive both programs through `trace` (tiers when they are banks),
    comparing meta, done codes and states at every tick. Returns the port's
    {rid: latent}."""
    t, j = _Side(t_prog, slots, cfg, True), _Side(j_prog, slots, cfg, False)
    owner, queue, out, tick = [None] * slots, list(enumerate(trace)), {}, 0
    while len(out) < len(trace):
        while queue and queue[0][1][0] <= tick and None in owner:
            rid, (_, scale, tier) = queue.pop(0)
            s = owner.index(None)
            off, budget = t_prog.resolve_tier(tier if t_prog.tiers else None)
            for side in (t, j):
                side.admit(s, _x_T(rid), off, budget, scale)
            owner[s] = rid
        done = t.tick()
        np.testing.assert_array_equal(done, j.tick())
        np.testing.assert_array_equal(t.meta.numpy(), np.asarray(j.meta))
        # the slots' latents; the eval ring holds x0 predictions, which
        # divide by alpha_t and so scale the frameworks' ulp differences
        np.testing.assert_allclose(t.state[0].numpy(), np.asarray(j.state[0]),
                                   rtol=0, atol=1e-5, err_msg=f"tick {tick}")
        for s in np.flatnonzero(done):
            assert done[s] == t_compiler.DONE_OK
            out[owner[s]] = t.state[0][s].numpy().copy()
            owner[s] = None
        tick += 1
    return out


@pytest.mark.parametrize("cfg", [False, True])
def test_step_flight_matches_reference_tick_by_tick(cfg):
    """Staggered admissions and re-admitted slots, guidance on and off; the
    completions also equal the uniform runs."""
    spec = dict(nfe=6, order=3, cfg_scale=2.0 if cfg else 0.0)
    t_prog = t_engine().build_step(TSpec(**spec))
    j_prog = j_engine().build_step(JSpec(**spec), donate=False)
    got = _flight(t_prog, j_prog, cfg)
    eng = t_engine()
    for rid, (_, scale, _) in enumerate(TRACE):
        ref = eng.build(TSpec(**{**spec, "cfg_scale": scale if cfg else 0.0}))(
            torch.as_tensor(_x_T(rid))[None])[0].numpy()
        np.testing.assert_allclose(got[rid], ref, rtol=0, atol=1e-5,
                                   err_msg=f"rid={rid}")


# ---------------------------------------------------------------------------
# plan banks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [False, True])
def test_mixed_tier_bank_matches_uniform_runs_and_reference(cfg):
    """The port of tests/test_serving.py's mixed-tier acceptance, through
    `build_bank(default_tier_specs(...))` and `step_flight`."""
    common = {"cfg_scale": 2.0} if cfg else {}
    t_prog = t_engine().build_bank(t_tier_specs(**common))
    j_prog = j_engine().build_bank(j_tier_specs(**common), donate=False)
    assert t_prog.tiers == j_prog.tiers
    assert t_prog.n_rows == j_prog.n_rows == 6 + 9 + 17
    got = _flight(t_prog, j_prog, cfg)
    eng, specs = t_engine(), t_tier_specs(**common)
    for rid, (_, scale, tier) in enumerate(TRACE):
        spec = specs[tier]
        if cfg:
            spec = dataclasses.replace(spec, cfg_scale=scale)
        ref = eng.build(spec)(torch.as_tensor(_x_T(rid))[None])[0].numpy()
        np.testing.assert_allclose(got[rid], ref, rtol=0, atol=1e-5,
                                   err_msg=f"rid={rid} tier={tier}")


BANK_ERRORS = {
    "prediction": ({"a": TSpec(nfe=4), "b": TSpec(nfe=4,
                                                  prediction="noise")}, None),
    "guidance scale": ({"a": TSpec(nfe=4, cfg_scale=2.0),
                        "b": TSpec(nfe=6, cfg_scale=3.0)}, None),
    "fused_update": ({"a": TSpec(nfe=4),
                      "b": TSpec(nfe=6, fused_update=False)}, None),
    "eval_dtype": ({"a": TSpec(nfe=4, order=2),
                    "b": TSpec(nfe=6, order=2, eval_dtype="bfloat16")}, None),
    "quant": ({"a": TSpec(nfe=4), "b": TSpec(nfe=6, quant="w8a16")}, None),
    "not in tier_specs": ({"a": TSpec(nfe=4)}, {"c": None}),
    "at least one": ({}, None),
}


@pytest.mark.parametrize("match", list(BANK_ERRORS))
def test_bank_validations_raise(match):
    """As tests/test_serving.py:352,367 and tests/test_fast_eval.py:239."""
    tier_specs, tables = BANK_ERRORS[match]
    with pytest.raises(ValueError, match=match):
        t_engine().build_bank(tier_specs, tables)


# ---------------------------------------------------------------------------
# donation
# ---------------------------------------------------------------------------


def _trajectory(prog, slots=3):
    """Every row of a batch of slots by `step` and by `step_flight` from the
    program's own buffers; returns the states after each tick and what the
    steps returned against what they were given."""
    x0 = torch.as_tensor(np.random.default_rng(3).normal(
        size=(slots, D)).astype(np.float32))
    state = prog.init_state(slots, (D,))
    state[0].copy_(x0)
    meta = prog.init_meta(slots)
    meta[1] = 0
    meta[3] = 1
    given = (state, meta)
    fstate = tuple(t.clone() for t in state)
    outs, same = [], []
    for i in range(prog.n_rows):
        before = tuple(t.clone() for t in state)
        new = prog.step(state, torch.full((slots,), i))
        same.append((new[0] is state[0] and new[1] is state[1],
                     all(torch.equal(a, b) for a, b in zip(before, state))))
        state = new
        fnew, fmeta, done = prog.step_flight(fstate, meta)
        same.append((fnew[0] is fstate[0] and fmeta is meta, None))
        fstate, meta = fnew, fmeta
        outs.append((state[0].clone(), fstate[0].clone(), done.clone()))
    return outs, same, given


def test_donated_steps_update_their_buffers_in_place():
    """donate=True returns the buffers it was given (the ones init_state
    and init_meta handed out), updated in place; donate=False returns new
    tensors and leaves its input intact; the two are bit-identical (the
    port of tests/test_fast_eval.py:277,306)."""
    eng, spec = t_engine(), TSpec(nfe=5, order=2)
    d_outs, d_same, _ = _trajectory(eng.build_step(spec, donate=True))
    u_outs, u_same, _ = _trajectory(eng.build_step(spec, donate=False))
    assert all(is_same for is_same, _ in d_same)
    assert not any(is_same for is_same, _ in u_same)
    assert all(intact for _, intact in u_same[::2])
    for a, b in zip(d_outs, u_outs):
        for p, q in zip(a, b):
            assert torch.equal(p, q)
    # the step and the flight step run the same rows: the same bits
    assert all(torch.equal(s, f) for s, f, _ in d_outs)
    assert list(d_outs[-1][2].numpy()) == [t_compiler.DONE_OK] * 3


# ---------------------------------------------------------------------------
# eval_dtype and the weights kept once
# ---------------------------------------------------------------------------


def _perturbed_tree(cfg, seed=0, scale=0.05):
    tree = jax.tree.map(np.asarray, j_api.init_params(
        cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(
        lambda a: (a + scale * rng.normal(size=a.shape)).astype(a.dtype),
        tree)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def test_cast_params_for_eval_matches_reference_as_bf16_bits():
    jcfg = j_get_config("dit-cifar").reduced()
    tree = _perturbed_tree(jcfg)
    want = j_api.cast_params_for_eval(jax.tree.map(jnp.asarray, tree),
                                      "bfloat16")
    got = t_api.cast_params_for_eval(t_api.params_from_numpy(
        tree, t_get_config("dit-cifar").reduced(), "cpu"), "bfloat16")
    w_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(w_leaves) > 10
    for path, w in w_leaves:
        g = got
        for k in path:
            g = g[k.key]
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        np.testing.assert_array_equal(
            g.view(torch.int16).numpy().view(np.uint16), _bits(w),
            err_msg=jax.tree_util.keystr(path))
    # quant records pass through untouched
    rec = {"qw": torch.ones(2, 2, dtype=torch.int8),
           "ws": torch.ones(2), "sa": torch.ones(())}
    out = t_api.cast_params_for_eval({"w": rec, "i": torch.arange(3)},
                                     "bfloat16")
    assert out["w"] is rec and out["i"].dtype == torch.int64


def test_eval_dtype_handshakes_raise():
    """As tests/test_fast_eval.py:211,222."""
    with pytest.raises(ValueError, match="eval_dtype"):
        TSpec(eval_dtype="float16").resolve()
    with pytest.raises(ValueError, match="eval_dtype"):
        t_build_engine(t_get_config("dit-cifar").reduced(), {}, None, 2,
                       eval_dtype="float16")
    cfg = t_get_config("dit-cifar").reduced()
    params = t_api.init_params(cfg, 0)
    eng16 = t_build_engine(cfg, params, TVP(), 2, eval_dtype="bfloat16",
                           device="cpu")
    with pytest.raises(ValueError, match="wired for 'bfloat16'"):
        eng16.build(TSpec(nfe=4))
    eng32 = t_build_engine(cfg, params, TVP(), 2, device="cpu")
    with pytest.raises(ValueError, match="wired for 'float32'"):
        eng32.build(TSpec(nfe=4, eval_dtype="bfloat16"))


def test_bf16_eval_sample_matches_reference_and_fp32():
    """Reduced dit-cifar, the port's bf16-eval sample against JAX's and
    against its own fp32 sample: <= 1e-2 relative (DESIGN.md §11.3), and
    not equal to fp32 (as tests/test_fast_eval.py:185)."""
    jcfg = j_get_config("dit-cifar").reduced()
    tcfg = t_get_config("dit-cifar").reduced()
    tree = _perturbed_tree(jcfg, seed=4, scale=0.02)
    x_T = np.random.default_rng(5).normal(
        size=(2, jcfg.patch_tokens, jcfg.latent_dim)).astype(np.float32)
    out = {}
    for ed in ("float32", "bfloat16"):
        jeng = j_build_engine(jcfg, jax.tree.map(jnp.asarray, tree), JVP(), 2,
                              eval_dtype=ed)
        out["j", ed] = np.asarray(jeng.build(JSpec(
            solver="unipc", order=2, nfe=6, eval_dtype=ed))(jnp.asarray(x_T)))
        teng = t_build_engine(tcfg, t_api.params_from_numpy(tree, tcfg, "cpu"),
                              TVP(), 2, eval_dtype=ed, device="cpu")
        got = teng.build(TSpec(order=2, nfe=6, eval_dtype=ed))(
            torch.as_tensor(x_T))
        assert got.dtype == torch.float32        # the state stays fp32
        out["t", ed] = got.numpy()
    assert _rel(out["t", "float32"], out["j", "float32"]) <= 1e-4
    assert _rel(out["t", "bfloat16"], out["j", "bfloat16"]) <= 1e-2
    err = np.abs(out["t", "bfloat16"] - out["t", "float32"]).max()
    assert err / np.abs(out["t", "float32"]).max() <= 1e-2
    assert err > 0


class _Casts(TorchDispatchMode):
    """Counts the dtype casts (aten._to_copy) dispatched in its block."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._to_copy.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_weights_kept_once_are_bit_equal_and_cast_nothing(monkeypatch):
    """Reduced dit-i256 with bf16 activations over fp32 params (the full
    config's precision): build_engine's latents equal the per-use-cast
    form's bit for bit, its tree holds bf16 exactly where a cast was made at
    use (fp32, and the same tensors, elsewhere), and a run makes 8L + 4 fewer
    casts an eval, over the rows but the last (whose eval the run skips).
    (The card's exact launch counts are chip_smoke's.)"""
    cfg = dataclasses.replace(t_get_config("dit-i256").reduced(),
                              dtype="bfloat16")
    params = t_api.params_from_numpy(
        _perturbed_tree(j_get_config("dit-i256").reduced(), seed=6), cfg,
        "cpu")
    x_T = torch.as_tensor(np.random.default_rng(7).normal(
        size=(2, cfg.patch_tokens, cfg.latent_dim)).astype(np.float32))
    spec = TSpec(nfe=4, order=3, cfg_scale=2.0)

    def run():
        eng = t_build_engine(cfg, params, TVP(), 2, device="cpu")
        with _Casts() as casts:
            out = eng.build(spec)(x_T)
        return out, casts.n

    once, n_once = run()
    with monkeypatch.context() as m:
        m.setattr(t_api, "cast_weights_once", lambda cfg, p: p)
        per_use, n_per_use = run()
    assert torch.equal(once, per_use) and torch.isfinite(once).all()
    evals = spec.nfe            # the table's nfe + 1 rows but the last
    assert n_per_use - n_once == (8 * cfg.num_layers + 4) * evals

    kept = t_api.cast_weights_once(cfg, params)["backbone"]
    bb = params["backbone"]
    cast = {"in_proj", "final_ada", "final_ada_b", "out_proj"}
    for k, v in kept.items():
        if k == "blocks":
            continue
        assert v.dtype == (torch.bfloat16 if k in cast else torch.float32), k
        if k not in cast:
            assert v is bb[k]
    for k in ("w1", "w2", "ada", "ada_b"):
        assert kept["blocks"][k].dtype == torch.bfloat16
    for k in ("wq", "wk", "wv", "wo"):
        assert kept["blocks"]["attn"][k].dtype == torch.bfloat16
        assert torch.equal(kept["blocks"]["attn"][k],
                           bb["blocks"]["attn"][k].to(torch.bfloat16))


# ---------------------------------------------------------------------------
# dynamic thresholding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 7, 5), (2, 33), (4, 1)])
@pytest.mark.parametrize("per_slot", [False, True])
def test_dynamic_threshold_matches_reference(shape, per_slot):
    rng = np.random.default_rng(sum(shape))
    x0 = (2.0 * rng.normal(size=shape)).astype(np.float32)
    q = (rng.uniform(0.5, 1.0, size=shape[0]).astype(np.float32)
         if per_slot else 0.995)
    want = np.asarray(j_threshold(jnp.asarray(x0), jnp.asarray(q)
                                  if per_slot else q))
    got = t_threshold(torch.as_tensor(x0), torch.as_tensor(q)
                      if per_slot else q)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    if not per_slot:    # a 0-d tensor level is the float's
        np.testing.assert_allclose(
            t_threshold(torch.as_tensor(x0), torch.tensor(q)).numpy(), want,
            rtol=0, atol=1e-6)


THRESH = dict(nfe=6, order=3, cfg_scale=2.0, thresholding=True,
              threshold_percentile=0.9)


def test_thresholded_build_matches_reference():
    x_T = (3.0 * np.random.default_rng(8).normal(size=(3, D))).astype(
        np.float32)
    want = np.asarray(j_engine().build(JSpec(**THRESH))(jnp.asarray(x_T)))
    got = t_engine().build(TSpec(**THRESH))(torch.as_tensor(x_T)).numpy()
    unclipped = t_engine().build(TSpec(**{**THRESH, "thresholding": False}))(
        torch.as_tensor(x_T)).numpy()
    assert np.abs(got - unclipped).max() > 1e-3       # the clip is active
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="data-prediction"):
        t_engine().compile(TSpec(nfe=4, thresholding=True, prediction="noise"))


def test_thresholded_step_matches_reference():
    t_prog = t_engine().build_step(TSpec(**THRESH))
    j_prog = j_engine().build_step(JSpec(**THRESH), donate=False)
    _flight(t_prog, j_prog, cfg=True)


# ---------------------------------------------------------------------------
# the whole-trajectory run ends on the last row's predictor
# ---------------------------------------------------------------------------


def _counted(fn, calls):
    def counted(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)
    return counted


def _cached_eps(eps):
    """An analytic feature-reuse eval: a deep eval keeps its eps as the
    cache, a shallow one averages with it, so the output reads the cache."""
    def eps_cached(x, t, cache, reuse, deep=True, **_):
        e = eps(x, t)
        return (e, e) if deep else (0.5 * (e + cache), cache)
    return eps_cached


TAIL_CASES = {
    "plain": dict(nfe=10, order=3),
    "guided": dict(nfe=8, order=3, cfg_scale=2.0),
    "thresholded": THRESH,
    "bf16": dict(nfe=6, order=2, eval_dtype="bfloat16"),
    "reuse": dict(nfe=4, order=2, cache_block=1),
    "corrector_at_last": dict(nfe=6, order=3, corrector_at_last=True),
}


@pytest.mark.parametrize("case", list(TAIL_CASES))
def test_build_skips_the_last_rows_eval_bit_equal(case, monkeypatch):
    """Where the table's last corrector is off, `build`'s run evaluates
    every row but the last, ends on that row's predictor and counts the
    skipped eval; its output is bit-equal to stepping all the rows with the
    same step. With `corrector_at_last` every row evaluates. The one-row
    warm-up a graphed run makes before its capture still evaluates."""
    from repro_torch.core.coeffs import augment_step_rows
    from repro_torch.core.unipc import deep_rows, run_rows, unipc_step_fn
    from repro_torch.engine import CacheSpec, graphs
    from repro_torch.tuning import SolverPlan

    spec = TSpec(**TAIL_CASES[case])
    eng = t_engine()
    eng.eval_dtype = spec.eval_dtype
    calls, eps = [], eng.eps
    eng.eps = _counted(eps, calls)
    eng.eps_stacked = _counted(eng.eps_stacked, calls)
    table = None
    if spec.cache_block:
        eng.eps_cached = _counted(_cached_eps(eps), calls)
        eng.cache_spec = CacheSpec((D,), 1, 2)
        plan = dataclasses.replace(SolverPlan.default(spec.nfe, order=2),
                                   cache_depth=[0] + [1] * (spec.nfe - 1))
        table = plan.compile(TVP())
    tab = eng.compile(spec, table=table)
    x = torch.as_tensor(np.stack([3.0 * _x_T(0), 3.0 * _x_T(1)]))

    step, n_rows = unipc_step_fn(eng.model_fn(spec, tab), tab, device="cpu",
                                 cached=bool(spec.cache_block))
    deep = deep_rows(augment_step_rows(tab)) if spec.cache_block else None
    calls.clear()
    want = run_rows(step, n_rows, x, ring=tab.w_pred.shape[1] + 1,
                    cache0=(eng.cache_spec.zeros(2) if spec.cache_block
                            else None), deep=deep)
    assert len(calls) == n_rows

    elided = int(not spec.corrector_at_last)
    run = eng.build(spec, jit=False, table=tab)
    calls.clear()
    outs = [run(x) for _ in range(2)]
    assert len(calls) == 2 * (n_rows - elided)
    assert run.elided_evals == 2 * elided
    assert run.evals + run.shallow_evals == 2 * (n_rows - elided)
    assert torch.equal(outs[0], want) and torch.equal(outs[1], want)
    assert torch.isfinite(want).all()

    # the warm-up row `build` hands a graphed run
    warm = {}
    monkeypatch.setattr(graphs, "graphed", lambda jit, device: True)
    monkeypatch.setattr(graphs, "graph_run", lambda run, warmup, device:
                        warm.setdefault("fn", warmup) and run)
    eng.build(spec, table=tab)
    calls.clear()
    warm["fn"](x)
    assert len(calls) == 1


# ---------------------------------------------------------------------------
# CUDA graphs (card only)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs capture the kernels")
    return torch.device("cuda")


def _card_x(rid, dev, n=2):
    return torch.as_tensor(np.random.default_rng(rid).normal(
        size=(n, D)).astype(np.float32), device=dev)


@pytest.mark.gpu
def test_card_build_replays_bit_equal_to_eager(cuda):
    """Two replays on new inputs, each bit-equal to the eager loop; the
    first result is not overwritten by the second."""
    eng = t_engine(cuda)
    spec = TSpec(nfe=8, order=3, cfg_scale=2.0)
    run, eager = eng.build(spec), eng.build(spec, jit=False)
    first = run(_card_x(1, cuda))
    first_copy = first.clone()
    second = run(_card_x(2, cuda))
    torch.cuda.synchronize()
    assert torch.equal(first, eager(_card_x(1, cuda)))
    assert torch.equal(second, eager(_card_x(2, cuda)))
    assert torch.equal(first, first_copy)


def _card_trace(prog, dev, flight, slots=3, trace=TRACE):
    """The staggered trace through `step` (host index) or `step_flight`;
    returns every tick's (x, E[, meta, done]) on the host."""
    state = prog.init_state(slots, (D,))
    g = prog.init_g(slots)
    meta = prog.init_meta(slots)
    row = np.zeros(slots, np.int64)
    owner, queue, ticks, tick = [None] * slots, list(enumerate(trace)), [], 0
    finished = 0
    while finished < len(trace):
        while queue and queue[0][1][0] <= tick and None in owner:
            rid, (_, scale, tier) = queue.pop(0)
            s = owner.index(None)
            off, budget = prog.resolve_tier(tier if prog.tiers else None)
            state[0][s] = torch.as_tensor(_x_T(rid), device=dev)
            state[1][:, s] = 0
            g[s] = scale
            meta[:, s] = torch.tensor([0, off, budget, 1], dtype=torch.int32)
            owner[s], row[s] = (rid, off, budget), 0
        if flight:
            state, meta, done = prog.step_flight(state, meta, g)
            done = done.cpu().numpy()
            out = [t.cpu() for t in state] + [meta.cpu(), done]
        else:
            busy = np.array([o is not None for o in owner])
            idx = np.where(busy, row + np.array(
                [o[1] if o else 0 for o in owner]), 0)
            state = prog.step(state, idx, g)
            row[busy] += 1
            done = np.array([o is not None and row[s] == o[2]
                             for s, o in enumerate(owner)])
            out = [t.cpu() for t in state]
        ticks.append(out)
        for s in np.flatnonzero(done):
            owner[s], row[s] = None, 0
            finished += 1
        tick += 1
    return ticks


@pytest.mark.gpu
@pytest.mark.parametrize("bank", [False, True])
@pytest.mark.parametrize("flight", [False, True])
def test_card_step_replays_bit_equal_to_eager(cuda, bank, flight):
    """`step` and `step_flight`, single plan and bank, graphed (donated)
    against the eager program over the staggered trace: every tick equal."""
    eng = t_engine(cuda)
    build = ((lambda **kw: eng.build_bank(t_tier_specs(cfg_scale=2.0), **kw))
             if bank else
             (lambda **kw: eng.build_step(TSpec(nfe=6, order=3,
                                                cfg_scale=2.0), **kw)))
    graphed = _card_trace(build(), cuda, flight)
    eager = _card_trace(build(jit=False), cuda, flight)
    assert len(graphed) == len(eager)
    for a, b in zip(graphed, eager):
        for p, q in zip(a, b):
            np.testing.assert_array_equal(np.asarray(p), np.asarray(q))


@pytest.mark.gpu
def test_card_launches_of_a_replay_equal_the_eager_counts(cuda):
    eng = t_engine(cuda)
    spec = TSpec(nfe=8, order=3, cfg_scale=2.0)
    x = _card_x(3, cuda)
    LAUNCHES.clear()
    eng.build(spec, jit=False)(x)
    eager = dict(LAUNCHES)
    assert eager == {"unipc_update": 2 * 8 + 1}   # the last row: predictor
    run = eng.build(spec)
    LAUNCHES.clear()
    run(x)                 # one warm-up row eagerly, the capture, a replay
    assert dict(LAUNCHES) == {"unipc_update": 2 + 2 * 8 + 1}
    LAUNCHES.clear()
    run(x)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == eager


FAILED_CAPTURE = """
import torch
from repro_torch.diffusion import VPLinear
from repro_torch.engine import EngineSpec, SamplerEngine

calls = []


def eps(x, t, **_):
    calls.append(torch.cuda.is_current_stream_capturing())
    torch.cuda.synchronize()
    return 0.5 * x


run = SamplerEngine(VPLinear(), eps=eps, device="cuda").build(
    EngineSpec(nfe=4, order=2))
try:
    run(torch.ones(2, 8, device="cuda"))
except RuntimeError as err:
    assert "capture failed" in str(err), err
    assert calls == [False, True], calls   # the warm-up row, the capture
    print("raised")
"""


@pytest.mark.gpu
def test_card_failed_capture_raises_and_never_runs_eager(cuda):
    """An eps-net that syncs the host cannot be captured: the run raises
    with the cause instead of falling back to the eager loop. In a process
    of its own: torch leaves its CUDA generator in capture mode after a
    failed capture."""
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", FAILED_CAPTURE],
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": str(src)})
    assert out.stdout.strip() == "raised", out.stdout + out.stderr
