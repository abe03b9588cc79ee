"""The port's feature reuse (DESIGN.md §12) against the JAX reference's
(`tests/test_cache.py` mirrored).

* `dit_apply_cached` against the reference's at fp32 (<= 1e-5 relative)
  with reuse 0, 1 and mixed, its new cache included;
* with every step full the cached path is BITWISE the port's own uncached
  one: `dit_apply`, the engine's `build` and a step program's
  `step_flight`; skipping the deep blocks (`deep=False`) changes nothing
  when every sample reuses;
* the `cache_block` bounds and the spec / engine / bank handshakes raise
  as the reference's do;
* host tables bit-equal to the reference's: `eval_cost_rows`, and
  `SolverPlan.compile` / `eval_cost` / its JSON round trip;
* serving: a reused slot does not leak its cache, a staggered cached bank
  matches the uniform cached runs and the reference's scheduler, and the
  eval-cost accounting agrees everywhere.

Every output check perturbs the params: adaLN-zero makes an unperturbed
block an identity, and shallow == full would hold vacuously.
"""

import json
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.core.coeffs import eval_cost_rows as j_eval_cost_rows
from repro.diffusion import VPLinear as JVP
from repro.engine import EngineSpec as JSpec
from repro.launch.sample import build_engine as j_build_engine
from repro.models import dit as j_dit
from repro.tuning import SolverPlan as JPlan
from repro_torch import serving as tsv
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.coeffs import eval_cost_rows
from repro_torch.diffusion import VPLinear as TVP
from repro_torch.engine import CacheSpec
from repro_torch.engine import EngineSpec as TSpec
from repro_torch.launch.sample import build_engine as t_build_engine
from repro_torch.models import api as t_api
from repro_torch.models import dit as t_dit
from repro_torch.tuning import SolverPlan, load_bank, save_bank

from test_torch_serving import (assert_same_serving, perturbed_tree,
                                serve_both)

torch.set_num_threads(2)

TOL = 1e-5


def classless(seed=0):
    """(t_cfg, t_params, j_params): a reduced dit-cifar without class
    embeddings (baked per-slot class ids become no-ops), every float leaf
    perturbed, the same values in both frameworks."""
    j_cfg = j_get_config("dit-cifar").reduced()
    tree = {"backbone": jax.tree.map(np.asarray, j_dit.init_dit(
        j_cfg, jax.random.PRNGKey(seed), num_classes=0))}
    rng = np.random.default_rng(seed + 1)
    tree = jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(a.dtype),
        tree)
    t_cfg = t_get_config("dit-cifar").reduced()
    return t_cfg, t_api.params_from_numpy(tree, t_cfg, "cpu"), tree


def t_engine_cached(cfg, params, batch=2, cache_block=1):
    return t_build_engine(cfg, params, TVP(), batch, 0,
                          cache_block=cache_block, device="cpu")


def cached_plan(nfe=4, order=2, k=1, plan=SolverPlan):
    """A full init and first body step, shallow everywhere after."""
    return replace(plan.default(nfe, order=order),
                   cache_depth=[0] + [k] * (nfe - 1))


@pytest.fixture(scope="module")
def pair():
    """(t_cfg, t_params, j_cfg, j_params) with classes, perturbed."""
    j_cfg = j_get_config("dit-cifar").reduced()
    tree = perturbed_tree(j_cfg)
    t_cfg = t_get_config("dit-cifar").reduced()
    return (t_cfg, t_api.params_from_numpy(tree, t_cfg, "cpu"), j_cfg,
            jax.tree.map(jnp.asarray, tree))


def _x(cfg, batch=2, seed=2):
    return np.random.default_rng(seed).normal(
        size=(batch, cfg.patch_tokens, cfg.latent_dim)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


# ---------------------------------------------------------------------------
# model level: the cache boundary itself
# ---------------------------------------------------------------------------


def test_dit_apply_cached_matches_reference(pair):
    """A full eval (reuse 0) fills the cache, a shallow one (reuse 1) at
    another x reuses it, a mixed batch does each per sample: outputs and
    caches within 1e-5 of the reference's."""
    t_cfg, tp, j_cfg, jp = pair
    tp, jp = tp["backbone"], jp["backbone"]
    t = np.full((2,), 0.4, np.float32)
    ids = np.array([3, 7], np.int32)
    C0 = np.zeros((2,) + t_dit.dit_cache_shape(t_cfg), np.float32)
    assert t_dit.dit_cache_shape(t_cfg) == j_dit.dit_cache_shape(j_cfg)

    def both(x, C, reuse):
        want = j_dit.dit_apply_cached(jp, j_cfg, jnp.asarray(x),
                                      jnp.asarray(t), jnp.asarray(ids),
                                      cache=jnp.asarray(C),
                                      reuse=jnp.asarray(reuse),
                                      cache_block=1)
        got = t_dit.dit_apply_cached(tp, t_cfg, torch.as_tensor(x),
                                     torch.as_tensor(t),
                                     torch.as_tensor(ids).long(),
                                     cache=torch.as_tensor(C),
                                     reuse=torch.as_tensor(reuse),
                                     cache_block=1)
        for g, w in zip(got, want):
            assert _rel(g.numpy(), w) <= TOL
        return got[1].numpy()

    C1 = both(_x(t_cfg, seed=2), C0, np.zeros(2, np.float32))
    assert np.abs(C1).max() > 0                 # the deep blocks did work
    both(_x(t_cfg, seed=3), C1, np.ones(2, np.float32))
    C2 = both(_x(t_cfg, seed=4), C1, np.array([0.0, 1.0], np.float32))
    np.testing.assert_array_equal(C2[1], C1[1])  # the shallow row keeps it


def test_full_eval_is_bitwise_dit_apply_and_deep_skip_is_exact(pair):
    """reuse 0: the cached eval IS dit_apply, bit for bit. reuse 1 for every
    sample: skipping the deep blocks (deep=False) gives the same bits as
    running them and selecting the cache."""
    t_cfg, tp, _, _ = pair
    tp = tp["backbone"]
    x, t = torch.as_tensor(_x(t_cfg)), torch.full((2,), 0.4)
    C0 = torch.zeros((2,) + t_dit.dit_cache_shape(t_cfg))
    out, C1 = t_dit.dit_apply_cached(tp, t_cfg, x, t, cache=C0,
                                     reuse=torch.zeros(2), cache_block=1)
    assert torch.equal(out, t_dit.dit_apply(tp, t_cfg, x, t))
    assert torch.equal(
        out, t_dit.dit_apply_cached(tp, t_cfg, x, t, cache=C0,
                                    cache_block=1)[0])   # reuse None = 0
    x2 = torch.as_tensor(_x(t_cfg, seed=5))
    deep = t_dit.dit_apply_cached(tp, t_cfg, x2, t, cache=C1,
                                  reuse=torch.ones(2), cache_block=1)
    skip = t_dit.dit_apply_cached(tp, t_cfg, x2, t, cache=C1,
                                  reuse=torch.ones(2), cache_block=1,
                                  deep=False)
    for a, b in zip(deep, skip):
        assert torch.equal(a, b)
    assert not torch.equal(deep[0], t_dit.dit_apply(tp, t_cfg, x2, t))


def test_cache_block_bounds_are_validated(pair):
    t_cfg, tp, _, _ = pair
    x = torch.as_tensor(_x(t_cfg))
    C = torch.zeros((2,) + t_dit.dit_cache_shape(t_cfg))
    for bad in (0, t_cfg.num_layers, 7):
        with pytest.raises(ValueError, match="cache_block"):
            t_dit.dit_apply_cached(tp["backbone"], t_cfg, x, 0.5, cache=C,
                                   cache_block=bad)


# ---------------------------------------------------------------------------
# engine level: parity, handshakes, accounting
# ---------------------------------------------------------------------------


def test_cached_engine_all_full_is_bitwise_the_uncached_engine(pair):
    """A cache-wired engine running a plain registry table, and one running
    a plan whose cache_depth is all zero, reproduce the uncached engine's
    build() bit for bit; and so does a cached step program's step_flight
    tick by tick."""
    t_cfg, tp, _, _ = pair
    x_T = torch.as_tensor(_x(t_cfg))
    plain = t_build_engine(t_cfg, tp, TVP(), 2, 0, device="cpu")
    cached = t_engine_cached(t_cfg, tp)
    spec = TSpec(solver="unipc", nfe=5, order=2)
    cspec = replace(spec, cache_block=1)
    ref = plain.build(spec)(x_T)
    assert torch.equal(cached.build(cspec)(x_T), ref)
    plan = SolverPlan.default(5, order=2)
    plan0 = replace(plan, cache_depth=[0] * 5)
    ref_plan = plain.build(spec, table=plain.compile(
        spec, table=plan.compile(TVP())))(x_T)
    got_plan = cached.build(cspec, table=cached.compile(
        cspec, table=plan0.compile(TVP())))(x_T)
    assert torch.equal(got_plan, ref_plan)
    # the step program, through step_flight
    p_plain, p_cached = plain.build_step(spec), cached.build_step(cspec)
    runs = []
    for prog in (p_plain, p_cached):
        state = prog.init_state(2, tuple(x_T.shape[1:]))
        meta = prog.init_meta(2)
        state[0].copy_(x_T)
        meta.copy_(torch.tensor([[0, 0], [0, 0], [prog.n_rows] * 2, [1, 1]],
                                dtype=torch.int32))
        ticks = []
        for _ in range(prog.n_rows):
            state, meta, done = prog.step_flight(state, meta)
            ticks.append((state[0].clone(), done.clone()))
        runs.append(ticks)
    for (xa, da), (xb, db) in zip(*runs):
        assert torch.equal(xa, xb) and torch.equal(da, db)
    assert torch.equal(runs[0][-1][0], ref)


def test_cached_build_counts_full_and_shallow_evals_apart(pair):
    """Under a reuse plan the run counts the rows that run the whole
    network and the rows that reuse the cache apart, each a call as the
    step program's reuse column has them, but the last row (shallow here),
    which ends on its predictor."""
    t_cfg, tp, _, _ = pair
    cached = t_engine_cached(t_cfg, tp)
    cspec = TSpec(solver="unipc", nfe=4, order=2, cache_block=1)
    tab = cached.compile(cspec, table=cached_plan(4).compile(TVP()))
    run = cached.build(cspec, table=tab)
    x_T = torch.as_tensor(_x(t_cfg))
    for _ in range(2):
        run(x_T)
    reuse = cached.build_step(cspec, table=tab).row_reuse
    assert int(reuse.sum()) == 3 and len(reuse) == 5
    assert reuse[-1]
    assert (run.evals, run.shallow_evals) == (2 * 2, 2 * (3 - 1))
    assert run.elided_evals == 2


def test_cached_build_matches_reference_with_shallow_steps(pair):
    """A plan with shallow steps: finite, off the uncached run, and within
    1e-5 (relative) of the reference's cached build."""
    t_cfg, tp, j_cfg, jp = pair
    x_T = _x(t_cfg)
    spec = dict(solver="unipc", nfe=4, order=2, cache_block=1)
    cached = t_engine_cached(t_cfg, tp)
    tab = cached.compile(TSpec(**spec), table=cached_plan(4).compile(TVP()))
    got = cached.build(TSpec(**spec), table=tab)(torch.as_tensor(x_T))
    j_eng = j_build_engine(j_cfg, jp, JVP(), 2, 0, cache_block=1)
    want = j_eng.build(JSpec(**spec), table=j_eng.compile(
        JSpec(**spec), table=cached_plan(4, plan=JPlan).compile(JVP())))(
        jnp.asarray(x_T))
    assert _rel(got.numpy(), want) <= TOL
    plain = t_build_engine(t_cfg, tp, TVP(), 2, 0, device="cpu")
    ref = plain.build(TSpec(solver="unipc", nfe=4, order=2))(
        torch.as_tensor(x_T))
    assert torch.isfinite(got).all() and not torch.equal(got, ref)


def test_spec_engine_and_bank_handshakes(pair):
    t_cfg, tp, _, _ = pair
    with pytest.raises(ValueError, match="unconditional"):
        TSpec(solver="unipc", nfe=4, cache_block=1, cfg_scale=2.0).resolve()
    with pytest.raises(ValueError, match=">= 0"):
        TSpec(solver="unipc", nfe=4, cache_block=-1).resolve()
    with pytest.raises(ValueError, match="1..1"):
        t_build_engine(t_cfg, tp, TVP(), 2, 0,
                       cache_block=t_cfg.num_layers, device="cpu")
    plain = t_build_engine(t_cfg, tp, TVP(), 2, 0, device="cpu")
    with pytest.raises(ValueError, match="no .*cached eps-net"):
        plain.build(TSpec(solver="unipc", nfe=4, cache_block=1))
    cfg4 = replace(t_cfg, num_layers=4)
    wired = t_build_engine(cfg4, t_api.init_params(cfg4, 0, "cpu"), TVP(),
                           2, 0, cache_block=2, device="cpu")
    assert wired.cache_spec == CacheSpec(shape=(64, 128), block=2,
                                         n_blocks=4, dtype="float32")
    with pytest.raises(ValueError, match="wired for cache boundary 2"):
        wired.build(TSpec(solver="unipc", nfe=4, cache_block=1))
    # a cached plan's table on an uncached spec is refused, not served
    cached = t_engine_cached(t_cfg, tp)
    tab = cached.compile(TSpec(nfe=4, order=2, cache_block=1),
                         table=cached_plan(4).compile(TVP()))
    with pytest.raises(ValueError, match="silently paying full evals"):
        cached.build(TSpec(nfe=4, order=2), table=tab)
    with pytest.raises(ValueError, match="agree on cache_block"):
        cached.build_bank({"a": TSpec(solver="unipc", nfe=4, cache_block=1),
                           "b": TSpec(solver="unipc", nfe=4)})
    with pytest.raises(ValueError, match="carries a cached plan"):
        plain.build_bank({"a": TSpec(nfe=4, order=2)},
                         {"a": cached_plan(4).compile(TVP())})


# ---------------------------------------------------------------------------
# host tables, bit-equal to the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cache_block,n_blocks", [(0, 2), (1, 2), (7, 28)])
def test_eval_cost_rows_bit_equal_to_reference(cache_block, n_blocks):
    rows = {"t": np.zeros(6),
            "mc_cache_reuse": np.array([0.0, 0.0, 1.0, 1.0, 0.0, 1.0])}
    got = eval_cost_rows(rows, cache_block=cache_block, n_blocks=n_blocks)
    want = j_eval_cost_rows(rows, cache_block=cache_block, n_blocks=n_blocks)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        eval_cost_rows({"t": np.zeros(3)}, cache_block=1, n_blocks=2),
        np.ones(3))


def _tables_equal(a, b):
    for f in ("timesteps", "lambdas", "w_pred", "w_corr_prev", "w_corr_new",
              "base_x", "base_m0", "use_corrector", "out_scale"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
    assert a.sign == b.sign and a.prediction == b.prediction
    assert sorted(a.model_cols or {}) == sorted(b.model_cols or {})
    for k in a.model_cols or {}:
        np.testing.assert_array_equal(a.model_cols[k], b.model_cols[k])


@pytest.mark.parametrize("kw", [
    dict(nfe=4, order=2, cache_depth=[0, 1, 1, 0]),
    dict(nfe=6, order=3, cache_depth=[0, 14, 14, 0, 14, 14]),
    dict(nfe=5, order=3, variant="bh1", use_corrector=False),
    dict(nfe=8, order=2, prediction="noise", cache_depth=[0] * 8)])
def test_solver_plan_tables_cost_and_json_bit_equal_to_reference(kw,
                                                                 tmp_path):
    depth = kw.pop("cache_depth", None)
    plan = replace(SolverPlan.default(**kw), cache_depth=depth)
    ref = replace(JPlan.default(**kw), cache_depth=depth)
    assert plan.to_dict() == ref.to_dict()
    _tables_equal(plan.compile(TVP()), ref.compile(JVP()))
    for n_blocks in (2, 28):
        assert plan.eval_cost(n_blocks) == ref.eval_cost(n_blocks)
    assert plan.cache_block == ref.cache_block
    path = str(tmp_path / "p.json")
    plan.save(path)
    loaded, j_loaded = SolverPlan.load(path), JPlan.load(path)
    assert loaded.to_dict() == plan.to_dict() == j_loaded.to_dict()
    _tables_equal(loaded.compile(TVP()), j_loaded.compile(JVP()))
    bank = str(tmp_path / "bank.json")
    save_bank(bank, {"a": plan, "b": SolverPlan.default(3)})
    assert {k: p.to_dict() for k, p in load_bank(bank).items()} == \
        json.load(open(bank))["tiers"]


def test_plan_cache_depth_validation_and_reuse_column():
    good = SolverPlan.default(4)
    with pytest.raises(ValueError, match="cache_depth"):
        replace(good, cache_depth=[1, 0])
    with pytest.raises(ValueError, match=">= 0"):
        replace(good, cache_depth=[0, -1, 0, 0])
    with pytest.raises(ValueError, match="share one k"):
        replace(good, cache_depth=[1, 2, 0, 0])
    with pytest.raises(ValueError, match="not a plan bank"):
        import tempfile
        with tempfile.NamedTemporaryFile("w", suffix=".json") as f:
            good.save(f.name)
            load_bank(f.name)
    plan = replace(good, cache_depth=[0, 1, 1, 0])
    assert plan.cache_block == 1 and good.cache_block == 0
    np.testing.assert_array_equal(plan.compile(TVP()).model_cols[
        "cache_reuse"], [0.0, 0.0, 1.0, 1.0, 0.0])


def test_eval_cost_accounting_agrees_everywhere(pair):
    """plan.eval_cost == eval_cost_rows sum == program.span_cost ==
    tier_eval_cost, strictly below the NFE floor with shallow steps."""
    t_cfg, tp, _, _ = pair
    plan = cached_plan(4, k=1)                  # 3 shallow of 5 evals
    want = 5 - 3 * (1 - 1 / t_cfg.num_layers)   # 3.5 at k=1, L=2
    assert plan.eval_cost(t_cfg.num_layers) == pytest.approx(want)
    engine = t_engine_cached(t_cfg, tp)
    spec = TSpec(solver="unipc", nfe=4, order=2, cache_block=1)
    program = engine.build_step(spec, table=engine.compile(
        spec, table=plan.compile(TVP())))
    assert program.span_cost(0, program.n_rows) == pytest.approx(want)
    assert program.tier_eval_cost(None) == pytest.approx(want)
    assert program.cache is not None and program.cache.block == 1
    np.testing.assert_array_equal(program.row_reuse,
                                  [False, False, True, True, True])


# ---------------------------------------------------------------------------
# serving level: cached programs through the scheduler
# ---------------------------------------------------------------------------


def test_slot_reuse_does_not_leak_cache_between_requests(pair):
    """A request admitted into a slot a previous request just left sees a
    zeroed cache: the same latent as served alone."""
    t_cfg, tp, _, _ = pair
    engine = t_engine_cached(t_cfg, tp, batch=1)
    spec = TSpec(solver="unipc", nfe=3, order=2, cache_block=1)
    tab = engine.compile(spec, table=cached_plan(3).compile(TVP()))
    sample = (t_cfg.patch_tokens, t_cfg.latent_dim)

    def serve(reqs):
        sched = tsv.SlotScheduler(engine.build_step(spec, table=tab), 1,
                                  sample)
        tsv.run_trace(sched, reqs)
        assert sched.shallow_ticks > 0
        return {c.rid: c.latent for c in sched.completions}

    probe = _x(t_cfg, 1, 9)[0]
    solo = serve([tsv.Request(rid=1, x_T=probe)])
    behind = serve([tsv.Request(rid=0, x_T=_x(t_cfg, 1, 8)[0]),
                    tsv.Request(rid=1, x_T=probe, arrival=4.0)])
    np.testing.assert_array_equal(solo[1], behind[1])


def test_staggered_cached_bank_matches_uniform_runs_and_reference():
    """A bank of a cached plan and an uncached tier, served staggered from
    one program: each request within 1e-5 (relative) of its tier's uniform
    cached run, the reference's scheduler matched (ticks, order, metrics,
    eval costs equal), and each completion's eval_cost its plan's."""
    t_cfg, tp, jtree = classless()
    j_cfg = j_get_config("dit-cifar").reduced()
    engine = t_engine_cached(t_cfg, tp, batch=2)
    j_eng = j_build_engine(j_cfg, jax.tree.map(jnp.asarray, jtree), JVP(),
                           2, 0, cache_block=1)
    plans = {"fast": cached_plan(3), "quality": SolverPlan.default(5,
                                                                   order=2)}
    j_plans = {"fast": cached_plan(3, plan=JPlan),
               "quality": JPlan.default(5, order=2)}
    specs = {n: dict(solver="unipc", nfe=p.nfe, order=max(p.orders),
                     cache_block=1) for n, p in plans.items()}
    tables = {n: p.compile(TVP()) for n, p in plans.items()}
    program = engine.build_bank({n: TSpec(**s) for n, s in specs.items()},
                                tables)
    j_program = j_eng.build_bank(
        {n: JSpec(**s) for n, s in specs.items()},
        {n: p.compile(JVP()) for n, p in j_plans.items()})
    x_T = {r: _x(t_cfg, 1, 10 + r)[0] for r in range(4)}
    names = ["fast", "quality", "fast", "quality"]
    sample = (t_cfg.patch_tokens, t_cfg.latent_dim)

    def reqs(pkg):
        return [pkg.Request(rid=r, arrival=float(a), x_T=x_T[r],
                            tier=names[r])
                for r, a in zip(range(4), [0, 0, 2, 5])]

    j, t = serve_both(j_program, program, reqs, slots=2, sample_shape=sample)
    assert_same_serving(j, t, rel=True)
    got = {c.rid: c for c in t[0].completions}
    for r, name in enumerate(names):
        spec = TSpec(**specs[name])
        ref = engine.build(spec, table=engine.compile(
            spec, table=tables[name]))(torch.as_tensor(x_T[r])[None])[0]
        assert _rel(got[r].latent, ref.numpy()) <= TOL
        assert got[r].eval_cost == pytest.approx(
            plans[name].eval_cost(t_cfg.num_layers))
    assert got[0].eval_cost < got[0].evals
    assert got[1].eval_cost == got[1].evals
