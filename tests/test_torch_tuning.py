"""The port's solver-plan tuner against the JAX reference's
(`tests/test_tuning.py` mirrored), and the rest of `core/phi.py`.

* `phi_vec`, `g_vec` and the six closed forms bit-equal to the reference's
  on a grid of h covering the series regime (|h| < 0.5) and the recursive
  one;
* the objective: scores of a fixed list of plans, uncached and cached,
  within 1e-5 relative of the reference's on the analytic Gaussian DPM and
  on a reduced dit-cifar (perturbed params); one runner serves every
  candidate, its table buffers built once per NFE; cfg and thresholding
  refused;
* the search: driven by one shared float64 host objective (a deterministic
  function of the compiled table), `tune_plan` and `tune_cached_plan` walk
  identically in both packages (plan JSON, evals, history), and the memo
  never rescans a table; on the port's own objective a tuned plan beats
  the UniPC-2 baseline and never regresses;
* the launchers: `quant_parity_gate`, `tune` / `tune --smoke` with
  `train_steps=0` on the CPU, and `--train-steps N` training first (the
  refusal this test once pinned went when training was ported),
  `sample(plan=)` uncached and cached within 1e-5 of the reference's, and
  `--plan` with `--loop` refused;
* on the card (`gpu`): the runner captures once per NFE (twice cached),
  and its terminal states are bit-equal to `engine.build` replays.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.core import phi as j_phi
from repro.diffusion import VPLinear as JVP
from repro.engine import EngineSpec as JSpec
from repro.engine import SamplerEngine as JEngine
from repro.launch import sample as j_sample
from repro.launch.sample import build_engine as j_build_engine
from repro.tuning import SearchConfig as JSearch
from repro.tuning import SolverPlan as JPlan
from repro.tuning import make_objective as j_make_objective
from repro.tuning import tune_cached_plan as j_tune_cached
from repro.tuning import tune_plan as j_tune_plan
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import phi as t_phi
from repro_torch.diffusion import VPLinear as TVP
from repro_torch.engine import EngineSpec as TSpec
from repro_torch.engine import SamplerEngine as TEngine
from repro_torch.launch import sample as t_sample
from repro_torch.launch import train as t_train
from repro_torch.launch import tune as t_tune
from repro_torch.launch.sample import build_engine as t_build_engine
from repro_torch.models import api as t_api
from repro_torch.tuning import (QuantParityError, SearchConfig, SolverPlan,
                                make_objective, quant_parity_gate,
                                tune_cached_plan, tune_plan)
from test_torch_serving import _j_eps, _t_eps, perturbed_tree

torch.set_num_threads(2)

TOL = 1e-5                      # fp32 paths (tests/test_engine.py)


# ---------------------------------------------------------------------------
# core/phi.py: phi_vec, g_vec and the closed forms
# ---------------------------------------------------------------------------

H = np.concatenate([np.linspace(-3.0, 3.0, 121),
                    [-0.5, 0.5, -0.4999999, 0.4999999, 1e-8, -1e-8, 1e-4,
                     -1e-4, 7.5, -7.5]])
CLOSED = ("varphi1_closed", "varphi2_closed", "varphi3_closed",
          "psi1_closed", "psi2_closed", "psi3_closed")


@pytest.mark.parametrize("name", ["phi_vec", "g_vec"])
@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_phi_and_g_vectors_are_bit_equal(name, p):
    got = getattr(t_phi, name)(p, H)
    assert got.shape == (p,) + H.shape
    np.testing.assert_array_equal(got, getattr(j_phi, name)(p, H))
    np.testing.assert_array_equal(getattr(t_phi, name)(p, 0.3),
                                  getattr(j_phi, name)(p, 0.3))


@pytest.mark.parametrize("name", CLOSED)
def test_closed_forms_are_bit_equal(name):
    h = H[H != 0.0]
    np.testing.assert_array_equal(getattr(t_phi, name)(h),
                                  getattr(j_phi, name)(h))


def test_phi_vectors_agree_with_the_closed_forms():
    """`tests/test_phi_coeffs.py`'s expectations on the port: away from
    small h (where the closed forms cancel) phi_n = h^n n! varphi_{n+1}."""
    h = np.array([-2.0, -1.0, -0.7, 0.7, 1.0, 2.0])
    phi = t_phi.phi_vec(2, h)
    np.testing.assert_allclose(phi[0], h * t_phi.varphi2_closed(h),
                               rtol=1e-12)
    np.testing.assert_allclose(phi[1], 2 * h**2 * t_phi.varphi3_closed(h),
                               rtol=1e-10)
    g = t_phi.g_vec(2, h)
    np.testing.assert_allclose(g[0], h * t_phi.psi2_closed(h), rtol=1e-12)
    np.testing.assert_allclose(g[1], 2 * h**2 * t_phi.psi3_closed(h),
                               rtol=1e-10)
    np.testing.assert_allclose(t_phi.varphi(1, h), t_phi.varphi1_closed(h),
                               rtol=1e-12)
    np.testing.assert_allclose(t_phi.psi(1, h), t_phi.psi1_closed(h),
                               rtol=1e-12)


# ---------------------------------------------------------------------------
# the objective against the reference's
# ---------------------------------------------------------------------------


def _gauss_pair(gaussian_dpm, nfe=6, order=2, batch=4, ref_nfe=48, seed=0):
    mu, s = gaussian_dpm.mu, gaussian_dpm.s
    x = np.random.default_rng(seed).normal(size=(batch, 8)).astype(
        np.float32)
    jobj = j_make_objective(JEngine(JVP(), eps=_j_eps(mu, s)),
                            JSpec(solver="unipc", nfe=nfe, order=order), x,
                            ref_nfe=ref_nfe)
    tobj = make_objective(TEngine(TVP(), eps=_t_eps(mu, s), device="cpu"),
                          TSpec(solver="unipc", nfe=nfe, order=order), x,
                          ref_nfe=ref_nfe)
    return jobj, tobj


def _plans(Plan, nfe, cache=None):
    """A fixed list of candidates: the defaults of three orders and three
    single-coordinate moves (a knot, the corrector, a B(h) variant)."""
    base = Plan.default(nfe, order=2)
    knots = list(base.knots)
    knots[1] = 0.5 * (knots[0] + knots[1])
    corr = list(base.corrector)
    corr[1] = False
    var = list(base.variants)
    var[0] = "bh1"
    out = [Plan.default(nfe, order=o) for o in (1, 2, 3)] + [
        dataclasses.replace(base, knots=knots),
        dataclasses.replace(base, corrector=corr),
        dataclasses.replace(base, variants=var)]
    if cache is not None:
        out = [dataclasses.replace(p, cache_depth=list(c))
               for p in out for c in cache]
    return out


def _assert_scores(jobj, tobj, jplans, tplans, sched_j, sched_t):
    """Each score within 1e-5 relative of the reference's. A score is
    ||x0 - x_ref|| / ||x_ref||, and fp32 rounding moves x0 by 1e-7 to 2e-7
    of |x_ref| in either framework (measured on the Gaussian), so the
    difference of two scores has that floor whatever their size: a plan
    landing within 0.1 of the reference is held to 1e-6 absolute, five
    times the floor, instead of 1e-5 of its own score."""
    for jp, tp in zip(jplans, tplans):
        want, got = jobj(jp, sched_j), tobj(tp, sched_t)
        assert abs(got - want) <= max(TOL * want, 1e-6), (tp, got, want)


def test_gaussian_objective_scores_match_the_reference(gaussian_dpm):
    jobj, tobj = _gauss_pair(gaussian_dpm)
    np.testing.assert_allclose(tobj.x_ref, jobj.x_ref, rtol=0, atol=1e-6)
    _assert_scores(jobj, tobj, _plans(JPlan, 6), _plans(SolverPlan, 6),
                   JVP(), TVP())
    big = [tobj(p, TVP()) for p in _plans(SolverPlan, 6)]
    assert sum(d > 1e-2 for d in big) >= 3    # the relative bound bites


@pytest.fixture(scope="module")
def dit():
    j_cfg = j_get_config("dit-cifar").reduced()
    t_cfg = t_get_config("dit-cifar").reduced()
    tree = perturbed_tree(j_cfg)
    return j_cfg, tree, t_cfg, t_api.params_from_numpy(tree, t_cfg, "cpu")


def _dit_pair(dit, cache_block=0, nfe=4, batch=2, ref_nfe=12):
    j_cfg, tree, t_cfg, t_params = dit
    jeng = j_build_engine(j_cfg, jax.tree.map(jnp.asarray, tree), JVP(),
                          batch, 0, cache_block=cache_block)
    teng = t_build_engine(t_cfg, t_params, TVP(), batch, 0,
                          cache_block=cache_block, device="cpu")
    x = np.random.default_rng(7).normal(
        size=(batch, t_cfg.patch_tokens, t_cfg.latent_dim)).astype(
            np.float32)
    kw = dict(solver="unipc", nfe=nfe, order=2, cache_block=cache_block)
    jobj = j_make_objective(jeng, JSpec(**kw), x, ref_nfe=ref_nfe)
    tobj = make_objective(teng, TSpec(**kw), x, ref_nfe=ref_nfe)
    return jobj, tobj, teng


def test_dit_objective_scores_match_the_reference(dit):
    jobj, tobj, _ = _dit_pair(dit)
    np.testing.assert_allclose(tobj.x_ref, jobj.x_ref, rtol=TOL,
                               atol=TOL * np.abs(jobj.x_ref).max())
    _assert_scores(jobj, tobj, _plans(JPlan, 4), _plans(SolverPlan, 4),
                   JVP(), TVP())
    assert tobj._runner.builds == 1 and tobj.evals == 6


def test_cached_dit_objective_scores_match_the_reference(dit):
    """The cached runner (cache_block 1 of 2): every plan with an all-full
    column and two reuse schedules, rows stepped with or without the deep
    block as each candidate's column says."""
    jobj, tobj, _ = _dit_pair(dit, cache_block=1)
    cache = ([0, 0, 0, 0], [0, 1, 0, 1], [0, 1, 1, 0])
    jplans, tplans = _plans(JPlan, 4, cache), _plans(SolverPlan, 4, cache)
    _assert_scores(jobj, tobj, jplans, tplans, JVP(), TVP())
    assert tobj.cached and tobj._runner.builds == 1
    # a reuse step moves the score; an all-full column is the uncached run
    d_full, d_reuse = tobj(tplans[0], TVP()), tobj(tplans[1], TVP())
    assert d_full != d_reuse
    _, plain, _ = _dit_pair(dit)
    assert plain(SolverPlan.default(4, order=1), TVP()) == d_full


def test_objective_uses_one_runner_across_candidates(gaussian_dpm):
    """Candidate scoring never builds a second runner: ONE runner holds a
    table's buffers per shape, so same-NFE candidates share them (the
    reference's jit cache keys on row shapes the same way)."""
    _, obj = _gauss_pair(gaussian_dpm)
    obj(SolverPlan.default(6, order=2), TVP())
    runner = obj._runner
    obj(SolverPlan.default(6, order=3), TVP())
    obj(SolverPlan.default(6, order=1), TVP())
    obj(SolverPlan.default(7, order=2), TVP())   # new NFE: new buffers
    assert obj._runner is runner
    assert runner.builds == 2
    assert runner.captures == 0                   # the CPU captures nothing


def test_make_objective_rejects_guidance_and_thresholding(gaussian_dpm):
    eng = TEngine(TVP(), eps=_t_eps(0.7, 0.35), device="cpu")
    x = np.zeros((2, 8), np.float32)
    for kw in ({"cfg_scale": 2.0}, {"thresholding": True}):
        with pytest.raises(ValueError, match="unconditional"):
            make_objective(eng, TSpec(solver="unipc", nfe=4, **kw), x,
                           ref_nfe=8)


def test_objective_rejects_mismatched_prediction(gaussian_dpm):
    _, obj = _gauss_pair(gaussian_dpm)
    with pytest.raises(ValueError, match="prediction"):
        obj(SolverPlan.default(6, prediction="noise"), TVP())


# ---------------------------------------------------------------------------
# the search: identical walks under one shared host objective
# ---------------------------------------------------------------------------

_COLS = ("base_x", "base_m0", "w_pred", "w_corr_prev", "w_corr_new",
         "use_corrector", "out_scale", "lambdas")


class HostObjective:
    """A deterministic float64 function of the compiled table: its squared
    distance to a fixed target plan's table, plus a cost on each reuse
    step. Either package's plans and schedule go in; both compile the same
    table bit for bit, so the searches must walk alike."""

    prediction = "data"

    def __init__(self, Plan, cached=False):
        self.cached = cached
        self.evals = 0
        target = Plan.default(6, order=3)
        knots = list(target.knots)
        knots[0] = 0.6 * knots[0]
        corr = list(target.corrector)
        corr[2] = False
        self.target = dataclasses.replace(target, knots=knots,
                                          corrector=corr)

    def __call__(self, plan, sched) -> float:
        self.evals += 1
        tab, want = plan.compile(sched), self.target.compile(sched)
        d = sum(float(np.sum((np.asarray(getattr(tab, c), np.float64)
                              - np.asarray(getattr(want, c), np.float64))
                             ** 2)) for c in _COLS)
        reuse = np.asarray((tab.model_cols or {}).get(
            "cache_reuse", np.zeros(1)), np.float64)
        return d + 1e-3 * float(np.sum(reuse * np.arange(1, reuse.size + 1)))


@pytest.mark.parametrize("budget,beam,rounds", [(30, 2, 2), (60, 3, 3),
                                                (12, 1, 1)])
def test_search_walks_like_the_reference(budget, beam, rounds):
    jobj, tobj = HostObjective(JPlan), HostObjective(SolverPlan)
    jres = j_tune_plan(jobj, JVP(), JPlan.default(6, order=2),
                       JSearch(budget=budget, beam=beam, rounds=rounds))
    tres = tune_plan(tobj, TVP(), SolverPlan.default(6, order=2),
                     SearchConfig(budget=budget, beam=beam, rounds=rounds))
    assert json.dumps(tres.plan.to_dict()) == json.dumps(jres.plan.to_dict())
    assert (tres.score, tres.baseline, tres.evals, tres.history) == (
        jres.score, jres.baseline, jres.evals, jres.history)
    assert tres.score < tres.baseline and len(tres.history) > 1
    assert tobj.evals == tres.evals <= budget      # the memo: no rescans


def test_cached_search_walks_like_the_reference():
    jobj, tobj = HostObjective(JPlan, True), HostObjective(SolverPlan, True)
    kw = dict(cache_block=2, slack=1.5)
    jres = j_tune_cached(jobj, JVP(), JPlan.default(6, order=2),
                         JSearch(budget=20, beam=2, rounds=1), **kw)
    tres = tune_cached_plan(tobj, TVP(), SolverPlan.default(6, order=2),
                            SearchConfig(budget=20, beam=2, rounds=1), **kw)
    assert json.dumps(tres.plan.to_dict()) == json.dumps(jres.plan.to_dict())
    assert json.dumps(tres.uncached_plan.to_dict()) == json.dumps(
        jres.uncached_plan.to_dict())
    assert (tres.score, tres.uncached_score, tres.evals, tres.history) == (
        jres.score, jres.uncached_score, jres.evals, jres.history)
    assert any(tres.plan.cache_depth) and tres.plan.cache_block == 2
    with pytest.raises(ValueError, match="cache-wired"):
        tune_cached_plan(HostObjective(SolverPlan), TVP(),
                         SolverPlan.default(6), cache_block=2)
    with pytest.raises(ValueError, match="cache_block >= 1"):
        tune_cached_plan(tobj, TVP(), SolverPlan.default(6), cache_block=0)


def test_search_memo_never_rescans_identical_tables(gaussian_dpm):
    """Re-proposed candidates (same lowered table) are memo hits: the
    objective runs at most once per distinct table, so reported evals ==
    unique candidates scored."""
    _, obj = _gauss_pair(gaussian_dpm, nfe=5)
    res = tune_plan(obj, TVP(), SolverPlan.default(5, order=2),
                    SearchConfig(budget=60, beam=2, rounds=3))
    assert obj.evals == res.evals


def test_tuned_plan_strictly_beats_unipc2_baseline(gaussian_dpm):
    """The tuner's reason to exist, on the port's own objective: at a tight
    budget the searched plan's discrepancy is strictly below the hand-set
    UniPC-2 table's."""
    _, obj = _gauss_pair(gaussian_dpm, nfe=6, order=2)
    init = SolverPlan.from_spec(TSpec(solver="unipc", nfe=6, order=2))
    res = tune_plan(obj, TVP(), init, SearchConfig(budget=40, beam=2,
                                                   rounds=2))
    assert res.baseline == pytest.approx(obj(init, TVP()))
    assert res.score < res.baseline
    assert res.plan.meta["objective"] == res.score
    assert res.evals <= 40 + 1


def test_search_never_regresses_and_respects_budget(gaussian_dpm):
    """Even when nearly nothing improves (a Gaussian at high NFE is already
    at reference accuracy), the winner is never worse than the init and the
    eval budget is honored."""
    _, obj = _gauss_pair(gaussian_dpm, nfe=16, order=3, batch=2,
                         ref_nfe=48, seed=1)
    res = tune_plan(obj, TVP(), SolverPlan.default(16, order=3),
                    SearchConfig(budget=10, beam=1, rounds=1))
    assert res.score <= res.baseline
    assert res.evals <= 10


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


def test_quant_parity_gate_returns_the_ratio_and_refuses_past_the_slack():
    assert quant_parity_gate(0.3, 0.2, slack=1.5, quant="w8a16") == \
        pytest.approx(1.5)
    # a zero anchor is floored at 1e-12, as in the reference
    assert quant_parity_gate(1e-13, 0.0, slack=1.5, quant="w8a16") == \
        pytest.approx(0.1)
    with pytest.raises(QuantParityError, match="w4a16.*dit-cifar nfe=4"):
        quant_parity_gate(0.31, 0.2, slack=1.5, quant="w4a16",
                          context="dit-cifar nfe=4")


def test_tune_runs_on_the_cpu_and_refuses_training(monkeypatch):
    made, make = [], t_tune.make_objective
    monkeypatch.setattr(t_tune, "make_objective",
                        lambda *a, **k: made.append(make(*a, **k)) or made[-1])
    plan, rep = t_tune.tune("dit-cifar", nfe=4, budget=6, rounds=1,
                            ref_nfe=8, batch=2, train_steps=0, device="cpu")
    assert plan.nfe == 4 and rep["tuned"] <= rep["baseline"]
    assert rep["evals"] <= 6 and plan.meta["arch"] == "dit-cifar"
    json.dumps(rep)                      # the report is plain data
    assert len(made) == 1 and made[0]._runner.builds == 1
    # training is ported (ROADMAP item 10): --train-steps N trains first,
    # with the reference's arguments (src/repro/launch/tune.py:56-61)
    calls, train = [], t_train.train
    monkeypatch.setattr(t_train, "train",
                        lambda *a, **k: calls.append((a, k)) or train(*a, **k))
    plan = t_tune.main(["--nfe", "4", "--budget", "4", "--rounds", "1",
                        "--ref-nfe", "8", "--batch", "2", "--train-steps",
                        "3", "--device", "cpu"])
    assert plan.nfe == 4 and len(calls) == 1
    (arch,), kw = calls[0]
    assert arch == "dit-cifar" and kw["reduced"] and kw["steps"] == 3
    assert (kw["objective"], kw["batch"], kw["seq"], kw["lr"]) == (
        "diffusion", 8, 32, 1e-3)


def test_tune_smoke_bank_and_quant_cli_on_the_cpu(tmp_path, capsys):
    rep = t_tune.main(["--smoke", "--train-steps", "0", "--budget", "8",
                       "--device", "cpu"])
    assert rep["tuned"] <= rep["baseline"]
    assert "tuning smoke ok" in capsys.readouterr().out
    bank = tmp_path / "bank.json"
    plans = t_tune.main(["--bank", "fast=3,quality=5", "--budget", "4",
                         "--rounds", "1", "--ref-nfe", "8", "--batch", "2",
                         "--train-steps", "0", "--device", "cpu",
                         "--out", str(bank)])
    assert {k: p.nfe for k, p in plans.items()} == {"fast": 3, "quality": 5}
    assert "wrote bank" in capsys.readouterr().out
    q = t_tune.main(["--nfe", "3", "--budget", "3", "--rounds", "1",
                     "--ref-nfe", "6", "--batch", "2", "--train-steps", "0",
                     "--quant", "w8a16", "--quant-slack", "100",
                     "--device", "cpu", "--out", str(tmp_path / "q.json")])
    assert q.meta["quant"] == "w8a16" and q.meta["quant_ratio"] <= 100
    assert "parity gate passed" in capsys.readouterr().out


def _jax_x_T(cfg, batch, seed=0):
    return np.array(jax.random.normal(
        jax.random.PRNGKey(seed), (batch, cfg.patch_tokens, cfg.latent_dim),
        jnp.float32))


@pytest.mark.parametrize("cache_depth", [None, [0, 1, 0, 1, 0]])
def test_sample_with_a_plan_matches_the_reference(dit, tmp_path, cache_depth,
                                                  capsys):
    """`sample(plan=)` (a tuned plan's JSON; a cached one wires feature
    reuse at its block) within 1e-5 relative of the reference's on the same
    params, x_T and class ids."""
    j_cfg, tree, t_cfg, t_params = dit
    knots = list(SolverPlan.default(5, order=3).knots)
    knots[2] = 0.55
    kw = dict(knots=knots, orders=[1, 2, 3, 3, 2],
              corrector=[True, False, True, True, False],
              variants=["bh1", "bh2", "bh2", "bh1", "bh2"],
              cache_depth=cache_depth)
    tpath, jpath = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    SolverPlan(nfe=5, **kw).save(tpath)
    JPlan(nfe=5, **kw).save(jpath)
    want = j_sample.sample("dit-cifar", batch=2, plan=jpath,
                           params=jax.tree.map(jnp.asarray, tree))
    got = t_sample.sample("dit-cifar", batch=2, plan=tpath, params=t_params,
                          x_T=_jax_x_T(t_cfg, 2), device="cpu")
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL, err
    out = capsys.readouterr().out
    assert "[plan]" in out and ("cache_block=1" in out) == bool(cache_depth)


def test_plan_with_loop_is_refused(tmp_path):
    path = str(tmp_path / "p.json")
    SolverPlan.default(4).save(path)
    with pytest.raises(SystemExit):
        t_sample.main(["--plan", path, "--loop", "--device", "cpu"])
    with pytest.raises(ValueError, match="python-loop"):
        t_sample.sample("dit-cifar", plan=path, loop=True, device="cpu")


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the runner's tables replay in CUDA "
                    "graphs")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cache_block", [0, 1])
def test_card_runner_captures_once_per_nfe_and_matches_build(cuda, dit,
                                                             cache_block):
    """On the card a search's candidates replay the graphs of their NFE
    (one, or two cached), and three plans scored in a row leave terminal
    states bit-equal to `engine.build(spec, table=plan.compile(...))`."""
    from repro_torch.engine import graphs

    _, tree, cfg, _ = dit
    params = t_api.params_from_numpy(tree, cfg, cuda)
    eng = t_build_engine(cfg, params, TVP(), 2, cache_block=cache_block,
                         device=cuda)
    spec = TSpec(solver="unipc", nfe=4, order=2, cache_block=cache_block)
    x = torch.randn(2, cfg.patch_tokens, cfg.latent_dim, device=cuda)
    obj = make_objective(eng, spec, x, ref_nfe=8)
    cache = ([0, 1, 0, 1],) if cache_block else (None,)
    plans = [dataclasses.replace(p, cache_depth=c)
             for p in _plans(SolverPlan, 4)[:3] for c in cache]
    runner_out = []
    for p in plans:
        obj(p, eng.schedule)
        runner_out.append(obj._runner.last)
    assert obj._runner.captures == (2 if cache_block else 1)
    tune_plan(obj, eng.schedule, plans[0],
              SearchConfig(budget=8, beam=1, rounds=1))
    assert obj._runner.captures == (2 if cache_block else 1)
    for p, got in zip(plans, runner_out):
        tab = eng.compile(spec, table=p.compile(eng.schedule))
        want = eng.build(spec, table=tab)(x)
        with graphs.readback_sync(cuda):
            np.testing.assert_array_equal(got, want.cpu().numpy())
