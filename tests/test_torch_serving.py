"""The port's continuous-batching serving against the JAX reference's
(`tests/test_serving.py` mirrored, less its mesh tests, which the port has
no counterpart of).

* the port's `SlotScheduler` and the reference's on the same trace,
  requests and x_T: latents within 1e-5 (fp32), and the completion order,
  admit/finish ticks, per-request bookkeeping and the tick-denominated
  `ServeMetrics` fields EQUAL;
* staggered requests against the port's own uniform `build()` run
  (<= 1e-5), per-request guidance scales, schedules and thresholding, tiers
  and banks (tuned plans through `save_bank` / `load_bank`), gang mode,
  FIFO bursts, idle slots, the trace clock, class conditioning independent
  of the slot (a reduced dit-cifar, perturbed, through
  `params_from_numpy`);
* the framework-free pieces bit-equal: `poisson_requests`, trace files,
  the metrics registry and `serve_metrics_from_snapshot`;
* `launch.serve` on the CPU: its latents against uniform runs, its
  observability flags running, and what it does not port yet refused.

Helpers here are shared by the other `test_torch_*serving` / resilience /
cache files.
"""

import dataclasses
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as jsv
from repro.configs.registry import get_config as j_get_config
from repro.diffusion import VPLinear as JVP
from repro.engine import EngineSpec as JSpec
from repro.engine import SamplerEngine as JEngine
from repro.launch.sample import build_engine as j_build_engine
from repro.models import api as j_api
from repro.obs import metrics as j_obsm
from repro.serving import server as j_server
from repro_torch import serving as tsv
from repro_torch.configs import get_config as t_get_config
from repro_torch.diffusion import VPLinear as TVP
from repro_torch.engine import EngineSpec as TSpec
from repro_torch.engine import SamplerEngine as TEngine
from repro_torch.engine.specs import not_yet_ported
from repro_torch.launch import serve as t_serve
from repro_torch.launch.sample import NULL_CLASS_ID
from repro_torch.launch.sample import build_engine as t_build_engine
from repro_torch.models import api as t_api
from repro_torch.obs import metrics as t_obsm
from repro_torch.serving import server as t_server

torch.set_num_threads(2)

TOL = 1e-5                         # fp32 serving parity (tests/test_serving.py)
COND, UNCOND = (0.7, 0.35), (-0.4, 0.5)   # (mu, s) of the analytic data laws
D = 8                                      # sample width of the analytic runs


# ---------------------------------------------------------------------------
# shared helpers: the analytic eps-nets of both frameworks, and a runner of
# the same trace through both schedulers
# ---------------------------------------------------------------------------


def _x_T(rid, d=D):
    return np.random.default_rng(100 + rid).normal(size=(d,)).astype(
        np.float32)


def _gauss(mu, s, xp):
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
    return _gauss(mu, s, (jnp.asarray, jnp.exp, jnp.sqrt,
                          JVP().log_alpha_jax))


def _t_eps(mu, s, device="cpu"):
    return _gauss(mu, s, (lambda t: torch.as_tensor(t, device=device),
                          torch.exp, torch.sqrt, TVP().log_alpha_torch))


def _stacked(eps_c, eps_u, cat, split):
    def eps_stacked(xx, t, **_):
        x1, x2 = split(xx)
        t1, t2 = split(t) if np.ndim(t) == 1 else (t, t)
        return cat([eps_c(x1, t1), eps_u(x2, t2)])
    return eps_stacked


def j_engine(cfg=False):
    ec, eu = _j_eps(*COND), _j_eps(*UNCOND)
    if not cfg:
        return JEngine(JVP(), eps=ec)
    return JEngine(JVP(), eps=ec, eps_stacked=_stacked(
        ec, eu, lambda a: jnp.concatenate(a, 0), lambda a: jnp.split(a, 2, 0)),
        eps_uncond=eu)


def t_engine(cfg=False, device="cpu"):
    ec, eu = _t_eps(*COND, device=device), _t_eps(*UNCOND, device=device)
    if not cfg:
        return TEngine(TVP(), eps=ec, device=device)
    return TEngine(TVP(), eps=ec, eps_stacked=_stacked(
        ec, eu, lambda a: torch.cat(a, 0), lambda a: torch.chunk(a, 2, 0)),
        eps_uncond=eu, device=device)


def tier_specs(Spec, **kw):
    return {"fast": Spec(solver="unipc", nfe=5, order=2, **kw),
            "balanced": Spec(solver="unipc", nfe=8, order=3, **kw),
            "quality": Spec(solver="unipc", nfe=12, order=3, **kw)}


def completion_key(c):
    return (c.rid, c.arrival, c.admit_tick, c.finish_tick, c.finish_clock,
            c.evals, c.tier, c.eval_cost, c.ok, c.retries, c.requeues,
            c.first_tier, c.fail_reason)


def metric_key(m):
    """Every tick-denominated (deterministic) field of ServeMetrics: the
    ones that must be EQUAL across frameworks and across depths."""
    return (m.mode, m.requests, m.completed, m.slots, m.n_rows, m.ticks,
            m.evals, m.makespan_ticks, m.throughput_per_tick,
            m.latency_ticks_p50, m.latency_ticks_p95, m.occupancy,
            m.evals_per_latent, m.per_tier, m.pipeline_depth, m.rejected,
            m.expired, m.degraded, m.retries, m.failed, m.recoveries,
            m.faults_injected)


def t_uniform(eng, spec, x, **kw):
    """The port's uniform build() run of one request."""
    return eng.build(spec, **kw)(torch.as_tensor(x)[None])[0].numpy()


def serve_both(j_prog, t_prog, make_reqs, slots, sample_shape=(D,),
               sched_kw=None, trace=True):
    """The same requests (`make_reqs(pkg)` builds them from a serving
    package) through the reference's and the port's scheduler; returns
    ((j_sched, j_metrics), (t_sched, t_metrics)). `sched_kw(pkg)` gives
    extra scheduler arguments built from each package's own classes."""
    out = []
    for pkg, prog in ((jsv, j_prog), (tsv, t_prog)):
        kw = sched_kw(pkg) if sched_kw else {}
        sched = pkg.SlotScheduler(prog, slots, sample_shape, **kw)
        m = pkg.run_trace(sched, make_reqs(pkg)) if trace else None
        out.append((sched, m))
    return out


def assert_same_serving(j, t, tol=TOL, rel=False):
    """Completion order, admit/finish ticks and bookkeeping equal, the
    metrics' tick-denominated fields equal, the event ledger and the
    rejections equal, latents within `tol` (absolute, or relative L-inf
    to the reference's latent with `rel`)."""
    (js, jm), (ts, tm) = j, t
    assert ([completion_key(c) for c in ts.completions]
            == [completion_key(c) for c in js.completions])
    for a, b in zip(js.completions, ts.completions):
        want, got = np.asarray(a.latent, np.float64), np.asarray(b.latent)
        if not np.isfinite(want).all():
            assert not np.isfinite(got).all(), f"rid={a.rid}"
            continue
        err = np.abs(got - want).max()
        if rel:
            err /= max(np.abs(want).max(), 1e-30)
        assert err <= tol, f"rid={a.rid}: {err:.3e} > {tol:g}"
    if jm is not None:
        assert metric_key(tm) == metric_key(jm)
    assert ts.events == js.events
    assert ([dataclasses.astuple(r) for r in ts.rejections]
            == [dataclasses.astuple(r) for r in js.rejections])


def requests(pkg, arrivals, *, scales=None, tiers=None, extras=None,
             **kw):
    return [pkg.Request(rid=i, arrival=float(a), x_T=_x_T(i),
                        cfg_scale=None if scales is None else scales[i],
                        tier=None if tiers is None else tiers[i],
                        extras=None if extras is None else extras[i], **kw)
            for i, a in enumerate(arrivals)]


# ---------------------------------------------------------------------------
# heterogeneous-batch parity (the acceptance criterion)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("solver,order", [
    ("unipc", 3), ("dpmpp", 2), ("deis", 3), ("pndm", 4), ("ddim", 1),
])
def test_staggered_requests_match_uniform_scan_and_reference(solver, order):
    """Six requests admitted at staggered ticks over three slots: each
    within 1e-5 of the port's uniform build() run, and the port's serving
    equal to the reference's (bookkeeping and metrics exactly, latents
    within 1e-5)."""
    kw = dict(solver=solver, order=order, nfe=8)
    teng = t_engine()
    arrivals = [0, 0, 2, 5, 7, 11]
    j, t = serve_both(j_engine().build_step(JSpec(**kw)),
                      teng.build_step(TSpec(**kw)),
                      lambda pkg: requests(pkg, arrivals), slots=3)
    assert_same_serving(j, t)
    ts = t[0]
    assert len(ts.completions) == 6 and ts.evals == ts.ticks
    assert all(c.evals == ts.program.n_rows for c in ts.completions)
    for c in ts.completions:
        np.testing.assert_allclose(
            c.latent, t_uniform(teng, TSpec(**kw), _x_T(c.rid)),
            atol=TOL, rtol=0, err_msg=f"rid={c.rid}")


def test_per_request_guidance_scales_match_uniform_scan():
    """Per-slot cfg: one program serves requests at different guidance
    scales; each matches a uniform run built at its scale."""
    kw = dict(solver="unipc", order=3, nfe=8, cfg_scale=2.0)
    teng = t_engine(cfg=True)
    scales = [1.0, 2.0, 3.5, 0.0, 2.0]
    j, t = serve_both(
        j_engine(cfg=True).build_step(JSpec(**kw)),
        teng.build_step(TSpec(**kw)),
        lambda pkg: requests(pkg, [0, 0, 1, 4, 6], scales=scales), slots=2)
    assert_same_serving(j, t)
    for c in t[0].completions:
        ref = t_uniform(teng, TSpec(**{**kw, "cfg_scale": scales[c.rid]}),
                        _x_T(c.rid))
        np.testing.assert_allclose(c.latent, ref, atol=TOL, rtol=0,
                                   err_msg=f"rid={c.rid}")


def test_per_request_cfg_with_schedule_and_thresholding():
    """Scheduled guidance + dynamic thresholding survive the per-slot path:
    the table contributes the schedule's profile, the slot its scale."""
    kw = dict(solver="unipc", order=2, nfe=8, cfg_scale=2.0,
              cfg_schedule="linear", cfg_scale_end=1.0, thresholding=True)
    teng = t_engine(cfg=True)
    j, t = serve_both(j_engine(cfg=True).build_step(JSpec(**kw)),
                      teng.build_step(TSpec(**kw)),
                      lambda pkg: requests(pkg, [0, 3], scales=[2.0, 2.0]),
                      slots=2)
    assert_same_serving(j, t)
    for c in t[0].completions:
        np.testing.assert_allclose(
            c.latent, t_uniform(teng, TSpec(**kw), _x_T(c.rid)),
            atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# scheduler mechanics
# ---------------------------------------------------------------------------


def test_scheduler_invariants_and_occupancy():
    kw = dict(solver="dpmpp", order=2, nfe=6)
    j, t = serve_both(
        j_engine().build_step(JSpec(**kw)), t_engine().build_step(
            TSpec(**kw)),
        lambda pkg: [replace(r, x_T=_x_T(r.rid)) for r in
                     pkg.poisson_requests(7, rate=0.6, seed=3)], slots=3)
    assert_same_serving(j, t)
    sched, m = t
    assert m.completed == 7 and m.evals == m.ticks
    assert 0.0 < m.occupancy <= 1.0
    assert m.evals_per_latent >= sched.program.n_rows / sched.slots
    assert all(c.evals == sched.program.n_rows for c in sched.completions)
    assert m.latency_ticks_p50 >= sched.program.n_rows


def test_gang_mode_admits_only_into_empty_batch():
    program = t_engine().build_step(TSpec(solver="ddim", order=1, nfe=4))
    sched = tsv.SlotScheduler(program, slots=2, sample_shape=(D,), gang=True)
    for r in range(3):
        sched.submit(tsv.Request(rid=r, x_T=_x_T(r)))
    sched.tick()
    assert sched.active == 2 and len(sched.queue) == 1
    sched.tick()                      # mid-flight ticks do not admit
    assert sched.active == 2 and len(sched.queue) == 1
    sched.drain()
    assert len(sched.completions) == 3


def test_continuous_beats_gang_at_2x_arrival_rate():
    """At 2x the slot-capacity arrival rate continuous batching finishes
    sooner and wastes fewer slot-evals per latent than gang serving, with
    the reference's numbers in both modes."""
    kw = dict(solver="unipc", order=3, nfe=8)
    slots = 4
    rate = 2.0 * slots / 9

    def run(gang):
        j, t = serve_both(
            j_engine().build_step(JSpec(**kw)),
            t_engine().build_step(TSpec(**kw)),
            lambda pkg: [replace(r, x_T=_x_T(r.rid)) for r in
                         pkg.poisson_requests(16, rate, seed=7)],
            slots=slots, sched_kw=lambda pkg: {"gang": gang})
        assert_same_serving(j, t)
        return t[1]

    cont, gang = run(False), run(True)
    assert cont.completed == gang.completed == 16
    assert cont.throughput_per_tick > gang.throughput_per_tick
    assert cont.evals_per_latent <= gang.evals_per_latent


def test_cfg_request_on_uncond_program_is_rejected():
    program = t_engine().build_step(TSpec(solver="unipc", order=2, nfe=4))
    sched = tsv.SlotScheduler(program, slots=2, sample_shape=(D,))
    with pytest.raises(ValueError, match="without guidance"):
        sched.submit(tsv.Request(rid=0, cfg_scale=3.0))
    with pytest.raises(ValueError, match="extras"):
        sched.submit(tsv.Request(rid=0, extras={"class_ids": 3}))
    sched.submit(tsv.Request(rid=1, cfg_scale=0.0, x_T=_x_T(1)))
    sched.drain()
    assert len(sched.completions) == 1


def test_latency_uses_trace_clock_across_idle_gaps():
    kw = dict(solver="unipc", order=2, nfe=4)
    j, t = serve_both(j_engine().build_step(JSpec(**kw)),
                      t_engine().build_step(TSpec(**kw)),
                      lambda pkg: requests(pkg, [0.0, 50.0]), slots=2)
    assert_same_serving(j, t)
    lats = {c.rid: c.latency_ticks for c in t[0].completions}
    assert lats == {0: t[0].program.n_rows, 1: t[0].program.n_rows}


def test_idle_slots_are_identity_and_poison_free():
    """Ticks with idle slots do not touch them (the init row is an identity
    update), and the busy slot still matches its uniform run."""
    teng = t_engine()
    spec = TSpec(solver="unipc", order=3, nfe=6)
    program = teng.build_step(spec)
    sched = tsv.SlotScheduler(program, slots=3, sample_shape=(D,))
    sched.submit(tsv.Request(rid=0, x_T=_x_T(0)))
    before = sched.state[0][1:].clone()
    for _ in range(program.n_rows):
        sched.tick()
    assert torch.equal(sched.state[0][1:], before)
    np.testing.assert_allclose(sched.completions[0].latent,
                               t_uniform(teng, spec, _x_T(0)),
                               atol=TOL, rtol=0)


def test_seeded_latents_come_from_a_cpu_generator():
    """A request without x_T draws from a CPU torch.Generator seeded with
    its seed: the same latent in every scheduler, on every device."""
    program = t_engine().build_step(TSpec(solver="unipc", order=2, nfe=3))
    sched = tsv.SlotScheduler(program, 2, (3, D))
    want = torch.randn((3, D), generator=torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(sched._draw(tsv.Request(rid=0, seed=7)),
                                  want.numpy())
    x = np.ones((3, D), np.float32)
    np.testing.assert_array_equal(
        sched._draw(tsv.Request(rid=0, seed=7, x_T=torch.as_tensor(x))), x)


# ---------------------------------------------------------------------------
# the DiT eps-net: class conditioning rides the request
# ---------------------------------------------------------------------------


def perturbed_tree(cfg, seed=0, scale=0.05):
    """The reference's init params as numpy, every float leaf perturbed
    (adaLN-zero makes an unperturbed DiT's output exactly zero)."""
    tree = jax.tree.map(np.asarray, j_api.init_params(
        cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(
        lambda a: (a + scale * rng.normal(size=a.shape)).astype(a.dtype)
        if np.issubdtype(a.dtype, np.floating) else a, tree)


@pytest.fixture(scope="module")
def dit_pair():
    """(j_cfg, j_tree, t_cfg, t_params): the reduced dit-cifar with the same
    perturbed params in both frameworks."""
    j_cfg = j_get_config("dit-cifar").reduced()
    t_cfg = t_get_config("dit-cifar").reduced()
    tree = perturbed_tree(j_cfg)
    return j_cfg, tree, t_cfg, t_api.params_from_numpy(tree, t_cfg, "cpu")


def _dit_x(cfg, rid):
    return np.random.default_rng(300 + rid).normal(
        size=(cfg.patch_tokens, cfg.latent_dim)).astype(np.float32)


def test_dit_serving_matches_reference_with_per_request_classes(dit_pair):
    """Guided dit serving, per-request class ids and scales, staggered:
    the port's scheduler against the reference's on the same trace and
    x_T (relative L-inf <= 1e-5), and each latent against the port's own
    uniform run."""
    j_cfg, tree, t_cfg, t_params = dit_pair
    kw = dict(solver="unipc", order=2, nfe=3, cfg_scale=2.0)
    jeng = j_build_engine(j_cfg, jax.tree.map(jnp.asarray, tree), JVP(), 2,
                          0, want_cfg=True, per_request_cond=True)
    teng = t_build_engine(t_cfg, t_params, TVP(), 2, 0,
                          per_request_cond=True, device="cpu")
    classes, scales = [3, 7, 7, 1], [1.5, 3.0, 2.0, 2.5]

    def reqs(pkg):
        return [pkg.Request(rid=i, arrival=float(a), x_T=_dit_x(t_cfg, i),
                            cfg_scale=scales[i],
                            extras={"class_ids": classes[i]})
                for i, a in enumerate([0, 1, 1, 4])]

    sample = (t_cfg.patch_tokens, t_cfg.latent_dim)
    j, t = serve_both(jeng.build_step(JSpec(**kw)),
                      teng.build_step(TSpec(**kw)), reqs, slots=2,
                      sample_shape=sample,
                      sched_kw=lambda pkg: {
                          "extras_init": {"class_ids": NULL_CLASS_ID}})
    assert_same_serving(j, t, rel=True)
    for c in t[0].completions:
        ref = teng.build(TSpec(**{**kw, "cfg_scale": scales[c.rid]}))(
            torch.as_tensor(_dit_x(t_cfg, c.rid))[None],
            class_ids=torch.tensor([classes[c.rid]]))[0].numpy()
        err = np.abs(c.latent - ref).max() / np.abs(ref).max()
        assert err <= TOL, f"rid={c.rid}: {err:.3e}"


def test_per_request_class_conditioning_is_slot_independent(dit_pair):
    """The same (seed, class, cfg-scale) request gives the same latent
    whichever slot admission lands it in."""
    _, _, t_cfg, t_params = dit_pair
    engine = t_build_engine(t_cfg, t_params, TVP(), 2, 0,
                            per_request_cond=True, device="cpu")
    program = engine.build_step(TSpec(solver="unipc", order=2, nfe=3,
                                      cfg_scale=2.0))

    def serve(reqs):
        sched = tsv.SlotScheduler(program, 2,
                                  (t_cfg.patch_tokens, t_cfg.latent_dim),
                                  extras_init={"class_ids": NULL_CLASS_ID})
        tsv.run_trace(sched, reqs)
        return {c.rid: c.latent for c in sched.completions}

    probe = dict(seed=42, cfg_scale=3.0, extras={"class_ids": 7})
    solo = serve([tsv.Request(rid=9, **probe)])                  # slot 0
    staggered = serve([tsv.Request(rid=0, seed=1, arrival=0.0,   # slot 1
                                   extras={"class_ids": 3}),
                       tsv.Request(rid=9, arrival=1.0, **probe)])
    np.testing.assert_array_equal(solo[9], staggered[9])


# ---------------------------------------------------------------------------
# plan banks: mixed-tier batches
# ---------------------------------------------------------------------------


def test_mixed_tier_batch_matches_per_tier_uniform_scans():
    teng = t_engine()
    tiers = tier_specs(TSpec)
    names = ["fast", "balanced", "quality", "quality", "fast", "balanced"]
    j, t = serve_both(j_engine().build_bank(tier_specs(JSpec)),
                      teng.build_bank(tiers),
                      lambda pkg: requests(pkg, [0, 0, 1, 3, 6, 9],
                                           tiers=names), slots=3)
    assert_same_serving(j, t)
    got = {c.rid: c for c in t[0].completions}
    assert len(got) == 6
    for r, name in enumerate(names):
        np.testing.assert_allclose(
            got[r].latent, t_uniform(teng, tiers[name], _x_T(r)),
            atol=TOL, rtol=0, err_msg=f"rid={r} tier={name}")
        assert got[r].evals == tiers[name].nfe + 1
        assert got[r].tier == name


def test_bank_with_per_request_guidance_scales():
    teng = t_engine(cfg=True)
    kw = dict(cfg_scale=2.0)
    tiers = {"fast": dict(solver="unipc", nfe=4, order=2, **kw),
             "quality": dict(solver="unipc", nfe=9, order=3, **kw)}
    cases = [("fast", 1.0), ("quality", 3.0), ("fast", 2.0)]
    j, t = serve_both(
        j_engine(cfg=True).build_bank({k: JSpec(**v)
                                       for k, v in tiers.items()}),
        teng.build_bank({k: TSpec(**v) for k, v in tiers.items()}),
        lambda pkg: requests(pkg, [0, 1, 2], tiers=[c[0] for c in cases],
                             scales=[c[1] for c in cases]), slots=2)
    assert_same_serving(j, t)
    for c in t[0].completions:
        tier, scale = cases[c.rid]
        ref = t_uniform(teng, TSpec(**{**tiers[tier], "cfg_scale": scale}),
                        _x_T(c.rid))
        np.testing.assert_allclose(c.latent, ref, atol=TOL, rtol=0)


def test_bank_from_tuned_plans_round_trips_through_serving(tmp_path):
    """save_bank -> load_bank -> build_bank(tables=plan tables) serves each
    tier as the plan's own uniform run, and the port's bank file loads in
    the reference (and back) to the same tables."""
    from repro.tuning import load_bank as j_load_bank
    from repro_torch.tuning import SolverPlan, load_bank, save_bank

    teng = t_engine()
    plans = {"fast": SolverPlan.default(4, order=2),
             "quality": SolverPlan.default(8, order=3)}
    path = str(tmp_path / "bank.json")
    save_bank(path, plans)
    loaded = load_bank(path)
    j_loaded = j_load_bank(path)
    specs = {k: dict(solver="unipc", nfe=p.nfe, order=max(p.orders))
             for k, p in loaded.items()}
    tables = {k: p.compile(TVP()) for k, p in loaded.items()}
    j_tables = {k: p.compile(JVP()) for k, p in j_loaded.items()}
    for k in tables:
        np.testing.assert_array_equal(tables[k].w_pred, j_tables[k].w_pred)
    j, t = serve_both(
        j_engine().build_bank({k: JSpec(**v) for k, v in specs.items()},
                              j_tables),
        teng.build_bank({k: TSpec(**v) for k, v in specs.items()}, tables),
        lambda pkg: requests(pkg, [0, 1], tiers=["fast", "quality"]),
        slots=2)
    assert_same_serving(j, t)
    for c in t[0].completions:
        np.testing.assert_allclose(
            c.latent, t_uniform(teng, TSpec(**specs[c.tier]), _x_T(c.rid),
                                table=tables[c.tier]), atol=TOL, rtol=0)


def test_tier_tags_are_validated():
    eng = t_engine()
    bank = eng.build_bank({"fast": TSpec(solver="unipc", nfe=4, order=2)})
    sched = tsv.SlotScheduler(bank, 2, (D,))
    with pytest.raises(ValueError, match="unknown tier"):
        sched.submit(tsv.Request(rid=0, tier="turbo"))
    with pytest.raises(ValueError, match="tag requests"):
        sched.submit(tsv.Request(rid=1))          # untagged on a bank
    single = eng.build_step(TSpec(solver="unipc", nfe=4, order=2))
    with pytest.raises(ValueError, match="single plan"):
        tsv.SlotScheduler(single, 2, (D,)).submit(
            tsv.Request(rid=2, tier="fast"))


def test_bank_rejects_mixed_prediction_and_guidance():
    with pytest.raises(ValueError, match="prediction"):
        t_engine().build_bank({"a": TSpec(solver="unipc", nfe=4),
                               "b": TSpec(solver="ddim", nfe=4,
                                          prediction="noise")})
    with pytest.raises(ValueError, match="guidance scale"):
        t_engine(cfg=True).build_bank(
            {"a": TSpec(solver="unipc", nfe=4, cfg_scale=2.0),
             "b": TSpec(solver="unipc", nfe=6, cfg_scale=3.0)})


def test_per_tier_metrics_reported():
    names = ["fast", "balanced", "quality"]
    j, t = serve_both(
        j_engine().build_bank(tier_specs(JSpec)),
        t_engine().build_bank(tier_specs(TSpec)),
        lambda pkg: [replace(r, x_T=_x_T(r.rid)) for r in
                     pkg.poisson_requests(9, rate=0.5, seed=5, tiers=names)],
        slots=3)
    assert_same_serving(j, t)
    m = t[1]
    assert m.completed == 9 and set(m.per_tier) == set(names)
    for name, spec in tier_specs(TSpec).items():
        assert m.per_tier[name]["completed"] == 3
        assert m.per_tier[name]["evals"] == spec.nfe + 1
        assert m.per_tier[name]["latency_ticks_p50"] >= spec.nfe + 1


# ---------------------------------------------------------------------------
# scheduler edge cases
# ---------------------------------------------------------------------------


def test_burst_arrivals_beyond_slots_serve_fifo():
    program = t_engine().build_step(TSpec(solver="unipc", order=2, nfe=4))
    sched = tsv.SlotScheduler(program, slots=2, sample_shape=(D,))
    for r in range(6):
        sched.submit(tsv.Request(rid=r, x_T=_x_T(r)))
    sched.tick()
    assert sched.active == 2 and len(sched.queue) == 4
    for _ in range(program.n_rows - 1):
        sched.tick()
    assert len(sched.completions) == 2 and len(sched.queue) == 4
    sched.tick()                      # freed slots refill on the NEXT tick
    assert sched.active == 2 and len(sched.queue) == 2
    sched.drain()
    assert [c.rid for c in sched.completions] == list(range(6))
    finishes = [c.finish_tick for c in sched.completions]
    assert finishes == sorted(finishes)


def test_nfe_budget_one_request_completes():
    teng = t_engine()
    spec = TSpec(solver="unipc", order=1, nfe=1)
    program = teng.build_step(spec)
    assert program.n_rows == 2
    sched = tsv.SlotScheduler(program, slots=2, sample_shape=(D,))
    m = tsv.run_trace(sched, [tsv.Request(rid=0, x_T=_x_T(0))])
    assert m.completed == 1 and m.ticks == 2
    c = sched.completions[0]
    assert c.evals == 2 and c.latency_ticks == 2
    np.testing.assert_allclose(c.latent, t_uniform(teng, spec, _x_T(0)),
                               atol=TOL, rtol=0)


def test_empty_trace_and_single_tier_metrics():
    j, t = serve_both(j_engine().build_bank(tier_specs(JSpec)),
                      t_engine().build_bank(tier_specs(TSpec)),
                      lambda pkg: [], slots=2)
    assert_same_serving(j, t)
    m0 = t[1]
    assert m0.completed == 0 and m0.ticks == 0 and m0.evals == 0
    assert m0.occupancy == 0.0 and m0.throughput_rps == 0.0
    assert m0.per_tier is None
    m1 = tsv.run_trace(t[0], requests(tsv, [0, 0], tiers=["fast", "fast"]))
    assert m1.completed == 2 and set(m1.per_tier) == {"fast"}
    assert m1.per_tier["fast"]["completed"] == 2


def test_trace_clock_resets_on_scheduler_reuse():
    program = t_engine().build_step(TSpec(solver="unipc", order=2, nfe=4))
    sched = tsv.SlotScheduler(program, slots=2, sample_shape=(D,))
    m1 = tsv.run_trace(sched, [tsv.Request(rid=0, x_T=_x_T(0), arrival=3.0)])
    assert sched.clock is None        # run_trace always restores tick time
    m2 = tsv.run_trace(sched, [tsv.Request(rid=1, x_T=_x_T(1), arrival=0.0)])
    assert m1.completed == m2.completed == 1
    assert m2.ticks == program.n_rows == m2.evals
    lat = {c.rid: c.latency_ticks for c in sched.completions}
    assert lat == {0: program.n_rows, 1: program.n_rows}


# ---------------------------------------------------------------------------
# the framework-free pieces, bit-equal to the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(n=12, rate=0.5, seed=3),
    dict(n=7, rate=2.0, seed=0, cfg_scales=[1.5, 2.0, 4.0], base_seed=10),
    dict(n=9, rate=0.3, seed=11, tiers=["fast", "quality"])])
def test_poisson_requests_and_trace_files_match_reference(kw, tmp_path):
    got = t_server.poisson_requests(**kw)
    want = j_server.poisson_requests(**kw)
    assert ([dataclasses.astuple(r) for r in got]
            == [dataclasses.astuple(r) for r in want])
    with pytest.raises(ValueError, match="rate"):
        t_server.poisson_requests(3, 0.0)
    got[0].extras, got[0].ttl = {"class_ids": 5}, 4.0
    path = str(tmp_path / "trace.json")
    t_server.save_trace(path, got)
    assert ([dataclasses.astuple(r) for r in t_server.load_trace(path)]
            == [dataclasses.astuple(r) for r in j_server.load_trace(path)]
            == [dataclasses.astuple(r) for r in got])


def _feed(reg):
    c = reg.counter("serve_ticks")
    h = reg.histogram("latency_ticks", (1, 2, 4, 8))
    tw = reg.histogram("tick_wall_s", (0.1, 1.0), wall=True)
    for v in (3, 1, 9, 4, 4):
        c.inc()
        h.observe(v)
        tw.observe(v / 10)
    reg.counter("serve_completed").inc(5)
    reg.counter("serve_submitted").inc(6)
    reg.counter("serve_evals").inc(5)
    reg.counter("serve_active_slot_ticks").inc(12)
    reg.counter("serve_rejected", {"reason": "expired"}).inc()
    reg.counter("host_phase_ns", {"phase": "admission"}, wall=True).inc(1000)
    reg.counter("tier_completed", {"tier": "fast"}).inc(5)
    reg.gauge("tier_evals", {"tier": "fast"}).set(6)
    reg.gauge("serve_wall_s", wall=True).set(0.5)
    reg.counter("serve_makespan_ticks").inc(12.0)


def test_metrics_registry_and_serve_metrics_match_reference():
    """The same observations give the same snapshot, delta, exposition,
    validation and derived ServeMetrics in both frameworks."""
    t_reg, j_reg = t_obsm.MetricsRegistry(), j_obsm.MetricsRegistry()
    t0, j0 = t_reg.snapshot(), j_reg.snapshot()
    _feed(t_reg)
    _feed(j_reg)
    assert t_reg.snapshot() == j_reg.snapshot()
    assert (t_reg.snapshot(deterministic_only=True)
            == j_reg.snapshot(deterministic_only=True))
    assert t_reg.exposition() == j_reg.exposition()
    d = t_obsm.delta(t0, t_reg.snapshot())
    assert d == j_obsm.delta(j0, j_reg.snapshot())
    assert (t_obsm.parse_fullname('tier_evals{tier="fast"}')
            == ("tier_evals", {"tier": "fast"}))
    assert t_obsm.snapshot_percentile(d["latency_ticks"], 50) == 4.0
    art = {"schema": t_obsm.METRICS_SCHEMA, "run": {"metrics": d},
           "serve_metrics": {}, "exposition": ""}
    assert t_obsm.validate_metrics(art) == j_obsm.validate_metrics(art) == []
    kw = dict(mode="continuous", slots=3, n_rows=6, pipeline_depth=2)
    assert (dataclasses.asdict(t_server.serve_metrics_from_snapshot(d, **kw))
            == dataclasses.asdict(j_server.serve_metrics_from_snapshot(
                d, **kw)))
    with pytest.raises(ValueError, match="already registered"):
        t_reg.gauge("serve_ticks")


# ---------------------------------------------------------------------------
# the entry point on the CPU
# ---------------------------------------------------------------------------


def test_serve_entry_point_latents_match_uniform_runs(capsys):
    """`launch.serve.serve_diffusion` (as `--device cpu` runs it): every
    request completes, and a staggered request's latent matches its own
    uniform run (its drawn x_T and class id) within 1e-5 relative."""
    run = t_serve.serve_diffusion("dit-cifar", batch=2, nfe=3,
                                  cfg_scale=2.0, arrival_rate=0.7,
                                  requests=5, device="cpu",
                                  return_run=True)
    out = capsys.readouterr().out
    assert "5/5 requests" in out and "[cpu]" in out
    assert run.latents.shape[0] == 5 and np.isfinite(run.latents).all()
    sched = run.sched
    t_cfg = t_get_config("dit-cifar").reduced()
    engine = t_build_engine(t_cfg, t_api.init_params(t_cfg, 0, "cpu"), TVP(),
                            2, 0, per_request_cond=True, device="cpu")
    c = max(sched.completions, key=lambda c: c.admit_tick)
    assert c.admit_tick > 0
    req = tsv.Request(rid=c.rid, seed=c.rid)     # base_seed 0: seed = rid
    ref = engine.build(TSpec(nfe=3, order=3, cfg_scale=2.0))(
        torch.as_tensor(sched._draw(req))[None],
        class_ids=torch.tensor(
            [int(np.random.default_rng(c.rid).integers(0, 1000))]))[0]
    err = np.abs(c.latent - ref.numpy()).max() / np.abs(ref.numpy()).max()
    assert err <= TOL


def test_serve_cli_runs_on_the_cpu_and_refuses_what_is_not_ported(
        capsys, tmp_path):
    """The CLI serves on the CPU; the observability flags, once refused as
    not yet ported, now run (tests/test_torch_obs.py holds them against the
    reference) and the scheduler takes a tracer; what is still refused:
    per-plan flags on a tier program."""
    out = t_serve.main(["--arch", "dit-cifar", "--batch", "2", "--nfe", "2",
                        "--arrival-rate", "0.5", "--requests", "3",
                        "--pipeline-depth", "3", "--device", "cpu"])
    assert out.shape == (3, 64, 32)
    assert "depth=3" in capsys.readouterr().out
    for flag in (["--trace-out", str(tmp_path / "t.json")],
                 ["--metrics-out", str(tmp_path / "m.json")],
                 ["--probe-fraction", "0.5", "--probe-ref-nfe", "3"]):
        got = t_serve.main(["--arch", "dit-cifar", "--nfe", "2",
                            "--batch", "2", "--device", "cpu"] + flag)
        assert got.shape == (2, 64, 32)
    from repro_torch.obs import Tracer
    sched = tsv.SlotScheduler(t_engine().build_step(TSpec(nfe=2)), 2, (D,),
                              tracer=Tracer())
    assert sched.tracer is not None and sched.probe is None
    with pytest.raises(SystemExit):
        t_serve.main(["--arch", "dit-cifar", "--tiers", "fast", "--nfe", "4",
                      "--device", "cpu"])
    assert "not yet ported" in str(not_yet_ported("x"))
