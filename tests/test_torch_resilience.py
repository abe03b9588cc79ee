"""The port's resilient serving against the reference's
(`tests/test_resilience.py` mirrored): overload control, TTL expiry,
degraded-tier retry on non-finite output and host/device desync recovery,
driven by the same deterministic fault plans.

* the port's scheduler and the reference's on the same trace, x_T and
  `FaultPlan`: the `events` ledger, the rejections, the completion
  bookkeeping and the tick-denominated metrics EQUAL, latents within 1e-5;
* within the port, every request a fault never touched — and the retried
  and requeued ones, whose seeds are kept — bit-identical to the clean run
  at pipeline depths 1, 2 and 3;
* the fault spec round trip, the config validation and the fallback walk;
* a `MetaFault` on a cached (feature-reuse) program: the host's deep /
  shallow word can be wrong for the desynchronized slot only, and
  recovery requeues it, so every latent still equals the clean run.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from repro import serving as jsv
from repro.engine import EngineSpec as JSpec
from repro_torch import serving as tsv
from repro_torch.engine import EngineSpec as TSpec
from repro_torch.serving.resilience import (FAIL_NONFINITE, REJECT_EXPIRED,
                                            REJECT_QUEUE_FULL)

from test_torch_serving import (D, _x_T, assert_same_serving, j_engine,
                                serve_both, t_engine, tier_specs)

DEPTHS = (1, 2, 3)


def _programs(nfe=7, order=3, bank=False):
    if bank:
        return (j_engine().build_bank(tier_specs(JSpec)),
                t_engine().build_bank(tier_specs(TSpec)))
    kw = dict(solver="unipc", order=order, nfe=nfe)
    return (j_engine().build_step(JSpec(**kw)),
            t_engine().build_step(TSpec(**kw)))


def _reqs(pkg, n=9, rate=0.5, seed=5, **kw):
    return [pkg.Request(rid=r.rid, arrival=r.arrival, x_T=_x_T(r.rid), **kw)
            for r in pkg.poisson_requests(n, rate=rate, seed=seed)]


def _both(progs, make_reqs, slots, sched_kw):
    j, t = serve_both(*progs, make_reqs, slots, sched_kw=sched_kw)
    assert_same_serving(j, t)
    return t


def _clean_latents(program, slots=3):
    sched = tsv.SlotScheduler(program, slots, (D,))
    tsv.run_trace(sched, _reqs(tsv))
    return {c.rid: c.latent for c in sched.completions}


# ---------------------------------------------------------------------------
# overload control: bounded queue, typed rejections, TTL expiry
# ---------------------------------------------------------------------------


def test_queue_full_rejects_fifo():
    _, program = _programs(nfe=4, order=2)
    sched = tsv.SlotScheduler(program, 1, (D,),
                              resilience=tsv.ResilienceConfig(max_queue=2))
    outcomes = [sched.submit(tsv.Request(rid=r, x_T=_x_T(r)))
                for r in range(6)]
    assert outcomes[:2] == [None, None]
    assert all(isinstance(o, tsv.Rejection) for o in outcomes[2:])
    assert [o.rid for o in outcomes[2:]] == [2, 3, 4, 5]
    assert all(o.reason == REJECT_QUEUE_FULL for o in outcomes[2:])
    done = sched.drain()
    assert [c.rid for c in done] == [0, 1]
    assert len(done) + len(sched.rejections) == 6


def test_partition_invariant_and_ledger_match_reference():
    """Shed + expiry: submitted == completed + rejected, with the
    reference's rejections, ledger and metrics."""
    progs = _programs(nfe=4, order=2)
    sched, m = _both(progs, lambda pkg: _reqs(pkg, n=14, rate=2.0, seed=7),
                     2, lambda pkg: {"resilience": pkg.ResilienceConfig(
                         max_queue=2, default_ttl=3.0)})
    assert m.rejected > 0 and m.requests == 14
    assert m.requests == m.completed + m.rejected
    assert m.expired <= m.rejected
    assert len(sched.completions) + len(sched.rejections) == 14


def test_ttl_bounds_queue_wait_not_service():
    _, program = _programs(nfe=7)
    sched = tsv.SlotScheduler(program, 1, (D,),
                              resilience=tsv.ResilienceConfig(default_ttl=3.0))
    tsv.run_trace(sched, [tsv.Request(rid=0, arrival=0.0, x_T=_x_T(0)),
                          tsv.Request(rid=1, arrival=0.0, x_T=_x_T(1))])
    done = {c.rid: c for c in sched.completions}
    assert list(done) == [0]
    assert done[0].finish_clock - done[0].arrival > 3.0
    [rej] = sched.rejections
    assert (rej.rid, rej.reason) == (1, REJECT_EXPIRED)


def test_request_ttl_overrides_default():
    _, program = _programs(nfe=7)
    sched = tsv.SlotScheduler(program, 1, (D,),
                              resilience=tsv.ResilienceConfig(default_ttl=3.0))
    tsv.run_trace(sched, [tsv.Request(rid=0, arrival=0.0, x_T=_x_T(0)),
                          tsv.Request(rid=1, arrival=0.0, x_T=_x_T(1),
                                      ttl=100.0)])
    assert sorted(c.rid for c in sched.completions) == [0, 1]
    assert not sched.rejections


def test_degrade_shed_remaps_tier():
    progs = _programs(bank=True)

    def reqs(pkg):
        return [pkg.Request(rid=r, x_T=_x_T(r), tier="quality")
                for r in range(4)]

    sched, _ = _both(progs, reqs, 1, lambda pkg: {
        "resilience": pkg.ResilienceConfig(
            max_queue=4, shed_policy="degrade", degrade_watermark=1,
            degrade_tier="fast")})
    done = {c.rid: c for c in sched.completions}
    assert done[0].tier == "quality" and done[0].first_tier is None
    for r in (1, 2, 3):
        assert done[r].tier == "fast" and done[r].first_tier == "quality"
    assert done[1].evals < done[0].evals


# ---------------------------------------------------------------------------
# output validation: NaN detection, degraded-tier retry, exhaustion
# ---------------------------------------------------------------------------


def test_nan_fault_retries_and_reproduces_clean_latents():
    """A poisoned latent is flagged on the device, the request re-admitted
    with its x_T, and every latent — the retried one included — equals the
    clean run at every depth; the ledger equals the reference's."""
    progs = _programs()
    clean = _clean_latents(progs[1])
    ledgers = []
    for depth in DEPTHS:
        sched, m = _both(progs, _reqs, 3, lambda pkg: {
            "pipeline_depth": depth,
            "resilience": pkg.ResilienceConfig(max_retries=2),
            "faults": pkg.FaultPlan(nans=(pkg.NanFault(rid=2, step=3),))})
        assert m.completed == 9 and m.failed == 0
        assert m.retries == 1 and m.faults_injected == 1
        got = {c.rid: c for c in sched.completions}
        assert all(c.ok for c in got.values())
        assert got[2].retries == 1 and got[2].fail_reason is None
        for rid, lat in clean.items():
            np.testing.assert_array_equal(got[rid].latent, lat)
        ledgers.append(list(sched.events))
    assert ledgers[0] == ledgers[1] == ledgers[2]


def test_retry_exhaustion_emits_failed_completion():
    progs = _programs(nfe=4, order=2)
    sched, m = _both(progs, lambda pkg: _reqs(pkg, n=4, rate=1.0, seed=3), 2,
                     lambda pkg: {
                         "resilience": pkg.ResilienceConfig(max_retries=1),
                         "faults": pkg.FaultPlan(nans=(pkg.NanFault(
                             rid=0, step=1, sticky=True),))})
    got = {c.rid: c for c in sched.completions}
    assert m.failed == 1 and m.requests == m.completed + m.rejected
    bad = got[0]
    assert not bad.ok and bad.fail_reason == FAIL_NONFINITE
    assert bad.retries == 1
    assert not np.isfinite(bad.latent).all()
    assert all(c.ok and np.isfinite(c.latent).all()
               for rid, c in got.items() if rid != 0)


def test_retry_walks_fallback_chain():
    progs = _programs(bank=True)
    sched, _ = _both(
        progs, lambda pkg: [pkg.Request(rid=0, x_T=_x_T(0), tier="quality")],
        2, lambda pkg: {
            "resilience": pkg.ResilienceConfig(
                max_retries=3, fallback=("balanced", "fast")),
            "faults": pkg.FaultPlan(nans=(pkg.NanFault(rid=0, step=1,
                                                       sticky=True),))})
    [c] = sched.completions
    assert not c.ok and c.retries == 3
    assert c.tier == "fast" and c.first_tier == "quality"
    assert [(ev[3], ev[4]) for ev in sched.events if ev[0] == "retry"] == [
        ("quality", "balanced"), ("balanced", "fast"), ("fast", "fast")]


# ---------------------------------------------------------------------------
# desync recovery
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth", DEPTHS)
def test_desync_recovery_completes_all_requests(depth):
    """A corrupted device row counter is caught at the next checked
    flight; recovery drains the pipeline, resyncs from the device meta,
    requeues the affected requests and keeps serving: every request
    completes, bit-identical to the clean run, with the reference's
    ledger."""
    progs = _programs()
    clean = _clean_latents(progs[1])
    sched, m = _both(progs, _reqs, 3, lambda pkg: {
        "pipeline_depth": depth, "resilience": pkg.ResilienceConfig(),
        "faults": pkg.FaultPlan(metas=(pkg.MetaFault(tick=5),))})
    assert m.completed == 9 and m.recoveries >= 1
    got = {c.rid: c for c in sched.completions}
    assert all(c.ok for c in got.values())
    assert any(c.requeues > 0 for c in got.values())
    for rid, lat in clean.items():
        np.testing.assert_array_equal(got[rid].latent, lat)


def test_nan_and_desync_together_match_reference():
    """The chaos smoke's scenario: a NaN and a meta fault in one trace,
    guided, at depth 2 — the same ledger as the reference's."""
    kw = dict(solver="unipc", order=3, nfe=4, cfg_scale=2.0)
    progs = (j_engine(cfg=True).build_step(JSpec(**kw)),
             t_engine(cfg=True).build_step(TSpec(**kw)))
    sched, m = _both(
        progs, lambda pkg: _reqs(pkg, n=8, rate=1.0, seed=0), 2,
        lambda pkg: {"pipeline_depth": 2,
                     "resilience": pkg.ResilienceConfig(max_retries=2),
                     "faults": pkg.FaultPlan(
                         nans=(pkg.NanFault(rid=2, step=1),),
                         metas=(pkg.MetaFault(tick=8),))})
    assert m.completed == 8 and m.faults_injected == 2
    assert m.recoveries >= 1 and all(c.ok for c in sched.completions)


def test_desync_recovery_ledger_deterministic():
    _, program = _programs()
    plan = tsv.FaultPlan(metas=(tsv.MetaFault(tick=5),))

    def run():
        sched = tsv.SlotScheduler(program, 3, (D,), pipeline_depth=2,
                                  faults=plan)
        tsv.run_trace(sched, _reqs(tsv))
        return list(sched.events)

    assert run() == run()


def test_recovery_limit_exhausted_raises():
    _, program = _programs(nfe=3, order=1)

    def lying_step(state, meta, g=None, extras=None):
        state, meta, done = program.step_flight(state, meta, g, extras)
        return state, meta, torch.zeros_like(done)

    sched = tsv.SlotScheduler(
        program, 2, (D,), step_override=lying_step,
        resilience=tsv.ResilienceConfig(max_recoveries=2))
    sched.submit(tsv.Request(rid=0, x_T=_x_T(0)))
    with pytest.raises(RuntimeError, match="recovery limit"):
        sched.drain()


# ---------------------------------------------------------------------------
# a desync on a cached program (the host's deep / shallow word)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cached_program():
    """A reduced dit-cifar (perturbed, class-free) cached at block 1 with
    rows full, full, reuse, full, reuse, reuse (init row first)."""
    from test_torch_cache import classless, t_engine_cached

    from repro_torch.diffusion import VPLinear
    from repro_torch.tuning import SolverPlan

    t_cfg, params, _ = classless()
    engine = t_engine_cached(t_cfg, params, batch=3)
    spec = TSpec(solver="unipc", nfe=5, order=2, cache_block=1)
    plan = replace(SolverPlan.default(5, order=2),
                   cache_depth=[0, 1, 0, 1, 1])
    program = engine.build_step(spec, table=engine.compile(
        spec, table=plan.compile(VPLinear())))
    assert program.row_reuse.tolist() == [False, False, True, False, True,
                                          True]
    return t_cfg, program


@pytest.mark.parametrize("depth", DEPTHS)
def test_meta_fault_on_cached_program_recovers_bit_identical(
        cached_program, depth):
    """Three requests in lockstep; at tick 3 every slot runs row 2, a reuse
    row, so the host picks the graph without the deep blocks — but a
    MetaFault has moved slot 0's device row to 3, a full row. Only that
    slot gets the wrong word. It finishes a tick early on the device, the
    done mask of the tick the host predicted disagrees, and recovery
    requeues that flight's requests; every latent (slot 0's included)
    equals the clean run's, at every depth."""
    t_cfg, program = cached_program
    sample = (t_cfg.patch_tokens, t_cfg.latent_dim)

    def reqs():
        return [tsv.Request(rid=i, arrival=float(a), x_T=np.random.default_rng(
            50 + i).normal(size=sample).astype(np.float32))
                for i, a in enumerate([0, 0, 0, 1, 2, 6])]

    clean = tsv.SlotScheduler(program, 3, sample)
    tsv.run_trace(clean, reqs())
    assert clean.shallow_ticks > 0
    want = {c.rid: c.latent for c in clean.completions}
    sched = tsv.SlotScheduler(
        program, 3, sample, pipeline_depth=depth,
        faults=tsv.FaultPlan(metas=(tsv.MetaFault(tick=3, slot=0),)))
    words, flight = [], sched._flight

    def spy(*args, **kw):
        words.append(kw["deep"])
        return flight(*args, **kw)

    sched._flight = spy
    m = tsv.run_trace(sched, reqs())
    assert ("fault_meta", 3, 0, 1) in sched.events
    assert words[:3] == [True, True, False]   # tick 3: the shallow graph
    assert m.completed == 6 and m.recoveries >= 1
    assert [c.rid for c in sched.completions if c.requeues] == [0, 1, 2]
    for c in sched.completions:
        np.testing.assert_array_equal(c.latent, want[c.rid])


# ---------------------------------------------------------------------------
# harness plumbing: config validation, fallback walk, spec parsing, skew
# ---------------------------------------------------------------------------


def test_validate_resilience_rejects_contradictions():
    _, single = _programs(nfe=3, order=1)
    _, bank = _programs(bank=True)
    v = tsv.validate_resilience
    with pytest.raises(ValueError, match="shed_policy"):
        v(tsv.ResilienceConfig(shed_policy="drop"), single)
    with pytest.raises(ValueError, match="recovery"):
        v(tsv.ResilienceConfig(recovery="ignore"), single)
    with pytest.raises(ValueError, match="max_queue"):
        v(tsv.ResilienceConfig(max_queue=0), single)
    with pytest.raises(ValueError, match="degrade_tier"):
        v(tsv.ResilienceConfig(shed_policy="degrade"), bank)
    with pytest.raises(ValueError, match="degrade_watermark"):
        v(tsv.ResilienceConfig(max_queue=2, shed_policy="degrade",
                               degrade_tier="fast", degrade_watermark=5),
          bank)
    with pytest.raises(ValueError):
        v(tsv.ResilienceConfig(fallback=("fast",)), single)
    cfg = v(tsv.ResilienceConfig(max_queue=3, shed_policy="degrade",
                                 degrade_tier="fast"), bank)
    assert cfg.degrade_watermark == 3


def test_fallback_tier_walk():
    cfg = tsv.ResilienceConfig(fallback=("balanced", "fast"))
    assert tsv.fallback_tier(cfg, "quality") == "balanced"
    assert tsv.fallback_tier(cfg, "balanced") == "fast"
    assert tsv.fallback_tier(cfg, "fast") == "fast"
    assert tsv.fallback_tier(tsv.ResilienceConfig(), "quality") == "quality"
    assert tsv.fallback_tier(tsv.ResilienceConfig(), None) is None


@pytest.mark.parametrize("spec", [
    "nan:rid=2,step=1;meta:tick=6;skew:tick=3,delta=9",
    "nan:rid=0,step=1,sticky=1;meta:tick=2,slot=1,delta=2",
    "seed:7,requests=8,nfe=4,n_meta=1,n_skew=1", "", "none"])
def test_parse_fault_spec_round_trip_matches_reference(spec):
    plan = tsv.parse_fault_spec(spec)
    ref = jsv.parse_fault_spec(spec)
    assert plan.describe() == ref.describe()
    assert tsv.parse_fault_spec(plan.describe()) == plan
    assert bool(plan) == bool(ref)
    for bad in ("nan:step=1", "flood:tick=3"):
        with pytest.raises(ValueError, match="bad fault clause"):
            tsv.parse_fault_spec(bad)


def test_skew_fault_forces_expiry():
    progs = _programs(nfe=4, order=2)
    sched, m = _both(progs, lambda pkg: _reqs(pkg, n=6, rate=1.0, seed=2), 1,
                     lambda pkg: {
                         "resilience": pkg.ResilienceConfig(default_ttl=50.0),
                         "faults": pkg.FaultPlan(skews=(pkg.SkewFault(
                             tick=4, delta=100.0),))})
    assert m.faults_injected == 1 and m.expired > 0
    assert m.requests == m.completed + m.rejected
    assert any(ev[0] == "fault_skew" for ev in sched.events)


def test_fault_free_resilient_sched_matches_plain():
    _, program = _programs()
    plain = tsv.SlotScheduler(program, 3, (D,))
    armed = tsv.SlotScheduler(program, 3, (D,),
                              resilience=tsv.ResilienceConfig(max_queue=64,
                                                              max_retries=2))
    m0, m1 = tsv.run_trace(plain, _reqs(tsv)), tsv.run_trace(armed,
                                                             _reqs(tsv))
    det = lambda m: (m.requests, m.completed, m.ticks, m.evals,
                     m.makespan_ticks, m.latency_ticks_p50, m.occupancy,
                     m.rejected, m.expired, m.degraded, m.retries,
                     m.failed, m.recoveries, m.faults_injected)
    assert det(m0) == det(m1)
    assert not armed.events and not armed.rejections
    for a, b in zip(plain.completions, armed.completions):
        assert (a.rid, a.finish_tick, a.ok, a.retries) == \
            (b.rid, b.finish_tick, b.ok, b.retries)
        np.testing.assert_array_equal(a.latent, b.latent)


def test_seeded_plan_matches_reference():
    kw = dict(n_requests=8, nfe=4, n_nan=2, n_meta=1, n_skew=1)
    assert (tsv.FaultPlan.seeded(11, **kw).describe()
            == jsv.FaultPlan.seeded(11, **kw).describe())
    assert replace(tsv.FaultPlan(), nans=()) == tsv.FaultPlan()
