"""The port's pipelined serving loop: depth-N scheduling is bit-identical
to depth 1 (`tests/test_async_serving.py` mirrored), and the mechanics of
the trailing readback on torch.

* depths 1/2/3 give bit-identical latents, completion order, bookkeeping
  and tick-denominated metrics — with tiers and per-request guidance too —
  and the same metrics as the reference's scheduler at every depth;
* mid-flight admission does not drain the pipeline; emission is deferred
  by the depth with dispatch-stamped clocks; simultaneous completions ride
  one flight; a done-mask desync raises under recovery='raise'; depth 0 is
  rejected;
* the flight buffer ring: at most `pipeline_depth` buffers, one per
  unconsumed flight, and admission writes the handed-out buffers in place.

The `gpu` tests run the same on the card: the flight graph captured once
per signature across admissions, the cached program's full and shallow
graphs bit-equal on the slots they share, the pinned ring reused only
after its flight's event, and a depth-2 trace under
`torch.cuda.set_sync_debug_mode("error")`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.engine import EngineSpec as JSpec
from repro_torch import serving as tsv
from repro_torch.engine import EngineSpec as TSpec
from repro_torch.kernels.dispatch import LAUNCHES

from test_torch_serving import (D, TOL, _x_T, completion_key, j_engine,
                                metric_key, requests, serve_both, t_engine,
                                t_uniform, tier_specs)

DEPTHS = (1, 2, 3)


def _run_at_depth(program, make_reqs, depth, slots=3, **kw):
    sched = tsv.SlotScheduler(program, slots, (D,), pipeline_depth=depth,
                              **kw)
    m = tsv.run_trace(sched, make_reqs(tsv))
    assert sched.in_flight == 0  # run_trace flushed the readback stream
    assert len(sched._free) == depth   # every flight buffer is back
    return sched, m


def _assert_depths_identical(program, make_reqs, j_program, slots=3):
    base, m0 = _run_at_depth(program, make_reqs, 1, slots)
    for depth in DEPTHS:
        sched, m = _run_at_depth(program, make_reqs, depth, slots)
        assert m.pipeline_depth == depth
        assert (metric_key(dataclasses.replace(m, pipeline_depth=1))
                == metric_key(m0))
        assert ([completion_key(c) for c in sched.completions]
                == [completion_key(c) for c in base.completions])
        for a, b in zip(base.completions, sched.completions):
            np.testing.assert_array_equal(a.latent, b.latent)
        # and the reference's scheduler at the same depth agrees
        jsched_m = serve_both(j_program, program, make_reqs, slots,
                              sched_kw=lambda pkg: {"pipeline_depth": depth})
        assert metric_key(jsched_m[0][1]) == metric_key(m)
    return base, m0


@pytest.mark.parametrize("solver,order", [("unipc", 3), ("dpmpp", 2)])
def test_depths_bit_identical_on_poisson_trace(solver, order):
    kw = dict(solver=solver, order=order, nfe=7)
    program = t_engine().build_step(TSpec(**kw))

    def make(pkg):
        return [pkg.Request(rid=r.rid, arrival=r.arrival, x_T=_x_T(r.rid))
                for r in pkg.poisson_requests(9, rate=0.5, seed=5)]

    base, m0 = _assert_depths_identical(
        program, make, j_engine().build_step(JSpec(**kw)))
    assert m0.completed == 9


def test_depths_bit_identical_with_tiers_and_cfg():
    """A plan bank with per-request guidance scales: per-tier metrics and
    eval_cost included in the cross-depth equality."""
    names = ["fast", "balanced", "quality"]
    scales = [1.0, 2.0, 3.5]
    program = t_engine(cfg=True).build_bank(tier_specs(TSpec, cfg_scale=2.0))
    arrivals = [0, 0, 1, 3, 4, 8, 9]

    def make(pkg):
        return requests(pkg, arrivals,
                        tiers=[names[i % 3] for i in range(7)],
                        scales=[scales[i % 3] for i in range(7)])

    base, m0 = _assert_depths_identical(
        program, make,
        j_engine(cfg=True).build_bank(tier_specs(JSpec, cfg_scale=2.0)))
    assert m0.completed == 7 and set(m0.per_tier) == set(names)


def test_mid_flight_admission_does_not_drain_the_pipeline():
    """An arrival while ticks are in flight is admitted on the very next
    tick, so its latency equals the budget exactly."""
    teng = t_engine()
    spec = TSpec(solver="unipc", order=2, nfe=6)
    program = teng.build_step(spec)
    sched = tsv.SlotScheduler(program, 2, (D,), pipeline_depth=3)
    sched.submit(tsv.Request(rid=0, x_T=_x_T(0)))
    sched.tick()
    sched.tick()
    assert sched.in_flight == 2
    sched.submit(tsv.Request(rid=1, x_T=_x_T(1)))
    sched.tick()
    assert sched.in_flight == 2 and not sched.queue
    assert sched.slot_req[1] is not None and sched.slot_req[1].rid == 1
    got = {c.rid: c for c in sched.drain()}
    assert got[1].admit_tick == 2
    assert got[1].finish_tick == 2 + program.n_rows
    np.testing.assert_allclose(got[1].latent, t_uniform(teng, spec, _x_T(1)),
                               atol=TOL, rtol=0)


def test_trailing_readback_defers_emission_by_depth():
    """At depth 2 a completion is emitted one tick after the tick that
    finished it (or at flush), finish_tick stamped at dispatch."""
    program = t_engine().build_step(TSpec(solver="unipc", order=2, nfe=4))
    n = program.n_rows
    sched = tsv.SlotScheduler(program, 2, (D,), pipeline_depth=2)
    sched.submit(tsv.Request(rid=0, x_T=_x_T(0)))
    emitted = []
    for _ in range(n):
        emitted += sched.tick()
    assert emitted == [] and sched.in_flight >= 1
    assert sched.active == 0  # host prediction already freed the slot
    done = sched.flush()
    assert [c.rid for c in done] == [0] and done[0].finish_tick == n
    ref = tsv.SlotScheduler(program, 2, (D,), pipeline_depth=1)
    ref.submit(tsv.Request(rid=0, x_T=_x_T(0)))
    ref_done = []
    for _ in range(n):
        ref_done += ref.tick()
    assert [c.finish_tick for c in ref_done] == [n]
    np.testing.assert_array_equal(done[0].latent, ref_done[0].latent)


def test_simultaneous_completions_ride_one_flight():
    """Slots finishing on the same tick share ONE padded readback in one
    flight, already in slot order."""
    program = t_engine().build_step(TSpec(solver="unipc", order=2, nfe=5))
    sched = tsv.SlotScheduler(program, 3, (D,), pipeline_depth=2)
    for r in range(3):
        sched.submit(tsv.Request(rid=r, x_T=_x_T(r)))
    for _ in range(program.n_rows):
        sched.tick()
    [flight] = list(sched._inflight)
    assert flight.slots.tolist() == [0, 1, 2]
    assert flight.lat is not None and flight.lat.shape[0] == 3
    done = sched.flush()
    assert [c.rid for c in done] == [0, 1, 2]
    assert len({c.finish_tick for c in done}) == 1


def test_done_mask_desync_raises():
    program = t_engine().build_step(TSpec(solver="unipc", order=2, nfe=4))

    def lying_step(state, meta, g=None, extras=None):
        state, meta, done = program.step_flight(state, meta, g, extras)
        return state, meta, torch.zeros_like(done)  # device: nobody done

    sched = tsv.SlotScheduler(
        program, 2, (D,), step_override=lying_step,
        resilience=tsv.ResilienceConfig(recovery="raise"))
    sched.submit(tsv.Request(rid=0, x_T=_x_T(0)))
    with pytest.raises(RuntimeError, match="done mask"):
        sched.drain()


@pytest.mark.parametrize("depth", DEPTHS)
def test_readback_phase_counts_only_completing_flights(depth):
    """`readback` is the time blocked on a flight that carries completions,
    as in the reference: flights that finish nobody are not waited on and
    book none."""
    program = t_engine().build_step(TSpec(solver="unipc", order=2, nfe=5))
    sched = tsv.SlotScheduler(program, 2, (D,), pipeline_depth=depth)
    sched.submit(tsv.Request(rid=0, x_T=_x_T(0)))
    for _ in range(program.n_rows - 1):
        sched.tick()
    assert sched.phase_ns["readback"] == 0 and not sched.completions
    sched.tick()
    sched.flush()
    assert len(sched.completions) == 1 and sched.phase_ns["readback"] > 0


def test_depth_zero_rejected():
    program = t_engine().build_step(TSpec(solver="unipc", order=1, nfe=3))
    with pytest.raises(ValueError, match="pipeline_depth"):
        tsv.SlotScheduler(program, 2, (D,), pipeline_depth=0)
    assert tsv.SlotScheduler(program, 2, (D,)).pipeline_depth == 1


@pytest.mark.parametrize("depth", DEPTHS)
def test_flight_ring_and_in_place_admission(depth):
    """A completing tick's flight owns one of `depth` readback buffers until
    it is consumed (free + held == depth after every tick), a flight without
    completions holds none, and admission writes the buffers the program
    handed out — the state, meta, guidance scales and
    extras are never rebound."""
    program = t_engine(cfg=True).build_step(TSpec(nfe=5, order=2,
                                                  cfg_scale=2.0))
    sched = tsv.SlotScheduler(program, 2, (D,), pipeline_depth=depth,
                              extras_init={"tag": 0})
    held = [*sched.state, sched.meta, sched.g, sched.extras["tag"]]
    for r in range(4):
        sched.submit(tsv.Request(rid=r, x_T=_x_T(r), cfg_scale=1.0 + r,
                                 extras={"tag": 10 + r}))
    seen = set()
    while sched.queue or sched.active:
        sched.tick()
        owned = [f.buf for f in sched._inflight if f.buf is not None]
        assert len(sched._free) + len(owned) == depth
        assert sched.in_flight <= depth - 1
        assert all((f.buf is not None) == bool(f.slots.size)
                   for f in sched._inflight)
        seen.update(id(b) for b in owned)
        now = [*sched.state, sched.meta, sched.g, sched.extras["tag"]]
        assert all(a is b for a, b in zip(held, now))
    sched.flush()
    assert len(sched.completions) == 4 and len(sched._free) == depth
    assert seen <= {id(b) for b in sched._free}


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flight steps are CUDA graphs")
    return torch.device("cuda")


def _card_program(dev, cached=False):
    """A reduced dit-cifar step program on the card (cached at block 1
    with a plan whose body steps reuse, or guided)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.diffusion import VPLinear
    from repro_torch.launch.sample import build_engine
    from repro_torch.models import api
    from repro_torch.tuning import SolverPlan

    cfg = get_config("dit-cifar").reduced()
    params = api.init_params(cfg, 0, dev)
    engine = build_engine(cfg, params, VPLinear(), 4, per_request_cond=True,
                          cache_block=1 if cached else 0, device=dev)
    if not cached:
        return cfg, engine.build_step(TSpec(nfe=6, order=3, cfg_scale=2.0))
    spec = TSpec(nfe=6, order=2, cache_block=1)
    plan = replace(SolverPlan.default(6, order=2),
                   cache_depth=[0, 1, 1, 0, 1, 1])
    return cfg, engine.build_step(spec, table=engine.compile(
        spec, table=plan.compile(VPLinear())))


def _card_reqs(cfg, n, scale=True):
    return [tsv.Request(rid=i, arrival=float(a), seed=i,
                        cfg_scale=1.5 + i % 3 if scale else None,
                        extras={"class_ids": i % 10})
            for i, a in enumerate(np.cumsum(
                np.random.default_rng(0).exponential(1.5, size=n)))]


@pytest.mark.gpu
@pytest.mark.parametrize("cached", [False, True])
def test_card_flight_graph_captured_once_across_admissions(cuda, cached):
    """Admissions of 1, 2, ... slots at a time replay the graph(s) captured
    up front: one per flight signature (two on a cached program, full and
    shallow), never one per admission count."""
    cfg, program = _card_program(cuda, cached)
    sched = tsv.SlotScheduler(program, 4, (cfg.patch_tokens, cfg.latent_dim),
                              extras_init={"class_ids": 1000},
                              pipeline_depth=2)
    assert sched.aot_compile() > 0
    keys = set(program.step_graphs.graphs)
    assert len(keys) == (2 if cached else 1)
    m = tsv.run_trace(sched, _card_reqs(cfg, 9, scale=not cached))
    assert m.completed == 9
    assert set(program.step_graphs.graphs) == keys
    if cached:
        assert sched.shallow_ticks > 0


@pytest.mark.gpu
def test_card_full_and_shallow_graphs_agree_on_reuse_slots(cuda):
    """On a tick where every slot runs a reuse row, the graph with the deep
    blocks and the one without give bit-equal states: the skipped blocks
    change no number there."""
    cfg, program = _card_program(cuda, cached=True)
    sample = (cfg.patch_tokens, cfg.latent_dim)

    def advance(deep_at):
        sched = tsv.SlotScheduler(program, 4, sample,
                                  extras_init={"class_ids": 1000})
        for i in range(4):
            sched.submit(tsv.Request(rid=i, seed=i,
                                     extras={"class_ids": i}))
        for t in range(3):
            if t == 2:
                assert not sched._deep()   # row 2 of every slot reuses
                sched._deep = lambda: deep_at
            sched.tick()
        return [s.clone() for s in sched.state] + [sched.meta.clone()]

    full, shallow = advance(True), advance(False)
    for a, b in zip(full, shallow):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_card_pinned_ring_reused_only_after_its_flight(cuda):
    """A buffer goes back to the ring only once its flight's event has
    fired, and the buffers are pinned."""
    cfg, program = _card_program(cuda)
    sched = tsv.SlotScheduler(program, 4, (cfg.patch_tokens, cfg.latent_dim),
                              extras_init={"class_ids": 1000},
                              pipeline_depth=3)
    assert all(b.mask.is_pinned() and b.lat.is_pinned() for b in sched._free)
    for r in _card_reqs(cfg, 6):
        sched.submit(dataclasses.replace(r, arrival=0.0))
    while sched.queue or sched.active:
        sched.tick()
        assert all(b.event.query() for b in sched._free)
        held = [f.buf for f in sched._inflight if f.buf is not None]
        assert len(sched._free) + len(held) == 3
    sched.flush()
    assert len(sched.completions) == 6


@pytest.mark.gpu
def test_card_depth2_trace_makes_no_sync_outside_consume(cuda):
    """A depth-2 trace (admissions, replays, readback copies) under
    set_sync_debug_mode("error"): only `_consume`'s event waits sync, and
    they run with the mode off by design. One tick of a replay launches
    one eval's kernels and 2 row ops."""
    cfg, program = _card_program(cuda)
    sched = tsv.SlotScheduler(program, 4, (cfg.patch_tokens, cfg.latent_dim),
                              extras_init={"class_ids": 1000},
                              pipeline_depth=2)
    sched.aot_compile()
    reqs = _card_reqs(cfg, 8)
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = tsv.run_trace(sched, reqs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert m.completed == 8
    for r in _card_reqs(cfg, 2):
        sched.submit(r)
    sched.tick()
    LAUNCHES.clear()
    sched.tick()
    L = cfg.num_layers
    assert dict(LAUNCHES) == {"unipc_update": 2,
                              "adaln_modulate": 2 * L + 1,
                              "gate_residual": 2 * L,
                              "flash_attention": L}
    sched.drain()
