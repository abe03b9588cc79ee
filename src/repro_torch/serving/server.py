"""Request generators, the trace runner, and serving metrics (the port of
`repro.serving.server`).

Traffic is simulated in *tick time*: one tick = one batched model eval (the
scheduler's unit of work), so a trace is deterministic and hardware-free —
the same arrival stream replays identically on the CPU and on the card.
Wall-clock figures come from measuring the ticks that actually ran:
`run_trace` times every step call and reports both tick-denominated metrics
(latency in evals, evals-per-latent) and wall-denominated ones (throughput
in requests/s, p50/p95 latency seconds).

    PYTHONPATH=src python -m repro_torch.serving.server --smoke [--device cpu]

runs the smoke: a short Poisson trace against the reduced dit-cifar
backbone, asserting every request completes and that the scheduler
performed exactly one batched eval per tick; `--chaos` runs the fault-
injection smoke. Both run on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import asdict, dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..obs import metrics as obsm
from .faults import FaultPlan, MetaFault, NanFault
from .resilience import ResilienceConfig
from .scheduler import Request, SlotScheduler

TICK_WALL_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1, 1.0, 3.0)


def poisson_requests(n: int, rate: float, seed: int = 0,
                     cfg_scales: Optional[Sequence[float]] = None,
                     base_seed: int = 0,
                     tiers: Optional[Sequence[str]] = None) -> List[Request]:
    """n requests with Exp(1/rate) inter-arrival gaps (arrival in tick units).

    `rate` is requests per tick. `cfg_scales`, if given, is cycled through the
    requests — the per-request guidance knob (UniPC Table 9 settings vary it).
    `tiers`, if given, is likewise cycled — the quality-tier tag plan-bank
    programs route on (`Request.tier`).
    """
    if rate <= 0:
        raise ValueError(f"arrival rate must be > 0 requests per tick, "
                         f"got {rate}")
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n))
    return [Request(rid=i, seed=base_seed + i, arrival=float(arrivals[i]),
                    cfg_scale=(None if cfg_scales is None
                               else float(cfg_scales[i % len(cfg_scales)])),
                    tier=(None if tiers is None
                          else str(tiers[i % len(tiers)])))
            for i in range(n)]


def save_trace(path: str, requests: Sequence[Request]) -> None:
    rows = [{"rid": r.rid, "seed": r.seed, "arrival": r.arrival,
             "cfg_scale": r.cfg_scale, "extras": r.extras, "tier": r.tier,
             "ttl": r.ttl}
            for r in requests]
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)


def load_trace(path: str) -> List[Request]:
    """JSON trace: a list of {rid, seed, arrival, cfg_scale, extras, tier}
    objects; `extras` (optional) carries per-request model conditioning,
    e.g. {"class_ids": 7}; `tier` (optional) tags the request's quality tier
    for plan-bank serving."""
    with open(path) as f:
        rows = json.load(f)
    return [Request(rid=int(r["rid"]), seed=int(r.get("seed", 0)),
                    arrival=float(r.get("arrival", 0.0)),
                    cfg_scale=(None if r.get("cfg_scale") is None
                               else float(r["cfg_scale"])),
                    extras=r.get("extras"),
                    tier=(None if r.get("tier") is None
                          else str(r["tier"])),
                    ttl=(None if r.get("ttl") is None
                         else float(r["ttl"])))
            for r in rows]


@dataclass
class ServeMetrics:
    """What one trace run measured. Tick-denominated fields are deterministic
    (the simulation), *_s fields are measured wall-clock."""

    mode: str                 # continuous | gang
    requests: int
    completed: int
    slots: int
    n_rows: int               # evals per request (the per-request NFE
                              # budget); for plan-bank programs, the MAX
                              # across tiers — per_tier carries each tier's
                              # exact budget
    ticks: int                # batched step calls
    evals: int                # always == ticks
    makespan_ticks: float     # clock when the last request finished
    throughput_per_tick: float
    latency_ticks_p50: float
    latency_ticks_p95: float
    occupancy: float          # busy-slot fraction over ticks that ran
    evals_per_latent: float   # slot-evals spent per finished latent
    tick_s: float             # wall seconds per tick: the per-tick median at
                              # pipeline depth 1, wall_s / ticks otherwise
                              # (per-tick walls are meaningless mid-pipeline)
    throughput_rps: float     # completed / wall_s
    latency_s_p50: float
    latency_s_p95: float
    # plan-bank runs: {tier: {completed, evals, latency_ticks_p50}} — how
    # each quality tier fared inside the shared batch. None for single-plan.
    per_tier: Optional[dict] = None
    pipeline_depth: int = 1   # ticks kept in flight (DESIGN.md §13)
    wall_s: float = 0.0       # measured wall seconds for the whole trace
    host_us_per_tick: float = 0.0  # host bookkeeping µs per tick, excluding
                                   # time blocked on device readbacks
    # the host_us_per_tick split by tick phase (DESIGN.md §15):
    # {admission, dispatch, readback, bookkeeping} µs per executed tick —
    # admission + bookkeeping == host_us_per_tick; dispatch and readback are
    # device-facing time, reported for the "where a tick goes" breakdown
    host_phase_us_per_tick: Optional[dict] = None
    # resilience accounting (DESIGN.md §16). Completions and rejections
    # partition every submission: requests == completed + rejected, the
    # invariant run_trace metrics hold under overload and faults.
    rejected: int = 0         # shed before admission (queue_full + expired)
    expired: int = 0          # the TTL/deadline subset of `rejected`
    degraded: int = 0         # submissions remapped to the shed tier
    retries: int = 0          # non-finite re-admissions (validation retry)
    failed: int = 0           # completions with ok=False (retry exhausted)
    recoveries: int = 0       # host/device desync recoveries
    faults_injected: int = 0  # chaos-harness faults that fired (faults.py)

    def row(self) -> dict:
        return asdict(self)


def _counter_val(delta: dict, name: str, default=0):
    row = delta.get(name)
    return row["value"] if row else default


def serve_metrics_from_snapshot(delta: dict, *, mode: str, slots: int,
                                n_rows: int,
                                pipeline_depth: int = 1) -> ServeMetrics:
    """Re-derive `ServeMetrics` from a metrics-registry snapshot delta.

    `delta` is `obs.metrics.delta(before, after)` over the scheduler's
    registry around one run (`MetricsRegistry.snapshot` with samples). This
    is THE code path `run_trace` reports through — the live registry and the
    end-of-run aggregate cannot drift — and it is a pure function of
    JSON-able data, so `launch/obsreport.py --check` re-runs it on a saved
    metrics artifact and compares against the artifact's embedded metrics.

    Percentiles come from the histograms' exact retained samples; an empty
    histogram (zero-completion run) reports 0.0 — the np.percentile
    empty-list crash cannot happen by construction. `occupancy` likewise
    guards ticks == 0."""
    ticks = _counter_val(delta, "serve_ticks")
    n_done = _counter_val(delta, "serve_completed")
    makespan = float(_counter_val(delta, "serve_makespan_ticks", 0.0))
    wall_s = float(_counter_val(delta, "serve_wall_s", 0.0))
    lat_row = delta.get("latency_ticks") or {}
    lat_p50 = obsm.snapshot_percentile(lat_row, 50)
    lat_p95 = obsm.snapshot_percentile(lat_row, 95)
    tw_row = delta.get("tick_wall_s") or {}
    tick_s = (obsm.snapshot_percentile(tw_row, 50) if tw_row.get("count")
              else (wall_s / ticks if ticks else 0.0))
    phases = {}
    rejected = expired = faults = 0
    for full, row in delta.items():
        name, labels = obsm.parse_fullname(full)
        if name == "host_phase_ns" and "phase" in labels:
            phases[labels["phase"]] = row["value"]
        elif name == "serve_rejected":
            rejected += int(row["value"])
            if labels.get("reason") == "expired":
                expired += int(row["value"])
        elif name == "fault_injected":
            faults += int(row["value"])
    host_ns = phases.get("admission", 0) + phases.get("bookkeeping", 0)
    tiers = sorted({obsm.parse_fullname(full)[1].get("tier")
                    for full in delta
                    if obsm.parse_fullname(full)[0] == "tier_completed"})
    per_tier = None
    if tiers:
        per_tier = {}
        for t in tiers:
            lbl = f'{{tier="{t}"}}'
            per_tier[t] = {
                "completed": _counter_val(delta, f"tier_completed{lbl}"),
                "evals": int(_counter_val(delta, f"tier_evals{lbl}", 0)),
                # full-eval units: < evals when the tier's plan schedules
                # shallow feature-reuse steps (DESIGN.md §12)
                "eval_cost": float(_counter_val(delta,
                                                f"tier_eval_cost{lbl}", 0.0)),
                "latency_ticks_p50": obsm.snapshot_percentile(
                    delta.get(f"tier_latency_ticks{lbl}") or {}, 50),
            }
    return ServeMetrics(
        mode=mode,
        requests=_counter_val(delta, "serve_submitted"),
        completed=n_done, slots=slots, n_rows=n_rows,
        ticks=ticks, evals=_counter_val(delta, "serve_evals"),
        makespan_ticks=makespan,
        throughput_per_tick=n_done / max(makespan, 1.0),
        latency_ticks_p50=lat_p50,
        latency_ticks_p95=lat_p95,
        occupancy=(_counter_val(delta, "serve_active_slot_ticks")
                   / (ticks * slots) if ticks else 0.0),
        evals_per_latent=ticks * slots / max(n_done, 1),
        tick_s=tick_s,
        throughput_rps=n_done / max(wall_s, 1e-12),
        latency_s_p50=lat_p50 * tick_s,
        latency_s_p95=lat_p95 * tick_s,
        per_tier=per_tier,
        pipeline_depth=pipeline_depth,
        wall_s=wall_s,
        host_us_per_tick=host_ns / ticks / 1e3 if ticks else 0.0,
        host_phase_us_per_tick={p: (phases.get(p, 0) / ticks / 1e3
                                    if ticks else 0.0)
                                for p in ("admission", "dispatch",
                                          "readback", "bookkeeping")},
        rejected=rejected, expired=expired,
        degraded=int(_counter_val(delta, "serve_shed_degraded")),
        retries=int(_counter_val(delta, "serve_retries")),
        failed=int(_counter_val(delta, "serve_failed")),
        recoveries=int(_counter_val(delta, "serve_desync_recoveries")),
        faults_injected=faults,
    )


def run_trace(sched: SlotScheduler, requests: Sequence[Request],
              mode: Optional[str] = None,
              snapshot_every: Optional[int] = None,
              snapshot_log: Optional[list] = None) -> ServeMetrics:
    """Drive a scheduler through an arrival trace to completion.

    The clock advances one tick per step call; when nothing is queued or
    in-flight the clock fast-forwards to the next arrival without burning an
    eval (so `evals == ticks` holds by construction).

    At pipeline depth 1 every tick is individually fenced (`sched.fence()`
    after it, the reference's `block_until_ready`: a tick without
    completions reads nothing back and so never waits on the card inside
    `tick()`), so `tick_s` is a clean per-tick median. At depth >= 2 the loop never waits on the tick
    it just dispatched — completions surface from the trailing readback
    stream as their flights land, and the final `flush()` consumes the
    stragglers — so only the whole-trace `wall_s` is meaningful and
    `tick_s` is reported as its per-tick mean. Completion clocks are stamped at dispatch time, so
    tick-denominated latency metrics are identical at every depth.

    Metrics are derived from the scheduler's registry: the run brackets a
    registry snapshot (so a reused scheduler reports THIS run's numbers) and
    `serve_metrics_from_snapshot` turns the delta into the ServeMetrics
    aggregate — one code path for live and final numbers (DESIGN.md §15).
    `snapshot_every`, with a `snapshot_log` list, additionally appends a
    compact (sample-free) registry snapshot row every N executed ticks —
    the periodic streaming view the metrics artifact records.

    Submissions need not all complete (DESIGN.md §16): a bounded-queue
    scheduler sheds under overload, TTLs expire queued requests, and the
    resilience layer can requeue in-flight work (validation retry, desync
    recovery). The runner keeps serving until queue, slots, AND the
    readback pipeline are empty, and the derived metrics partition every
    submission: `requests == completed + rejected`.
    """
    pending = sorted(requests, key=lambda r: r.arrival)
    sync = sched.pipeline_depth == 1
    reg = sched.registry
    snap0 = reg.snapshot()
    ticks0 = sched.ticks
    # wall-clock metrics ride the registry too, flagged wall=True so the
    # deterministic snapshot slice (the cross-depth equality) excludes them
    h_tick_wall = reg.histogram("tick_wall_s", TICK_WALL_BUCKETS, wall=True,
                                help="fenced per-tick wall seconds (pipeline "
                                     "depth 1 runs only)")
    g_wall = reg.gauge("serve_wall_s", wall=True,
                       help="whole-trace wall seconds of the last run")
    # counters, not gauges: the snapshot delta of a reused scheduler must
    # isolate this run's value, and gauges don't subtract
    c_makespan = reg.counter("serve_makespan_ticks",
                             help="clock when the run's last request "
                                  "finished (per-run delta)")
    i = 0
    now = 0.0
    wall0 = time.perf_counter()
    try:
        while True:
            while i < len(pending) and pending[i].arrival <= now:
                sched.submit(pending[i])
                i += 1
            if not sched.queue and not sched.active:
                if sched.in_flight:
                    # drain the trailing readbacks before declaring idle: a
                    # consumed flight can REQUEUE work (validation retry,
                    # desync recovery), in which case serving resumes
                    sched.flush()
                    continue
                if i < len(pending):
                    now = pending[i].arrival  # idle: jump to the next arrival
                    continue
                break
            sched.clock = now + 1.0  # this tick's completions land at now+1
            t0 = time.perf_counter()
            sched.tick()
            if sync:
                # block per tick: a tick without a completion fetch would
                # otherwise clock only its host cost
                sched.fence()
                h_tick_wall.observe(time.perf_counter() - t0)
            now += 1.0
            if (snapshot_every and snapshot_log is not None
                    and (sched.ticks - ticks0) % snapshot_every == 0):
                snapshot_log.append({
                    "tick": sched.ticks - ticks0, "clock": now,
                    "metrics": obsm.delta(
                        snap0, reg.snapshot(include_samples=False))})
        # the loop ends with every flight consumed: nothing is left queued
        # on the card
    finally:
        sched.clock = None  # later direct tick()s fall back to the tick clock
    wall_s = time.perf_counter() - wall0
    g_wall.set(wall_s)
    c_makespan.inc(now)
    prog = sched.program
    budget = (max(n for _, n in prog.tiers.values()) if prog.tiers
              else prog.n_rows)
    return serve_metrics_from_snapshot(
        obsm.delta(snap0, reg.snapshot()),
        mode=mode or ("gang" if sched.gang else "continuous"),
        slots=sched.slots, n_rows=budget,
        pipeline_depth=sched.pipeline_depth)


# ---------------------------------------------------------------------------
# smokes: short Poisson traces against the reduced dit backbone
# ---------------------------------------------------------------------------


def _require(cond: bool, msg: str) -> None:
    """Always-on invariant check for the smokes: unlike `assert`, it
    survives `python -O` — an invariant violation must fail loudly no
    matter how the interpreter was invoked."""
    if not cond:
        raise RuntimeError(f"serving invariant violated: {msg}")


def _build_smoke_sched(arch: str, slots: int, nfe: int, cfg_scale: float,
                       seed: int, pipeline_depth: int, device="cuda",
                       **sched_kw):
    """One reduced-backbone scheduler for the smoke/chaos runs."""
    from ..configs.registry import get_config
    from ..diffusion import VPLinear
    from ..engine import EngineSpec
    from ..launch.sample import build_engine
    from ..models import api

    cfg = get_config(arch).reduced()
    params = api.init_params(cfg, seed, device)
    engine = build_engine(cfg, params, VPLinear(), slots, seed,
                          device=device)
    spec = EngineSpec(solver="unipc", nfe=nfe, cfg_scale=cfg_scale)
    program = engine.build_step(spec)
    sched = SlotScheduler(program, slots,
                          (cfg.patch_tokens, cfg.latent_dim),
                          pipeline_depth=pipeline_depth, **sched_kw)
    return sched, program


def smoke(arch: str = "dit-cifar", slots: int = 2, nfe: int = 4,
          n_requests: int = 5, rate: float = 0.5, cfg_scale: float = 2.0,
          seed: int = 0, pipeline_depth: int = 1,
          device="cuda") -> ServeMetrics:
    """Serve a short Poisson trace end to end and check the scheduler
    invariants: every request completes with a validated-finite latent
    (the on-device done-mask check, surfaced as `Completion.ok`), one
    batched eval per tick, per-request eval bookkeeping adds up, the
    completion clock is monotonic (dispatch-stamped even when readbacks
    trail the pipeline), and completions + rejections partition the
    submissions."""
    sched, program = _build_smoke_sched(arch, slots, nfe, cfg_scale, seed,
                                        pipeline_depth, device)
    reqs = poisson_requests(n_requests, rate, seed=seed,
                            cfg_scales=[1.5, cfg_scale, 4.0])
    m = run_trace(sched, reqs)
    _require(m.completed == n_requests,
             f"{m.completed} of {n_requests} requests completed")
    _require(m.evals == m.ticks, f"{m.evals} evals != {m.ticks} ticks")
    _require(sched.in_flight == 0,
             f"{sched.in_flight} readbacks left in flight")
    _require(all(c.evals == program.n_rows for c in sched.completions),
             "per-request eval bookkeeping does not add up")
    # the always-on output validation path: ok mirrors the on-device
    # finite check folded into the step program's done mask
    _require(all(c.ok for c in sched.completions),
             "a completion failed the on-device finite check")
    _require(m.requests == m.completed + m.rejected,
             f"submissions not partitioned: {m.requests} != "
             f"{m.completed} + {m.rejected}")
    clocks = [c.finish_clock for c in sched.completions]
    _require(clocks == sorted(clocks),
             f"completion clock not monotonic: {clocks}")
    _require(all(c.finish_clock > c.arrival for c in sched.completions),
             "a completion finished before it arrived")
    return m


def chaos(arch: str = "dit-cifar", slots: int = 2, nfe: int = 4,
          n_requests: int = 8, rate: float = 1.0, cfg_scale: float = 2.0,
          seed: int = 0, depths: Sequence[int] = (1, 2, 3),
          device="cuda") -> None:
    """The chaos smoke (DESIGN.md §16): serve the same seeded Poisson trace
    clean and fault-injected, at pipeline depths 1/2/3, and check the
    resilience acceptance properties end to end:

    * NaN fault + forced desync (scenario A): the scheduler never raises,
      every request still completes ok, and every latent — including the
      retried and requeued ones, whose seeds are preserved — is
      bit-identical to the clean run's.
    * Queue-bound shed under ~2x overload (scenario B): submissions are
      partitioned into completions + typed rejections, FIFO order is
      preserved among the accepted, the shed set is identical across
      depths, and every accepted latent is bit-identical to the clean run.
    * Determinism: a repeated run of the same seeded FaultPlan produces an
      identical event ledger and identical completion bookkeeping.
    """
    def requests():
        return poisson_requests(n_requests, rate, seed=seed,
                                cfg_scales=[1.5, cfg_scale, 4.0])

    def run(depth, resilience=None, faults=None):
        sched, _ = _build_smoke_sched(arch, slots, nfe, cfg_scale, seed,
                                      depth, device, resilience=resilience,
                                      faults=faults)
        m = run_trace(sched, requests())
        return sched, m

    # the clean reference: fault-free, resilience at inert defaults
    sched0, m0 = run(1)
    _require(m0.completed == n_requests and all(c.ok for c in
                                                sched0.completions),
             "clean reference run did not complete cleanly")
    clean = {c.rid: np.asarray(c.latent) for c in sched0.completions}

    # scenario A: poisoned eval + corrupted device counter, every depth
    plan = FaultPlan(nans=(NanFault(rid=2, step=1),),
                     metas=(MetaFault(tick=2 * nfe),))
    armed = ResilienceConfig(max_retries=2)
    ledgers = {}
    for depth in depths:
        sched, m = run(depth, resilience=armed, faults=plan)
        _require(m.completed == n_requests,
                 f"[chaos A depth {depth}] {m.completed}/{n_requests} "
                 f"completed under faults")
        _require(all(c.ok for c in sched.completions),
                 f"[chaos A depth {depth}] a failed completion leaked")
        _require(m.faults_injected >= 2 and m.recoveries >= 1,
                 f"[chaos A depth {depth}] faults did not fire "
                 f"(injected={m.faults_injected}, "
                 f"recoveries={m.recoveries})")
        _require(m.requests == m.completed + m.rejected,
                 f"[chaos A depth {depth}] partition broken")
        for c in sched.completions:
            np.testing.assert_array_equal(
                np.asarray(c.latent), clean[c.rid],
                err_msg=f"[chaos A depth {depth}] rid {c.rid} latent "
                        f"differs from the clean run")
        ledgers[depth] = list(sched.events)
    # determinism: same plan, same trace -> identical ledger + bookkeeping
    sched_r, _ = run(depths[0], resilience=armed, faults=plan)
    _require(sched_r.events == ledgers[depths[0]],
             "[chaos A] seeded fault ledger not deterministic across runs")

    # scenario B: bounded queue under ~2x overload, every depth
    bound = ResilienceConfig(max_queue=2)

    def over_requests():
        return poisson_requests(2 * n_requests, 2 * rate, seed=seed + 1,
                                cfg_scales=[1.5, cfg_scale, 4.0])

    sched_c, _ = _build_smoke_sched(arch, slots, nfe, cfg_scale, seed, 1,
                                    device)
    run_trace(sched_c, over_requests())
    clean_b = {c.rid: np.asarray(c.latent) for c in sched_c.completions}
    shed_sets = []
    for depth in depths:
        sched, _ = _build_smoke_sched(arch, slots, nfe, cfg_scale, seed,
                                      depth, device, resilience=bound)
        m = run_trace(sched, over_requests())
        _require(m.rejected > 0,
                 f"[chaos B depth {depth}] 2x overload shed nothing")
        _require(m.requests == m.completed + m.rejected,
                 f"[chaos B depth {depth}] partition broken: "
                 f"{m.requests} != {m.completed} + {m.rejected}")
        admits = [c.admit_tick for c in sched.completions]
        _require(admits == sorted(admits),
                 f"[chaos B depth {depth}] FIFO admission order broken")
        for c in sched.completions:
            np.testing.assert_array_equal(
                np.asarray(c.latent), clean_b[c.rid],
                err_msg=f"[chaos B depth {depth}] rid {c.rid} latent "
                        f"differs from the unbounded run")
        shed_sets.append(frozenset(r.rid for r in sched.rejections))
    _require(len(set(shed_sets)) == 1,
             f"[chaos B] shed set differs across depths: {shed_sets}")
    print(f"chaos ok: {len(depths)} depths, "
          f"A: {n_requests} requests bit-identical under NaN+desync, "
          f"B: {len(shed_sets[0])} shed of {2 * n_requests} under "
          f"2x overload, ledgers deterministic")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="run the scheduler smoke and exit nonzero on "
                         "any invariant violation")
    ap.add_argument("--chaos", action="store_true",
                    help="run the chaos smoke (DESIGN.md §16): the same "
                         "trace clean and fault-injected at pipeline depths "
                         "1/2/3, checking recovery, shed determinism, and "
                         "bit-identical untouched latents")
    ap.add_argument("--arch", default="dit-cifar")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--nfe", type=int, default=4)
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--arrival-rate", type=float, default=0.5,
                    help="requests per tick (one tick = one batched eval)")
    ap.add_argument("--cfg-scale", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="ticks kept in flight; 1 = synchronous loop, "
                         ">= 2 overlaps host bookkeeping with device "
                         "execution (DESIGN.md §13)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain PyTorch path")
    args = ap.parse_args(argv)
    if not (args.smoke or args.chaos):
        ap.error("this entry point runs the scheduler smokes; pass "
                 "--smoke or --chaos (real serving lives in "
                 "repro_torch.launch.serve)")
    if args.chaos:
        chaos(args.arch, slots=args.slots, nfe=args.nfe,
              n_requests=args.requests, rate=args.arrival_rate,
              cfg_scale=args.cfg_scale, seed=args.seed, device=args.device)
        return
    m = smoke(args.arch, slots=args.slots, nfe=args.nfe,
              n_requests=args.requests, rate=args.arrival_rate,
              cfg_scale=args.cfg_scale, seed=args.seed,
              pipeline_depth=args.pipeline_depth, device=args.device)
    print(json.dumps(m.row(), indent=1))
    print(f"smoke ok: {m.completed}/{m.requests} requests, "
          f"{m.evals} evals == {m.ticks} ticks, "
          f"depth {m.pipeline_depth}")


if __name__ == "__main__":
    main()
