"""Request-level slot scheduler for continuous-batching diffusion serving
(the port of `repro.serving.scheduler`).

The engine builds a `StepProgram` (the per-slot step over the solver
table, `SamplerEngine.build_step`); this module owns everything request-
shaped around it: a fixed set of B slots, a FIFO admission queue, per-
request seed / cfg-scale / tier bookkeeping, and finished-latent emission.

One `tick()` = one batched model eval: admit queued requests into free
slots, dispatch `StepProgram.step_flight` once for the whole batch, then
emit every slot that just ran its last row. Because admission resets the
slot's eval ring (and feature cache) and the zero-padded warm-up rows null
empty ring slots, a request admitted mid-flight reproduces the uniform
`build()` run for its own (solver, order, nfe, seed, cfg-scale).

The device side (DESIGN.md §9, §13):

* the slot state, the (4, B) meta counters, the guidance scales and the
  per-slot class ids are the buffers the program handed out
  (`init_state` / `init_meta` / `init_g` / `init_extras`); on the card
  they are the static buffers its CUDA graphs replay on, so everything
  here writes them in place and never rebinds them;
* admission is one fixed-shape masked update per tick: the host fills
  B-wide masks and values in numpy inside one pinned staging buffer, sends
  it in one non-blocking copy and selects it in with `torch.where` — no
  shape depends on how many slots admit, so nothing is recaptured. The
  staging buffer comes from torch's caching host allocator, which keeps it
  from reuse until its copy has run, so staging never waits on the card;
* the readback is a trailing stream: each tick is a `_Flight`. A flight
  with predicted completions owns one of `pipeline_depth` pinned host
  buffers and records one CUDA event after its non-blocking copies of the
  done mask and the padded gather of the finished latents. `_consume`
  waits on that flight's event only, `pipeline_depth - 1` ticks later, and
  returns at once for a flight without completions, as the reference's
  does; a buffer is reused only after its flight was consumed. Nothing
  else in a tick blocks on the card.

`pipeline_depth=1` is the synchronous loop; depth N keeps up to N ticks in
flight. Every depth runs the same program over the same host-predicted
admission schedule, so finished latents, completion order and tick-clock
metrics are bit-identical across depths.

On a cached (feature-reuse) program the host also says, per tick, whether
any slot runs a full row (`deep`): the program then replays its graph with
the deep blocks, else the one without (see `StepProgram`). Idle slots park
on row 0, a full row, as the reference's device-side branch counts them.

Idle slots park on row 0 (an identity update), so the batch shape — and
the captured graphs — never change. `gang=True` degrades admission to
sequential full-batch serving (admit only when every slot is free): the
baseline continuous batching is compared with.

While a `torch.profiler` records, a tick lays its phases on the profiler's
timeline (`obs.trace.live`): ``serve.tick`` encloses ``serve.admission``,
``serve.dispatch`` (the graph's ``engine.launch`` inside it) and, for a
completing flight consumed in the tick, ``serve.readback`` (the event
wait) and ``serve.emit``. The tick's self time is its bookkeeping. A
`flush()` outside a tick books its readbacks and emits outside any tick.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field, replace as dc_replace
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..engine.compiler import DONE_NONFINITE
from ..engine.engine import StepProgram
from ..engine.graphs import readback_sync
from ..obs import trace
from ..obs.metrics import MetricsRegistry
from .faults import FaultInjector, FaultPlan
from .resilience import (DEFAULT_RESILIENCE, FAIL_NONFINITE,
                         REJECT_EXPIRED, REJECT_QUEUE_FULL, Rejection,
                         ResilienceConfig, fallback_tier,
                         validate_resilience)

# fixed upper-bound buckets for the scheduler's streaming histograms
# (DESIGN.md §15): tick-denominated and depth-invariant, so the bucket
# counts are part of the deterministic metrics slice
QUEUE_DEPTH_BUCKETS = (0, 1, 2, 4, 8, 16, 32, 64, 128)
BUSY_SLOT_BUCKETS = (0, 1, 2, 4, 8, 16, 32, 64)
OCCUPANCY_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)
LATENCY_TICK_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
EVAL_COST_BUCKETS = (1, 2, 4, 8, 12, 16, 24, 32, 48, 64)
HOST_PHASES = ("admission", "dispatch", "readback", "bookkeeping")

# resilience / fault-injection event counters (DESIGN.md §16). Registered
# lazily — on the first event of each kind — so a fault-free run's metrics
# snapshot is exactly the pre-resilience snapshot.
EVENT_COUNTER_HELP = {
    "serve_rejected": "requests shed before admission (by reason)",
    "serve_shed_degraded": "requests remapped to the shed tier at submit",
    "serve_retries": "non-finite completions re-admitted on a fallback tier",
    "serve_failed": "failed completions emitted (retry budget exhausted)",
    "serve_desync_recoveries": "host/device desync recoveries",
    "serve_requeued": "in-flight requests requeued by desync recovery",
    "fault_injected": "injected faults that fired (by kind)",
}


class _Layout:
    """Named, 16-byte-aligned segments of one byte buffer: the admission
    staging that crosses to the card in one copy."""

    def __init__(self, fields):
        self.spec = {}
        off = 0
        for name, dtype, shape in fields:
            nbytes = int(np.prod(shape)) * torch.empty(
                (), dtype=dtype).element_size()
            self.spec[name] = (off, dtype, tuple(shape), nbytes)
            off += -(-nbytes // 16) * 16
        self.nbytes = max(off, 16)

    def views(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {name: buf[off:off + n].view(dt).view(shape)
                for name, (off, dt, shape, n) in self.spec.items()}


class _Readback:
    """A completing flight's host buffers (pinned on the card): the done
    mask and the padded latents it reads back, and the event recorded after
    their copies."""

    def __init__(self, slots: int, sample_shape: Tuple[int, ...], dtype,
                 cuda: bool):
        self.mask = torch.zeros(slots, dtype=torch.int32, pin_memory=cuda)
        self.lat = torch.zeros((slots,) + sample_shape, dtype=dtype,
                               pin_memory=cuda)
        self.event = torch.cuda.Event() if cuda else None


def _apply_admission(state, meta, g, extras, new: Dict[str, torch.Tensor]):
    """Fold one tick's admissions into the device state in place: `new`
    holds the full-width (B-wide) masked update values, so no shape depends
    on how many slots admit. Admitted slots get their latent, a zeroed eval
    ring (fresh warm-up), a zeroed feature cache (a reused slot must not
    inherit the previous request's deep features; with the span's full init
    row this reproduces the uniform cached run), their meta counters,
    guidance scale and extras."""
    mask = new["mask"] != 0
    x, E = state[0], state[1]
    x.copy_(torch.where(mask.reshape(mask.shape + (1,) * (x.dim() - 1)),
                        new["x"], x))
    E.masked_fill_(mask.reshape((1,) + mask.shape + (1,) * (E.dim() - 2)),
                   0.0)
    if len(state) > 2:
        C = state[2]
        C.masked_fill_(mask.reshape(mask.shape + (1,) * (C.dim() - 1)), 0.0)
    meta.copy_(torch.where(mask[None, :], new["meta"], meta))
    if "g" in new:
        g.copy_(torch.where(mask, new["g"], g))
    for k, v in extras.items():
        v.copy_(torch.where(mask, new[f"extra:{k}"], v))


def _gather_rows(x: torch.Tensor, done: torch.Tensor) -> torch.Tensor:
    """Fixed-width readback gather: the slots the device flagged done
    first, in slot order, then the others (discarded). The order comes
    from the device done mask (running counts, no sort and no host
    index), so the gather's shape never depends on how many finished."""
    d = (done != 0).to(torch.int64)
    pos = torch.where(d > 0, d.cumsum(0) - 1,
                      d.sum() + (1 - d).cumsum(0) - 1)
    order = torch.empty_like(pos).scatter_(
        0, pos, torch.arange(pos.numel(), device=pos.device))
    return x.index_select(0, order)


def _poison_slot(x: torch.Tensor, slot: int) -> None:
    """Overwrite one slot's latent with NaN in place — fault injection only
    (serving/faults.py); never on the clean path."""
    x[slot].fill_(float("nan"))


def _bump_row(meta: torch.Tensor, slot: int, delta: int) -> None:
    """Corrupt one slot's device row counter in place — fault injection
    only."""
    meta[0, slot].add_(delta)


@dataclass
class Request:
    """One sampling request: a latent to generate under per-request knobs.

    seed draws the initial latent (or pass `x_T`, a host array, explicitly);
    `cfg_scale` overrides the program's nominal guidance scale for this
    request only (cfg-enabled programs); `extras` are per-request model
    conditioning scalars (e.g. {"class_ids": 7}) scattered into the
    scheduler's per-slot extras at admission — the scheduler must be
    constructed with a matching `extras_init`; `arrival` is the request's
    arrival time in tick units — the trace runner (`server.run_trace`)
    submits it once the clock reaches it.
    """

    rid: int
    seed: int = 0
    cfg_scale: Optional[float] = None
    arrival: float = 0.0
    x_T: Optional[object] = None
    extras: Optional[dict] = None
    # quality tier for plan-bank programs (`SamplerEngine.build_bank`):
    # selects which plan's row span this request steps through. Must name a
    # tier of the program's bank; None on single-plan programs.
    tier: Optional[str] = None
    # admission deadline in tick-clock units past `arrival`: a request still
    # queued when its deadline passes is expired at admission time instead
    # of served late (None = the scheduler's ResilienceConfig.default_ttl,
    # itself None = no deadline). Admitted requests always run to the end.
    ttl: Optional[float] = None


@dataclass
class Completion:
    """A finished request with its latent and bookkeeping."""

    rid: int
    latent: np.ndarray
    arrival: float
    admit_tick: int
    finish_tick: int     # executed-step counter when this request finished
    finish_clock: float  # simulated clock time (== finish_tick unless the
                         # trace runner fast-forwarded over idle gaps)
    evals: int           # rows executed = model evals this request consumed
    tier: Optional[str] = None  # the plan-bank tier served (None: single plan)
    # evals-per-latent in FULL-eval units: == evals for uncached programs;
    # below it when the request's row span scheduled shallow feature-reuse
    # evals (StepProgram.span_cost, DESIGN.md §12)
    eval_cost: float = 0.0
    # resilience provenance (DESIGN.md §16): ok=False marks a latent that
    # failed the on-device finite check with the retry budget exhausted
    # (fail_reason says why); retries counts non-finite re-admissions,
    # requeues counts desync-recovery re-admissions; first_tier is the
    # originally requested tier when retry fallback or shed-degrade moved
    # the request off it (None when it was served as requested).
    ok: bool = True
    retries: int = 0
    requeues: int = 0
    first_tier: Optional[str] = None
    fail_reason: Optional[str] = None
    # service on the wall clock, with a tracer attached (None without one):
    # the perf_counter_ns stamps of the request's last admission and of its
    # emission, those of its "admit" and "e" trace events
    admit_ns: Optional[int] = field(default=None, compare=False)
    emit_ns: Optional[int] = field(default=None, compare=False)

    @property
    def latency_ticks(self) -> float:
        """Queue wait + service, in tick units (one tick = one batched eval),
        on the same clock `arrival` is on."""
        return self.finish_clock - self.arrival


@dataclass
class _Flight:
    """One dispatched-but-not-yet-consumed tick: the trailing-readback
    record. `buf` holds its host buffers and event (None on a flight
    without completions, which reads nothing back); `lat` the padded
    latents (rows [0, n_done) are the finished slots in order) and `mask`
    the done mask, both filled once the event has fired. Everything else
    is host metadata stamped at dispatch time, so latency metrics are
    correct no matter how late the flight is consumed."""

    tick: int
    clock: float
    buf: Optional[_Readback] = None
    mask: Optional[torch.Tensor] = None   # host (B,) done codes
    lat: Optional[torch.Tensor] = None    # host (B, *sample), padded
    slots: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    reqs: List[Request] = field(default_factory=list)
    admits: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    budgets: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    offs: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    admit_ns: Optional[np.ndarray] = None   # with a tracer attached


class SlotScheduler:
    """Fixed-B continuous batching over a `StepProgram`.

    `pipeline_depth` is the number of ticks kept in flight (DESIGN.md §13):
    1 = the synchronous loop (every tick's readback is consumed before
    `tick()` returns), N >= 2 dispatches up to N ticks ahead and consumes
    readbacks N-1 ticks late. Admission bookkeeping is host-predicted (the
    solver grid is deterministic), so the admission schedule — and therefore
    every latent — is identical at every depth; the device done mask is
    verified against the prediction at consumption time.

    `tracer=` (an `obs.Tracer`) records tick spans and request lifecycles
    into its ring, and stamps each `Completion`'s `admit_ns` / `emit_ns`;
    `probe=` (an `obs.QualityProbe`) replays a sampled fraction of the
    completions against its high-NFE reference. Both are opt-in: with None
    every call site is skipped and a tick does exactly what it does
    without them. Independently of them, the tick's phases are ranges on a
    recording `torch.profiler`'s timeline (the module docstring); with no
    profiler recording, each such site reads one bool.
    """

    def __init__(self, program: StepProgram, slots: int,
                 sample_shape: Tuple[int, ...], dtype=torch.float32,
                 gang: bool = False, step_override=None,
                 extras_init: Optional[dict] = None,
                 pipeline_depth: int = 1,
                 registry: Optional[MetricsRegistry] = None,
                 tracer=None, probe=None,
                 resilience: Optional[ResilienceConfig] = None,
                 faults: Optional[FaultPlan] = None):
        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, "
                             f"got {pipeline_depth}")
        self.program = program
        self.slots = slots
        self.sample_shape = tuple(sample_shape)
        self.dtype = dtype
        self.gang = gang
        self.pipeline_depth = int(pipeline_depth)
        self.device = torch.device(program.device)
        self._cuda = self.device.type == "cuda"
        self.state = program.init_state(slots, self.sample_shape, dtype)
        self.meta = program.init_meta(slots)
        self.g = program.init_g(slots)
        # per-slot model conditioning (e.g. class ids): one (slots,) column
        # per key, seeded from extras_init and overwritten at admission from
        # Request.extras — conditioning is per-REQUEST, never slot-positional
        self.extras = program.init_extras(slots, dict(extras_init or {}))
        self._extras_init = dict(extras_init or {})
        self.queue: Deque[Request] = deque()
        self.slot_req: List[Optional[Request]] = [None] * slots
        # host mirror of the on-device meta counters, all vectorized numpy:
        # needed for admission (which slots are free), completion prediction
        # (which flight a request's latent rides home on), the cached
        # program's deep/shallow word, and the Completion metadata. The
        # device counters stay authoritative for the program's idx; the done
        # mask is cross-checked at consumption.
        self._busy = np.zeros(slots, bool)
        self.slot_row = np.zeros(slots, np.int64)    # next row (tier-relative)
        self.slot_admit = np.zeros(slots, np.int64)
        self.slot_admit_ns = np.zeros(slots, np.int64)  # with a tracer
        # plan-bank bookkeeping: each slot's row span in the stacked table.
        # Single-plan programs keep offset 0 / budget n_rows for every slot.
        self.slot_off = np.zeros(slots, np.int64)
        self.slot_budget = np.full(slots, program.n_rows, np.int64)
        self.ticks = 0           # batched step calls = batched model evals
        self.evals = 0           # always == ticks (the CI smoke invariant)
        self.active_slot_ticks = 0
        self.shallow_ticks = 0   # cached programs: ticks without deep blocks
        self.clock: Optional[float] = None  # trace runner's simulated time;
                                            # None -> clock follows ticks
        self.completions: List[Completion] = []
        self._inflight: Deque[_Flight] = deque()
        # the admission staging layout and the ring of readback buffers
        self._np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        fields = [("mask", torch.int32, (slots,)),
                  ("x", dtype, (slots,) + self.sample_shape),
                  ("meta", torch.int32, (4, slots))]
        if program.uses_cfg:
            fields.append(("g", torch.float32, (slots,)))
        fields += [(f"extra:{k}", v.dtype, (slots,))
                   for k, v in self.extras.items()]
        self._layout = _Layout(fields)
        self._stage_dev = torch.zeros(self._layout.nbytes, dtype=torch.uint8,
                                      device=self.device)
        self._stage_views = self._layout.views(self._stage_dev)
        self._free: List[_Readback] = [
            _Readback(slots, self.sample_shape, dtype, self._cuda)
            for _ in range(self.pipeline_depth)]
        # resilience policy (DESIGN.md §16): the default config is inert —
        # unbounded queue, no TTL, no retries — so a scheduler built without
        # one behaves bit-identically to the plain loop until a fault fires.
        # `rejections` partitions submissions together with `completions`;
        # `events` is the deterministic resilience / fault ledger (plain
        # tuples, compared across chaos runs).
        self.resilience = validate_resilience(
            resilience if resilience is not None else DEFAULT_RESILIENCE,
            program)
        self.rejections: List[Rejection] = []
        self.events: List[tuple] = []
        self._injector = (FaultInjector(faults, ledger=self.events)
                          if faults else None)
        self._rstate: Dict[int, dict] = {}  # rid -> retry/requeue provenance
        self._recoveries = 0
        # host-overhead accounting, split by tick phase (DESIGN.md §15), with
        # the reference's definitions: admission = the _admit() call,
        # dispatch = the step call itself (on the card: the host's launch of
        # the graph replay), readback = time blocked on flight events in
        # _consume, bookkeeping = everything else in tick(). `host_ns` is
        # admission + bookkeeping.
        self._admission_ns = 0
        self._blocked_ns = 0
        self._dispatch_ns = 0
        self._bookkeeping_ns = 0
        self._probe_ns = 0  # quality-probe replays (excluded from phases)
        # observability (DESIGN.md §15): the registry is always on — it is
        # the one accounting substrate ServeMetrics is derived from — while
        # the tracer and quality probe are opt-in (None = zero work: every
        # call site is `if self.tracer is not None`-guarded).
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer
        self.probe = probe
        if probe is not None:
            if probe.registry is None:
                probe.registry = self.registry
            if probe.tracer is None:
                probe.tracer = tracer
        r = self.registry
        self._m_ticks = r.counter(
            "serve_ticks", help="executed batched step calls")
        self._m_evals = r.counter(
            "serve_evals", help="batched model evals (== serve_ticks)")
        self._m_active = r.counter(
            "serve_active_slot_ticks", help="busy-slot ticks")
        self._m_submitted = r.counter(
            "serve_submitted", help="requests submitted")
        self._m_admitted = r.counter(
            "serve_admitted", help="requests admitted into slots")
        self._m_completed = r.counter(
            "serve_completed", help="requests completed")
        self._m_queue = r.histogram(
            "queue_depth", QUEUE_DEPTH_BUCKETS,
            help="queued requests per executed tick (post-admission)")
        self._m_busy = r.histogram(
            "busy_slots", BUSY_SLOT_BUCKETS,
            help="busy slots per executed tick")
        self._m_occ = r.histogram(
            "occupancy_frac", OCCUPANCY_BUCKETS,
            help="busy-slot fraction per executed tick")
        self._m_latency = r.histogram(
            "latency_ticks", LATENCY_TICK_BUCKETS,
            help="request latency (queue wait + service) in ticks")
        self._m_cost = r.histogram(
            "request_eval_cost", EVAL_COST_BUCKETS,
            help="evals-per-latent (full-eval units) per completion")
        self._m_phase = {p: r.counter("host_phase_ns", {"phase": p},
                                      wall=True,
                                      help="host ns per tick phase")
                         for p in HOST_PHASES}
        # step_override replaces the dispatched flight step — signature
        # step(state, meta, g, extras) -> (state, meta, done), and the done
        # mask must be consistent with the meta counters (it is verified
        # against the host prediction whenever a completion is consumed)
        self._flight = (step_override if step_override is not None
                        else program.step_flight)
        # a cached program's deep/shallow word goes to its own flight step
        self._cached = (program.row_reuse is not None
                        and step_override is None)

    # -- queue / slots -------------------------------------------------------
    def _count_event(self, name: str, labels: Optional[dict] = None,
                     n: int = 1) -> None:
        """Bump a lazily-registered resilience/fault counter."""
        self.registry.counter(name, labels,
                              help=EVENT_COUNTER_HELP[name]).inc(n)

    def submit(self, req: Request) -> Optional[Rejection]:
        """Queue a request, or shed it under overload control.

        Returns None when the request was accepted, or the typed
        `Rejection` handed back to the traffic source when the bounded
        queue shed it (also appended to `self.rejections`). Malformed
        requests — bad tier tag, unknown extras, guidance on an unguided
        program — still raise: those are programmer errors, not load."""
        if (req.cfg_scale is not None and float(req.cfg_scale) != 0.0
                and not self.program.uses_cfg):
            raise ValueError(
                f"request rid={req.rid} carries cfg_scale={req.cfg_scale} "
                f"but the step program was compiled without guidance; "
                f"build the engine spec with cfg_scale != 0")
        unknown = set(req.extras or {}) - set(self.extras)
        if unknown:
            raise ValueError(
                f"request rid={req.rid} carries extras {sorted(unknown)} the "
                f"scheduler was not constructed for; pass extras_init with "
                f"matching keys")
        self.program.resolve_tier(req.tier)  # reject bad tier tags at submit
        self._m_submitted.inc()
        cfg = self.resilience
        if (cfg.max_queue is not None
                and len(self.queue) >= cfg.max_queue):
            return self._reject(req, REJECT_QUEUE_FULL)
        if (cfg.shed_policy == "degrade"
                and cfg.degrade_watermark is not None
                and len(self.queue) >= cfg.degrade_watermark
                and req.tier != cfg.degrade_tier):
            # shed by degrading instead of dropping: past the watermark new
            # requests are remapped to the cheap tier, recording provenance
            self._rprov(req.rid)["first_tier"] = req.tier
            req = dc_replace(req, tier=cfg.degrade_tier)
            self.events.append(("shed_degrade", req.arrival, req.rid))
            self._count_event("serve_shed_degraded")
        self.queue.append(req)
        if self.tracer is not None:
            self.tracer.async_begin("request", req.rid,
                                    args={"tier": req.tier,
                                          "arrival": req.arrival})
        return None

    def _rprov(self, rid: int) -> dict:
        """This rid's resilience provenance record (created on first use;
        stamped onto its Completion and dropped at emission)."""
        return self._rstate.setdefault(
            rid, {"retries": 0, "requeues": 0, "first_tier": None})

    def _reject(self, req: Request, reason: str,
                clock: Optional[float] = None) -> Rejection:
        rej = Rejection(rid=req.rid, reason=reason, arrival=req.arrival,
                        clock=req.arrival if clock is None else clock,
                        tier=req.tier)
        self.rejections.append(rej)
        self.events.append(("reject", rej.clock, req.rid, reason))
        self._rstate.pop(req.rid, None)
        self._count_event("serve_rejected", {"reason": reason})
        if self.tracer is not None:
            if reason == REJECT_EXPIRED:
                # the lifecycle span opened at submit: close it as expired
                self.tracer.async_end("request", req.rid,
                                      args={"rejected": reason,
                                            "tier": req.tier})
            else:
                # queue_full sheds before the span opens: a lone instant
                self.tracer.instant("reject", cat="request",
                                    args={"rid": req.rid, "reason": reason})
        return rej

    @property
    def active(self) -> int:
        return int(self._busy.sum())

    @property
    def in_flight(self) -> int:
        """Dispatched ticks whose readback has not been consumed yet."""
        return len(self._inflight)

    @property
    def host_ns(self) -> int:
        """Accumulated host-side bookkeeping time across tick() calls,
        excluding time blocked on flight events and the step dispatch call
        itself (== the admission + bookkeeping phases)."""
        return self._admission_ns + self._bookkeeping_ns

    @property
    def phase_ns(self) -> dict:
        """Per-phase host time (DESIGN.md §15): {phase: ns} over the
        HOST_PHASES split. admission + bookkeeping == `host_ns`."""
        return {"admission": self._admission_ns,
                "dispatch": self._dispatch_ns,
                "readback": self._blocked_ns,
                "bookkeeping": self._bookkeeping_ns}

    @property
    def occupancy(self) -> float:
        """Mean fraction of slots doing useful work per tick."""
        return (self.active_slot_ticks / (self.ticks * self.slots)
                if self.ticks else 0.0)

    def _draw(self, req: Request) -> np.ndarray:
        """The request's initial latent, as host numpy (it is written into
        the full-width admission staging, not shipped per request). A seeded
        draw comes from a CPU `torch.Generator` seeded with `req.seed`: the
        same numbers on every device, but not the reference's `jax.random`
        ones — pass `x_T` to serve the reference's latents."""
        if req.x_T is not None:
            x = req.x_T
            if torch.is_tensor(x):
                x = x.detach().cpu().numpy()
            return np.asarray(x, self._np_dtype)
        gen = torch.Generator().manual_seed(int(req.seed))
        return torch.randn(self.sample_shape, generator=gen,
                           dtype=self.dtype).numpy()

    def _expired(self, req: Request, admit_now: float) -> bool:
        """Deadline check at admission time (DESIGN.md §16): a queued
        request whose TTL elapsed before a slot freed is expired, never
        served late. Admitted requests are exempt by construction."""
        ttl = req.ttl if req.ttl is not None else self.resilience.default_ttl
        return ttl is not None and admit_now - req.arrival > ttl

    def _admit(self) -> None:
        if self.gang and self._busy.any():
            return  # sequential full-batch baseline: drain before refilling
        if not self.queue:
            return
        free = np.flatnonzero(~self._busy)
        if free.size == 0:
            return
        # the admission clock: the simulated time this tick's admissions
        # happen at (the trace runner advances `clock` to now+1 pre-tick).
        # A skew fault shifts it — the chaos stand-in for a stalled host.
        admit_now = (float(self.ticks) if self.clock is None
                     else self.clock - 1.0)
        if self._injector is not None:
            skew = self._injector.take_skew(self.ticks + 1)
            if skew:
                admit_now += skew
                self.events.append(("fault_skew", self.ticks + 1, skew))
                self._count_event("fault_injected", {"kind": "skew"})
        reqs: List[Request] = []
        while self.queue and len(reqs) < free.size:
            r = self.queue.popleft()
            if self._expired(r, admit_now):
                self._reject(r, REJECT_EXPIRED, clock=admit_now)
                continue
            reqs.append(r)
        n = len(reqs)
        if n == 0:
            return
        taken = free[:n]
        offs = np.empty(n, np.int64)
        budgets = np.empty(n, np.int64)
        for j, r in enumerate(reqs):
            offs[j], budgets[j] = self.program.resolve_tier(r.tier)
            self.slot_req[int(taken[j])] = r
        # vectorized host bookkeeping: one fancy-indexed write per array
        self._busy[taken] = True
        self.slot_row[taken] = 0
        self.slot_off[taken] = offs
        self.slot_budget[taken] = budgets
        self.slot_admit[taken] = self.ticks
        self._m_admitted.inc(n)
        if self.tracer is not None:
            # the admit instant opens the request's step segment: rows
            # [offset, offset + budget) execute over the next `budget` ticks
            now = time.perf_counter_ns()
            self.slot_admit_ns[taken] = now
            for j, r in enumerate(reqs):
                self.tracer.async_instant(
                    "admit", r.rid,
                    args={"slot": int(taken[j]), "tick": self.ticks,
                          "offset": int(offs[j]), "budget": int(budgets[j]),
                          "tier": r.tier}, ts_ns=now)
        # full-width masked update buffers, written in numpy into one pinned
        # staging buffer, sent in one copy and folded into the device state
        # by one fixed-shape apply. The buffer is a fresh one from torch's
        # caching host allocator: the non-blocking copy records an event on
        # it, and the allocator hands it out again only once that has fired
        stage = torch.zeros(self._layout.nbytes, dtype=torch.uint8,
                            pin_memory=self._cuda)
        new = {k: v.numpy() for k, v in self._layout.views(stage).items()}
        new["mask"][taken] = 1
        for j, r in enumerate(reqs):
            new["x"][taken[j]] = self._draw(r)
        # on-device counters: row 0, the tier's span, busy
        new["meta"][1, taken] = offs
        new["meta"][2, taken] = budgets
        new["meta"][3, taken] = 1
        if self.program.uses_cfg:
            new["g"][taken] = [float(r.cfg_scale) if r.cfg_scale is not None
                               else float(self.program.spec.cfg_scale or 0.0)
                               for r in reqs]
        for k in self.extras:
            new[f"extra:{k}"][taken] = [
                (r.extras or {}).get(k, self._extras_init[k]) for r in reqs]
        self._stage_dev.copy_(stage, non_blocking=True)
        _apply_admission(self.state, self.meta, self.g, self.extras,
                         self._stage_views)

    def _deep(self) -> bool:
        """A cached program's word for this tick: whether any slot runs a
        full row. From the host mirror — busy slots at offset + row, idle
        slots parked on row 0, a full row — and the host copy of the
        table's reuse column."""
        idx = np.where(self._busy, self.slot_off + self.slot_row, 0)
        reuse = self.program.row_reuse
        return not bool(reuse[np.clip(idx, 0, len(reuse) - 1)].all())

    # -- the serving step ----------------------------------------------------
    def tick(self) -> List[Completion]:
        """Admit, dispatch ONE batched step, consume due readbacks.

        At pipeline_depth=1 the returned completions are this tick's; at
        depth N they are the completions of the tick dispatched N-1 ticks
        ago (its readback has had N-1 device ticks to land).

        A recording profiler gets a ``serve.tick`` range for a call with a
        busy slot or a queued request: every executed tick, and a call
        whose queue held only requests that expire at admission."""
        if not (trace.profiling() and (self.queue or self._busy.any())):
            return self._tick()
        with trace.live("serve.tick"):
            return self._tick()

    def _tick(self) -> List[Completion]:
        t0 = time.perf_counter_ns()
        b0 = self._blocked_ns
        p0 = self._probe_ns
        with trace.live("serve.admission"):
            self._admit()
        a1 = time.perf_counter_ns()
        adm_ns = a1 - t0
        self._admission_ns += adm_ns
        busy = self._busy
        if not busy.any():
            book_ns = time.perf_counter_ns() - a1
            self._bookkeeping_ns += book_ns
            self._m_phase["admission"].inc(adm_ns)
            self._m_phase["bookkeeping"].inc(book_ns)
            return []
        self.ticks += 1
        self.evals += 1
        n_busy = int(busy.sum())
        self.active_slot_ticks += n_busy
        self._m_ticks.inc()
        self._m_evals.inc()
        self._m_active.inc(n_busy)
        self._m_queue.observe(len(self.queue))
        self._m_busy.observe(n_busy)
        self._m_occ.observe(n_busy / self.slots)
        if self._injector is not None:
            self._inject()
        kw = {}
        if self._cached:
            kw["deep"] = self._deep()
            self.shallow_ticks += not kw["deep"]
        # dispatch: idx construction and row advance happen on the device
        # (StepProgram.step_flight); nothing tick-varying crosses from the
        # host here
        d0 = time.perf_counter_ns()
        with trace.live("serve.dispatch"):
            self.state, self.meta, mask = self._flight(
                self.state, self.meta, *self._step_tail(), **kw)
        d1 = time.perf_counter_ns()
        flight = _Flight(
            tick=self.ticks,
            clock=(float(self.ticks) if self.clock is None else self.clock))
        # host prediction of this tick's completions (the grid is
        # deterministic): vectorized row advance + budget compare
        self.slot_row[busy] += 1
        done_mask = busy & (self.slot_row >= self.slot_budget)
        if done_mask.any():
            slots_done = np.flatnonzero(done_mask)
            flight.slots = slots_done
            flight.reqs = [self.slot_req[int(s)] for s in slots_done]
            flight.admits = self.slot_admit[slots_done].copy()
            flight.budgets = self.slot_budget[slots_done].copy()
            flight.offs = self.slot_off[slots_done].copy()
            if self.tracer is not None:
                flight.admit_ns = self.slot_admit_ns[slots_done].copy()
            # the trailing readback stream: the done mask and ONE padded
            # gather of the finished slots' latents, copied to this flight's
            # host buffers without blocking, then its event. They are queued
            # before the next tick's replay, so they read this tick's output
            # before the static buffers are updated again.
            buf = self._free.pop()
            buf.mask.copy_(mask, non_blocking=True)
            buf.lat.copy_(_gather_rows(self.state[0], mask),
                          non_blocking=True)
            if buf.event is not None:
                buf.event.record()
            flight.buf, flight.mask, flight.lat = buf, buf.mask, buf.lat
            # free the slots now (host prediction): the next dispatch may
            # re-admit into them without draining the pipeline
            for s in slots_done:
                self.slot_req[int(s)] = None
            self._busy[done_mask] = False
            self.slot_row[done_mask] = 0
            self.slot_off[done_mask] = 0
        self._inflight.append(flight)
        done: List[Completion] = []
        while len(self._inflight) > self.pipeline_depth - 1:
            done.extend(self._consume(self._inflight.popleft()))
        t1 = time.perf_counter_ns()
        book_ns = (t1 - t0 - adm_ns - (d1 - d0)
                   - (self._blocked_ns - b0) - (self._probe_ns - p0))
        self._dispatch_ns += d1 - d0
        self._bookkeeping_ns += book_ns
        self._m_phase["admission"].inc(adm_ns)
        self._m_phase["dispatch"].inc(d1 - d0)
        self._m_phase["readback"].inc(self._blocked_ns - b0)
        self._m_phase["bookkeeping"].inc(book_ns)
        if self.tracer is not None:
            tr = self.tracer
            tr.complete("admission", t0, a1)
            tr.complete("dispatch", d0, d1)
            tr.complete("tick", t0, t1,
                        args={"tick": self.ticks, "busy": n_busy,
                              "queue": len(self.queue),
                              "emitted": len(done)})
            tr.counter("slots", {"busy": n_busy, "queue": len(self.queue)},
                       ts_ns=t0)
        return done

    def _inject(self) -> None:
        """Fire the armed faults due this tick (serving/faults.py), after
        admission and before dispatch, in place on the device state — the
        step program itself is never altered, so chaos tests exercise the
        real serving path. `self.ticks` already names the tick about to
        dispatch; `slot_row` still holds the row about to run."""
        inj = self._injector
        for s in np.flatnonzero(self._busy):
            req = self.slot_req[int(s)]
            fault = inj.take_nan(req.rid, int(self.slot_row[s]))
            if fault is not None:
                _poison_slot(self.state[0], int(s))
                self.events.append(("fault_nan", self.ticks, req.rid,
                                    int(self.slot_row[s])))
                self._count_event("fault_injected", {"kind": "nan"})
                if self.tracer is not None:
                    self.tracer.async_instant(
                        "fault_nan", req.rid,
                        args={"tick": self.ticks,
                              "step": int(self.slot_row[s])})
        mf = inj.take_meta(self.ticks)
        if mf is not None:
            slot = mf.slot
            if slot is None:
                busy = np.flatnonzero(self._busy)
                slot = int(busy[0]) if busy.size else None
            if slot is not None:
                _bump_row(self.meta, int(slot), int(mf.delta))
                self.events.append(("fault_meta", self.ticks, slot,
                                    mf.delta))
                self._count_event("fault_injected", {"kind": "meta"})
                if self.tracer is not None:
                    self.tracer.instant("fault_meta", cat="tick",
                                        args={"tick": self.ticks,
                                              "slot": slot,
                                              "delta": mf.delta})

    def _land(self, f: _Flight) -> None:
        """Wait for a flight's event (its copies have landed) and give its
        buffers back to the ring."""
        if f.buf is None:
            return
        if f.buf.event is not None:
            with readback_sync(self.device):
                f.buf.event.synchronize()
        self._free.append(f.buf)
        f.buf = None

    def _consume(self, f: _Flight) -> List[Completion]:
        """Materialize one flight's readback: verify the on-device done mask
        against the host prediction and emit the finished latents. A
        flight without completions read nothing back and is not waited on;
        `readback` counts only the wait for, and the copy out of, a
        completing flight's buffers, as in the reference."""
        if not f.slots.size:
            return []
        tb = time.perf_counter_ns()
        with trace.live("serve.readback"):
            self._land(f)
            mask_np = f.mask.numpy().copy()
            lat_np = f.lat.numpy()[:f.slots.size].copy()
        te = time.perf_counter_ns()
        self._blocked_ns += te - tb
        with trace.live("serve.emit"):
            emitted = self._emit(f, mask_np, lat_np, tb, te)
        if self.probe is not None:
            # replay a sampled fraction against the high-NFE reference; the
            # replay is device work, not scheduler bookkeeping — timed apart
            # so it never pollutes the per-phase host accounting. Failed
            # completions are never probed (their latent is non-finite).
            pp0 = time.perf_counter_ns()
            for req, c in emitted:
                if c.ok and self.probe.selected(c.rid):
                    self.probe.observe(req, c, self._draw(req))
            self._probe_ns += time.perf_counter_ns() - pp0
        return [c for _, c in emitted]

    def _emit(self, f: _Flight, mask_np: np.ndarray, lat_np: np.ndarray,
              tb: int, te: int) -> List[Tuple[Request, Completion]]:
        """A landed flight's completions, with the requests they serve:
        the done mask checked against the prediction (a desync recovers
        and emits nothing), failed latents retried, the rest recorded in
        the completions, the registry and the tracer."""
        got = np.flatnonzero(mask_np)
        if not np.array_equal(got, f.slots):
            if self.resilience.recovery == "raise":
                raise RuntimeError(
                    f"on-device done mask {got.tolist()} disagrees with the "
                    f"host completion prediction {f.slots.tolist()} at tick "
                    f"{f.tick} — scheduler bookkeeping desynchronized from "
                    f"the step program")
            return self._recover(f, got)
        # on-device output validation (DESIGN.md §16): the done mask is
        # coded, and DONE_NONFINITE marks a finished slot whose latent
        # failed the finite check inside the step program. Those requests
        # re-admit on the fallback chain while retry budget remains; only
        # exhaustion emits a (marked-failed) completion.
        bad = mask_np[f.slots] == DONE_NONFINITE
        cfg = self.resilience
        emitted: List[Tuple[Request, Completion]] = []
        for j, req in enumerate(f.reqs):
            if bad[j]:
                prov = self._rprov(req.rid)
                if prov["retries"] < cfg.max_retries:
                    self._retry(req, f, prov)
                    continue
            prov = self._rstate.pop(req.rid, None) or {}
            c = Completion(
                rid=req.rid, latent=lat_np[j], arrival=req.arrival,
                admit_tick=int(f.admits[j]), finish_tick=f.tick,
                finish_clock=f.clock, evals=int(f.budgets[j]),
                tier=req.tier,
                eval_cost=self.program.span_cost(int(f.offs[j]),
                                                 int(f.budgets[j])),
                ok=not bool(bad[j]),
                retries=int(prov.get("retries", 0)),
                requeues=int(prov.get("requeues", 0)),
                first_tier=prov.get("first_tier"),
                fail_reason=FAIL_NONFINITE if bad[j] else None,
                admit_ns=(int(f.admit_ns[j]) if f.admit_ns is not None
                          else None))
            if not c.ok:
                self.events.append(("failed", f.tick, c.rid))
                self._count_event("serve_failed")
            emitted.append((req, c))
        done = [c for _, c in emitted]
        self.completions.extend(done)
        reg = self.registry
        for c in done:
            self._m_completed.inc()
            self._m_latency.observe(c.latency_ticks)
            self._m_cost.observe(c.eval_cost)
            if c.tier is not None:
                lbl = {"tier": c.tier}
                reg.counter("tier_completed", lbl,
                            help="completions per quality tier").inc()
                reg.gauge("tier_evals", lbl,
                          help="evals per request of this tier").set(c.evals)
                reg.gauge("tier_eval_cost", lbl,
                          help="evals-per-latent (full-eval units) of this "
                               "tier").set(c.eval_cost)
                reg.histogram("tier_latency_ticks", LATENCY_TICK_BUCKETS,
                              lbl, help="per-tier request latency in "
                                        "ticks").observe(c.latency_ticks)
        if self.tracer is not None:
            now = time.perf_counter_ns()
            for c in done:
                c.emit_ns = now
                args = {"tier": c.tier, "evals": c.evals,
                        "eval_cost": c.eval_cost,
                        "latency_ticks": c.latency_ticks,
                        "admit_tick": c.admit_tick,
                        "finish_tick": c.finish_tick}
                if not c.ok or c.retries or c.requeues:
                    args.update(ok=c.ok, retries=c.retries,
                                requeues=c.requeues,
                                fail_reason=c.fail_reason)
                self.tracer.async_end("request", c.rid, args=args, ts_ns=now)
            self.tracer.complete("readback", tb, te)
            self.tracer.complete("emit", te, time.perf_counter_ns())
        return emitted

    def _retry(self, req: Request, f: _Flight, prov: dict) -> None:
        """Re-admit a request whose finished latent failed validation:
        seed and x_T preserved (the retry re-draws the identical initial
        latent), tier advanced along the fallback chain, and the request
        put at the queue FRONT — it has waited longest."""
        nxt = fallback_tier(self.resilience, req.tier)
        if nxt != req.tier and prov["first_tier"] is None:
            prov["first_tier"] = req.tier
        prov["retries"] += 1
        self.events.append(("retry", f.tick, req.rid, req.tier, nxt))
        self._count_event("serve_retries")
        if self.tracer is not None:
            self.tracer.async_instant(
                "retry", req.rid,
                args={"tick": f.tick, "from": req.tier, "to": nxt,
                      "attempt": prov["retries"]})
        self.queue.appendleft(req if nxt == req.tier
                              else dc_replace(req, tier=nxt))

    def _recover(self, f: _Flight, got: np.ndarray) -> List[Completion]:
        """Desync recovery (DESIGN.md §16): the device done mask disagreed
        with the host's predicted completion schedule. Drain the pipeline
        (every in-flight readback is suspect), re-derive the host slot
        mirrors from the authoritative device `meta` counters — slots whose
        host and device bookkeeping still agree keep running untouched —
        and requeue every affected request to re-serve from scratch (seed
        preserved, so a recovered request's latent still reproduces the
        clean run). Returns no completions."""
        self._recoveries += 1
        if self._recoveries > self.resilience.max_recoveries:
            raise RuntimeError(
                f"desync recovery limit ({self.resilience.max_recoveries}) "
                f"exhausted: on-device done mask {got.tolist()} still "
                f"disagrees with the host completion prediction "
                f"{f.slots.tolist()} at tick {f.tick} — the step program "
                f"and scheduler bookkeeping cannot re-synchronize")
        affected: List[Request] = list(f.reqs)
        while self._inflight:
            g = self._inflight.popleft()
            self._land(g)
            affected.extend(g.reqs)
        with readback_sync(self.device):   # the authoritative counters
            meta_dev = self.meta.cpu().numpy().copy()
        nr = self.program.n_rows
        for s in range(self.slots):
            host_busy = bool(self._busy[s])
            dev_busy = bool(meta_dev[3, s])
            if not host_busy and not dev_busy:
                continue
            if (host_busy and dev_busy
                    and int(meta_dev[0, s]) == int(self.slot_row[s])
                    and int(meta_dev[1, s]) == int(self.slot_off[s])
                    and int(meta_dev[2, s]) == int(self.slot_budget[s])):
                continue  # mirrors agree: the slot keeps running
            req = self.slot_req[s]
            if req is not None:
                affected.append(req)
            self.slot_req[s] = None
            self._busy[s] = False
            self.slot_row[s] = 0
            self.slot_off[s] = 0
            self.slot_budget[s] = nr
            meta_dev[:, s] = (0, 0, nr, 0)
        with readback_sync(self.device):   # in place: graphs replay on it
            self.meta.copy_(torch.from_numpy(meta_dev))
        # requeue at the queue front in original arrival order: recovered
        # requests were in service before anything still queued
        affected.sort(key=lambda r: (r.arrival, r.rid))
        for r in reversed(affected):
            self._rprov(r.rid)["requeues"] += 1
            self.queue.appendleft(r)
        self.events.append(("desync", f.tick,
                            tuple(r.rid for r in affected)))
        self._count_event("serve_desync_recoveries")
        if affected:
            self._count_event("serve_requeued", n=len(affected))
        if self.tracer is not None:
            self.tracer.instant(
                "desync_recover", cat="tick",
                args={"tick": f.tick, "got": got.tolist(),
                      "predicted": f.slots.tolist(),
                      "requeued": [r.rid for r in affected]})
            for r in affected:
                self.tracer.async_instant("requeue", r.rid,
                                          args={"tick": f.tick})
        return []

    def flush(self) -> List[Completion]:
        """Consume every in-flight readback (blocking). The trace runner
        calls it once the arrival stream is exhausted. May leave work
        REQUEUED (a consumed readback can trigger a retry or a desync
        recovery) — callers must re-check `queue`/`active` after flushing,
        as `drain` and `run_trace` do."""
        done: List[Completion] = []
        while self._inflight:
            done.extend(self._consume(self._inflight.popleft()))
        return done

    def drain(self) -> List[Completion]:
        """Tick until every queued and in-flight request has finished —
        including requests the resilience layer requeued mid-drain."""
        out: List[Completion] = []
        while True:
            while self.queue or self.active:
                out.extend(self.tick())
            out.extend(self.flush())
            if not (self.queue or self.active):
                return out

    def fence(self) -> None:
        """Block until the card has run every dispatched tick: the
        reference's `block_until_ready(state)`, which the trace runner
        calls after each tick at depth 1 to clock it. A designed sync, made
        outside `tick()` and booked in no host phase."""
        if self._cuda:
            with readback_sync(self.device):
                torch.cuda.current_stream(self.device).synchronize()

    def _step_tail(self):
        """Trailing step args after (state, meta) — identical for every tick
        and for the capture, so the graphs' signatures always match."""
        return (self.g if self.program.uses_cfg else None,
                self.extras if self.extras else None)

    # -- ahead-of-time capture (the reference's AOT compile) -----------------
    def aot_compile(self) -> float:
        """Capture the flight step's CUDA graphs now — both of a cached
        program's — and return the seconds it took, so no capture lands
        inside the first timed tick. The state is left as it was. On the
        CPU, or with a step override, there is nothing to capture."""
        t0 = time.perf_counter()
        if self._flight is self.program.step_flight:
            self.program.capture_flight(self.state, self.meta,
                                        *self._step_tail())
            if self._cuda:
                torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0
