"""The open-loop serving driver: requests arrive on the wall clock at the
traffic's rate (`arrivals.py`), each with its own latent, class and DiT
guidance scale drawn from the seed, and the port's continuous-batching
scheduler (`serving/scheduler.py:SlotScheduler` over
`SamplerEngine.build_step`) serves them.

One host thread submits every request that is due, ticks the scheduler
while it has work, collects a trailing readback when only that is left,
and sleeps to the next due time when it has none. A request's latency runs
from its due time to the moment its latent is on the host; its queue wait
from its due time to the start of the tick that admitted it. Requests due
in the window are served to the end: after the window closes nothing new
is due, and the scheduler is drained for at most `drain_limit_s`.

The check compares a sample of the completed requests drawn from the
seed, the one with the longest latency among them.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from perfbench import arrivals, harness, program

WARMUP_ROUNDS = 2     # full slot loads served before the window


@dataclasses.dataclass
class State:
    cfg: dict
    traffic: dict
    seed: int
    device: torch.device
    sched: object
    x_T: np.ndarray = None
    classes: np.ndarray = None
    w: np.ndarray = None
    done: dict = dataclasses.field(default_factory=dict)   # rid -> latent
    ok: dict = dataclasses.field(default_factory=dict)     # rid -> bool


def request_inputs(cfg: dict, traffic: dict, seed: int, n: int, device):
    """n requests' latents (host, float32), classes and guidance scales:
    the scales the traffic lists, in equal shares, in an order drawn from
    the seed."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    x_T = torch.randn((n,) + harness.sample_shape(cfg), generator=gen,
                      device=device, dtype=torch.float32)
    classes = torch.randint(0, max(cfg["num_classes"], 1), (n,),
                            generator=gen, device=device)
    scales = np.resize(np.asarray(traffic["guidance_w"], np.float64), n)
    np.random.default_rng([int(seed), 13]).shuffle(scales)
    return x_T.cpu().numpy(), classes.cpu().numpy(), scales


def _request(s: State, rid: int, x_T, cls, w):
    """The port's Request; its arrival is on the scheduler's tick clock."""
    from repro_torch.serving.scheduler import Request

    return Request(rid=rid, cfg_scale=float(w) - 1.0, x_T=x_T,
                   extras={"class_ids": int(cls)},
                   arrival=float(s.sched.ticks))


def setup(cfg, traffic, seed, device, params, quant, tracer,
          part=lambda name: None) -> State:
    """The scheduler built over the port's step program and every path of a
    tick warmed; `part(name)` marks the end of each part of set-up."""
    from repro_torch.serving.scheduler import SlotScheduler

    if not cfg["conditional"]:
        raise ValueError("the open-loop driver serves guided requests")
    slots = traffic["slots"]
    eng = program.engine(cfg, params, slots, seed, quant, device)
    prog = eng.build_step(program.spec(cfg, traffic, quant,
                                       traffic["guidance_w"][0]))
    sched = SlotScheduler(prog, slots, harness.sample_shape(cfg),
                          pipeline_depth=traffic["pipeline_depth"],
                          extras_init={"class_ids": 0})
    part("engine")
    sched.aot_compile()
    part("build")
    s = State(cfg, traffic, seed, device, sched)
    # every path of a tick (admission, replay, readback, a flush) on
    # requests of their own before the window
    n = WARMUP_ROUNDS * slots
    x_T, cls, w = request_inputs(cfg, traffic, seed + 1, n, device)
    for i in range(n):
        sched.submit(_request(s, -1 - i, x_T[i], cls[i], w[i]))
    sched.drain()
    part("warmup")
    return s


def window(s: State, seconds: float, tracer) -> harness.Run:
    sched, tr = s.sched, tracer
    due = arrivals.due_times(s.traffic["arrivals"], s.seed, seconds)
    n = len(due)
    s.x_T, s.classes, s.w = request_inputs(s.cfg, s.traffic, s.seed, n,
                                           s.device)
    submit = np.full(n, np.nan)
    done_t: dict = {}
    tick_start: dict = {}
    admit_tick: dict = {}
    drain_limit = float(s.traffic["drain_limit_s"])

    def serve(now: float) -> None:
        if sched.queue or sched.active:
            tick_start[sched.ticks] = now
            with tr.range("bench.tick"):
                comps = sched.tick()
        else:
            with tr.range("bench.flush"):
                comps = sched.flush()
        t = time.perf_counter()
        for c in comps:
            done_t[c.rid] = t
            admit_tick[c.rid] = c.admit_tick
            s.done[c.rid] = c.latent
            s.ok[c.rid] = bool(c.ok)

    def submit_due(now: float, t0: float, i: int) -> int:
        with tr.range("bench.submit"):
            while i < n and t0 + due[i] <= now:
                sched.submit(_request(s, i, s.x_T[i], s.classes[i],
                                      s.w[i]))
                submit[i] = time.perf_counter()
                i += 1
        return i

    ticks0, host0 = sched.ticks, sched.host_ns
    i = 0
    with tr.range("bench.window"):
        t0 = time.perf_counter()
        close = t0 + seconds
        while True:
            now = time.perf_counter()
            if now >= close:
                break
            i = submit_due(now, t0, i)
            if sched.queue or sched.active or sched.in_flight:
                serve(now)
            else:
                nxt = min(t0 + due[i], close) if i < n else close
                with tr.range("bench.idle"):
                    time.sleep(max(0.0, nxt - time.perf_counter()))
        ticks, host_ns = sched.ticks - ticks0, sched.host_ns - host0
        window_s = time.perf_counter() - t0
    i = submit_due(float("inf"), t0, i)      # any due before the close
    queued = len(sched.queue)
    t_drain = time.perf_counter()
    limit = t_drain + drain_limit
    while (sched.queue or sched.active or sched.in_flight) and \
            time.perf_counter() < limit:
        serve(time.perf_counter())
    drain_s = time.perf_counter() - t_drain
    records = []
    for r in range(n):
        at = admit_tick.get(r)
        records.append({
            "due": t0 + float(due[r]), "submit": float(submit[r]),
            "admit": tick_start.get(at) if at is not None else None,
            "done": done_t.get(r), "close": close})
    late = np.asarray(submit - (t0 + due))
    in_window = sum(1 for t in done_t.values() if t <= close)
    notes = {"requests": n, "ticks": ticks, "queued_at_close": queued,
             "completed_in_window": in_window, "drain_s": drain_s,
             "generator_late_ms_p50": float(np.median(late)) * 1e3,
             "generator_late_ms_p99": float(np.quantile(late, 0.99)) * 1e3,
             "generator_late_ms_max": float(late.max()) * 1e3}
    return harness.Run(cfg=s.cfg, traffic=s.traffic, window_s=window_s,
                       requests=records, ticks=ticks, host_ns=host_ns,
                       drain_limit_s=drain_limit,
                       calls=ticks, rows_per_call=2 * sched.slots,
                       notes=notes)


def samples(s: State, run: harness.Run, seed: int) -> list:
    done = sorted(s.done)
    if not done:
        return []
    k = min(int(s.traffic["check_requests"]), len(done))
    rng = np.random.default_rng([int(seed), 17])
    pick = set(rng.choice(done, size=k, replace=False).tolist())
    lat = harness.latencies_s(run)
    pick.add(max(done, key=lambda r: lat[r]))
    return [harness.Sample(x_T=torch.from_numpy(s.x_T[r]),
                           out=torch.from_numpy(np.asarray(s.done[r])),
                           class_id=int(s.classes[r]), w=float(s.w[r]))
            for r in sorted(pick)]


def counts(s: State, run: harness.Run) -> tuple:
    """(attempted, failed): the requests due in the window, and those of
    them never completed or completed marked failed."""
    n = len(run.requests)
    good = sum(1 for r in range(n) if r in s.done and s.ok.get(r, False))
    return n, n - good


def release(s: State) -> None:
    s.sched = None
