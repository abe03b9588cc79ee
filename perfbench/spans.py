"""The port's own spans and counters, read beside one window of a cell.

    python3 perfbench/spans.py --workload dit-i256.serve32 --seed <n> \
        --seconds 51

runs the cell's set-up and window as `run.py --trace 1` does, under a
profiler that also keeps what `harness.Tracer` drops: the program's ranges
(`serve.*`, `engine.*`, on the profiler's own clock), the host's CUDA
runtime and driver calls with their correlation ids, and each device
operation's correlation id. It also attaches the program's Chrome ring to
an open-loop cell's scheduler and reads the program's counters at the
window's edges. The last line of standard output is one JSON object: the
readings of five per-layer quantities, the idle gaps labelled by program
span, and the checks that the program's ranges and the runtime's calls
share one clock. Nothing is compared with the reference: this is a
reading of the program, not a run of the benchmark.

The readings (each None where its inputs are absent):

* `serve.idle_slot_share` (%): 1 - the scheduler's `active_slot_ticks` /
  (`ticks` x slots), deltas over the window;
* `serve.service_ms_p95` (ms): the 95th percentile, over the requests
  emitted in the window, of admission to emission on the program's own
  stamps (`Completion.admit_ns` / `emit_ns`); None if the ring dropped;
* `idle_share.serve.host_bound`, `idle_share.sample.host_bound` (%): the
  window's share in device gaps whose next operation the host had not
  begun to launch when the gap opened (`host_bound`); None where less
  than 99% of the device time matches a runtime call;
* `sample.evals_per_trajectory`: the engine's eval count (`run.evals`,
  with any shallow evals) over the window / the window's replays.

Nothing in `run.py` or `harness.py` calls this module.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time

T_START = time.perf_counter()   # before any import: set-up starts here

import argparse  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402

PROGRAM = ("serve.", "engine.")          # the program's range prefixes
HOST_CALL = re.compile(r"cu(da)?[A-Z]")   # a CUDA runtime or driver call
MATCHED_MIN = 0.99       # device time a host-bound reading must match
RING_CAPACITY = 1 << 18  # a 51 s serving window and its drain: ~25k events


@dataclasses.dataclass
class SpanTrace:
    """A window's `harness.Trace` and what it leaves out: the program's
    ranges (name, start_ns, end_ns), the host's runtime and driver calls
    (name, start_ns, end_ns, correlation id), and the device operations'
    (start_ns, end_ns, correlation id), clipped to the window as the
    trace's device intervals are."""
    trace: harness.Trace
    spans: list
    calls: list
    ops: list


def reduce_events(records) -> SpanTrace:
    """The profiler's events, as (name, on the device, start_ns, end_ns,
    correlation id) records, reduced as `harness.Tracer.stop` reduces them
    plus the program's ranges, the runtime calls and the device ops'
    correlation ids."""
    device, host, spans, calls, ops = [], [], [], [], []
    for name, cuda, s, e, corr in records:
        if name.startswith("bench."):
            if not cuda:
                host.append((name, s, e))
        elif cuda:
            device.append((name, s, e))
            ops.append((s, e, corr))
        elif name.startswith(PROGRAM):
            spans.append((name, s, e))
        elif HOST_CALL.match(name):
            calls.append((name, s, e, corr))
    trace = harness.Trace.of(device, host)
    ops = [(s2, e2, c) for s, e, c in ops
           for s2, e2 in harness.clip([(s, e)], trace.lo, trace.hi)]
    return SpanTrace(trace, spans, calls, ops)


class SpanTracer(harness.Tracer):
    """`harness.Tracer` that keeps the events it drops (`stop` returns a
    `SpanTrace`) and snapshots `counters()` with the host's perf_counter_ns
    as the window's range opens and closes (`edges`)."""

    def __init__(self):
        super().__init__(True)
        self.counters = dict
        self.edges: list = []

    def range(self, name: str):
        if name != "bench.window":
            return super().range(name)
        return self._window(super().range(name))

    @contextlib.contextmanager
    def _window(self, inner):
        self.edges = [self._snap()]
        with inner:
            yield
        self.edges.append(self._snap())

    def _snap(self) -> dict:
        return {"perf_ns": time.perf_counter_ns(), **self.counters()}

    def stop(self) -> Optional[SpanTrace]:
        if self.prof is None:
            return None
        self.prof.stop()
        from torch.autograd import DeviceType
        records = [(e.name(), e.device_type() == DeviceType.CUDA,
                    e.start_ns(), e.end_ns(), e.correlation_id())
                   for e in self.prof.profiler.kineto_results.events()]
        self.prof = None
        return reduce_events(records)


# ---------------------------------------------------------------------------
# the readings
# ---------------------------------------------------------------------------

def innermost(spans, t: int) -> Optional[str]:
    """The name of the shortest of `spans` that encloses time t."""
    inside = [(e - s, n) for n, s, e in spans if s <= t < e]
    return min(inside)[1] if inside else None


def idle_gaps(st: SpanTrace) -> dict:
    """The window's idle gaps by what the host was doing at each gap's
    midpoint: `<bench range>/<program span>`, the innermost program span
    that encloses it, or the benchmark range's label alone where none
    does; {label: [gaps, seconds, longest seconds]}."""
    labels = harness.HostLabels(st.trace.host)
    spans = sorted(st.spans, key=lambda x: x[1])
    starts = [s for _, s, _ in spans]
    longest = max((e - s for _, s, e in spans), default=0)
    out: dict = {}
    for s, e in harness.gaps([(a, b) for _, a, b in st.trace.device],
                             st.trace.lo, st.trace.hi):
        mid = (s + e) // 2
        lo = bisect.bisect_left(starts, mid - longest)
        hi = bisect.bisect_right(starts, mid)
        span = innermost(spans[lo:hi], mid)
        label = labels.at(mid) + (f"/{span}" if span else "")
        n, tot, big = out.get(label, (0, 0.0, 0.0))
        out[label] = (n + 1, tot + (e - s) / 1e9, max(big, (e - s) / 1e9))
    return {k: list(v) for k, v in sorted(out.items(),
                                          key=lambda kv: -kv[1][1])}


def host_bound(st: SpanTrace) -> tuple:
    """(% of the window in host-bound gaps, None where less than 99% of the
    device time matches a host call; those gaps' seconds; the matched
    share of device time). A gap is host-bound when the host call that
    launched the operation closing it (matched by correlation id) started
    after the gap opened. Kernels of one CUDA graph share its launch's
    call, made before the graph's first kernel, so a gap inside a graph is
    never host-bound. A gap closed by an operation no call matches is not
    counted."""
    call_start = {c: s for _, s, _, c in st.calls}
    busy = sum(e - s for s, e, _ in st.ops)
    matched = (sum(e - s for s, e, c in st.ops if c in call_start) / busy
               if busy else 0.0)
    first = {}
    for s, _, c in st.ops:
        if s not in first or c in call_start:
            first[s] = c
    bound = 0
    for s, e in harness.gaps([(a, b) for a, b, _ in st.ops],
                             st.trace.lo, st.trace.hi):
        c = first.get(e)
        if c in call_start and call_start[c] > s:
            bound += e - s
    share = (100.0 * bound / (st.trace.hi - st.trace.lo)
             if matched >= MATCHED_MIN else None)
    return share, bound / 1e9, matched


def idle_slot_share(edges: list, slots: int) -> Optional[float]:
    if len(edges) != 2 or "ticks" not in edges[0]:
        return None
    ticks = edges[1]["ticks"] - edges[0]["ticks"]
    active = edges[1]["active_slot_ticks"] - edges[0]["active_slot_ticks"]
    return 100.0 * (1.0 - active / (ticks * slots)) if ticks else None


def service_ms_p95(completions, edges: list, dropped: int) -> Optional[float]:
    """p95 of admission to emission (ms) over the completions emitted
    inside the window, on the program's stamps; None if the ring dropped
    events or no completion carries stamps."""
    if dropped or len(edges) != 2:
        return None
    lo, hi = edges[0]["perf_ns"], edges[1]["perf_ns"]
    spans = [(c.emit_ns - c.admit_ns) / 1e6 for c in completions
             if c.emit_ns is not None and lo <= c.emit_ns <= hi]
    return harness.quantile(spans, 0.95) if spans else None


def evals_per_trajectory(edges: list, replays: int) -> Optional[float]:
    if len(edges) != 2 or "evals" not in edges[0] or not replays:
        return None
    evals = sum(edges[1][k] - edges[0][k] for k in ("evals",
                                                     "shallow_evals"))
    return evals / replays


def one_clock(st: SpanTrace) -> dict:
    """The checks that the program's ranges and the runtime's calls are on
    one clock: in the window, each `cudaGraphLaunch` inside an
    `engine.launch` (and, serving, a `serve.dispatch`), each
    `cudaEventSynchronize` inside a `serve.readback` (serving); and the
    program's ranges mirrored onto the device's timeline (none expected).
    {check: [inside, of]}."""
    lo, hi = st.trace.lo, st.trace.hi

    def within(call, span):
        ranges = [(s, e) for n, s, e in st.spans if n == span]
        picked = [(s, e) for n, s, e, _ in st.calls
                  if n == call and lo <= s <= hi]
        inside = sum(any(a <= s and e <= b for a, b in ranges)
                     for s, e in picked)
        return [inside, len(picked)]

    out = {"cudaGraphLaunch in engine.launch":
           within("cudaGraphLaunch", "engine.launch")}
    if any(n == "serve.tick" for n, _, _ in st.spans):
        out["cudaGraphLaunch in serve.dispatch"] = within(
            "cudaGraphLaunch", "serve.dispatch")
        out["cudaEventSynchronize in serve.readback"] = within(
            "cudaEventSynchronize", "serve.readback")
    out["program ranges on the device timeline"] = [
        sum(n.startswith(PROGRAM) for n, _, _ in st.trace.device),
        len(st.trace.device)]
    return out


# ---------------------------------------------------------------------------
# one window
# ---------------------------------------------------------------------------

def counters_of(state):
    """The program counters a driver's state holds, read as a dict."""
    sched, run = getattr(state, "sched", None), getattr(state, "run", None)

    def read():
        out = {}
        if sched is not None:
            out.update(ticks=sched.ticks,
                       active_slot_ticks=sched.active_slot_ticks)
        if run is not None and hasattr(run, "evals"):
            out.update(evals=run.evals, shallow_evals=run.shallow_evals)
        return out

    return read


def read_window(man: dict, cell: str, seed: int, seconds: float, device,
                cfg_override: Optional[dict] = None,
                traffic_override: Optional[dict] = None) -> dict:
    """Set the cell up, measure one window under a `SpanTracer`, and read
    the program's spans and counters."""
    from perfbench import program, weights
    from repro_torch import obs

    w = harness.workload(man, cell)
    cfg = cfg_override or harness.load_json(
        harness.HERE / "configs" / f"{w['config']}.json")
    traffic = traffic_override or harness.load_json(
        harness.HERE / "traffic" / f"{w['traffic']}.json")
    driver = harness.driver_of(traffic)
    tracer = SpanTracer()
    program.import_port()
    params = weights.make_params(cfg, seed, device)
    state = driver.setup(cfg, traffic, seed, device, params,
                         harness.quant_mode(cfg), tracer)
    del params
    sched = getattr(state, "sched", None)
    ring = None
    if sched is not None:
        ring = sched.tracer = obs.Tracer(capacity=RING_CAPACITY)
    tracer.counters = counters_of(state)
    tracer.start()
    run = driver.window(state, seconds, tracer)
    st = tracer.stop()
    edges = tracer.edges
    serving = sched is not None
    share, bound, matched = host_bound(st)
    readings = {
        "serve.idle_slot_share": (idle_slot_share(edges, sched.slots)
                                  if serving else None),
        "serve.service_ms_p95": (service_ms_p95(sched.completions, edges,
                                                ring.dropped)
                                 if serving else None),
        "idle_share.serve.host_bound": share if serving else None,
        "idle_share.sample.host_bound": None if serving else share,
        "sample.evals_per_trajectory": (
            None if serving else
            evals_per_trajectory(edges, run.notes.get("replays", 0))),
    }
    counts = {k: edges[1][k] - edges[0][k] for k in edges[0]
              if k != "perf_ns"} if len(edges) == 2 else {}
    out = {
        "workload": cell, "seed": seed,
        "readings": readings,
        "counts": counts,
        "calls_per_replay": (run.calls / run.notes["replays"]
                             if run.notes.get("replays") else None),
        "matched_device_share": matched,
        "host_bound_s": bound,
        "window_s": st.trace.window_s, "busy_s": st.trace.busy_s,
        "ring_dropped": ring.dropped if ring is not None else None,
        "one_clock": one_clock(st),
        "idle_gaps": dict(list(idle_gaps(st).items())[:16]),
        "host_calls": sorted({n for n, _, _, _ in st.calls}),
    }
    driver.release(state)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the spans are read on the card",
              file=sys.stderr)
        return 2
    out = read_window(harness.manifest(ROOT), args.workload, args.seed,
                      args.seconds, torch.device("cuda", 0))
    out["setup_and_window_s"] = time.perf_counter() - T_START
    out["card"] = harness.power_limit()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
