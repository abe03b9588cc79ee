"""Structured event tracer -> Chrome/Perfetto ``trace_event`` JSON (the
port's copy of `repro.obs.trace`), and the live ranges the port's spans lay
on the profiler's own timeline.

A span is recorded once, at its site, into two sinks:

* **the Chrome ring** (`Tracer`), when one is attached, under the
  reference's names (``tick``, ``admission``, ``dispatch``, ``readback``,
  ``emit``). The tracer is a bounded ring buffer of event records the
  serving hot path appends tuples into; all formatting happens at export
  time, so an *enabled* tracer costs one `deque.append` per event plus
  whatever timestamps the caller already took (the scheduler reuses the
  `perf_counter_ns` reads it takes for host-overhead accounting). Its
  stamps are `time.perf_counter_ns` values.
* **the profiler's timeline** (`live`), while a `torch.profiler` records:
  a `_RecordFunctionFast` range under a prefixed name (the scheduler's
  ``serve.tick``, ``serve.admission``, ``serve.dispatch``,
  ``serve.readback``, ``serve.emit``; the engine's ``engine.copy_in``,
  ``engine.launch``, ``engine.copy_out``). A live range is stamped by
  kineto itself, on the clock of the device intervals and of the CUDA
  runtime calls, so the spans lay over the device trace with no offset
  between clocks estimated. It is a function-scope range: kineto does not
  mirror it onto the device's timeline, as it does a user-scope
  `record_function` range.

With no tracer and no profiler a site does what it did before the spans
existed: `live` reads one bool and hands back a shared no-op context (no
clock read, no allocation), and every ring call site is guarded by
``if tracer is not None``; latents, completions and the deterministic
metrics slice are pinned equal in `tests/test_torch_obs.py`.

Event model of the ring (DESIGN.md §15):

* **Tick spans** — complete ("ph": "X") events on the scheduler thread
  track: ``tick`` encloses the per-phase children ``admission`` /
  ``dispatch`` / ``readback`` / ``emit``. Nesting is by timestamp
  containment, exactly how chrome://tracing renders stacks; the profiler's
  ``serve.*`` ranges nest the same way.
* **Request lifecycle spans** — async events keyed by rid: "b" at submit,
  "n" instants at admit / segment boundaries, "e" at emission, carrying the
  request's tier, eval_cost, evals, and latency in the args.
* **Counter tracks** — "C" events (queue depth, busy slots) render as the
  stacked area charts above the tick track.

Export is the Chrome `trace_event` JSON object format
(`{"traceEvents": [...], "displayTimeUnit": "ms", "otherData": {...}}`),
which chrome://tracing and ui.perfetto.dev open directly. `validate_trace`
checks the schema (used by `launch/obsreport.py --check`). The schema name
is the reference's, so a trace reads the same from either package.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import deque
from typing import Dict, List, Optional

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

# record layouts appended into the ring (tuples keep the hot-path append
# cheap; export expands them into trace_event dicts):
#   ("X", name, cat, t0_ns, t1_ns, args)
#   ("I", name, cat, ts_ns, args)
#   ("C", name, ts_ns, values)
#   ("b"|"n"|"e", name, cat, id, ts_ns, args)
_ASYNC_PHASES = ("b", "n", "e")

_OFF = contextlib.nullcontext()    # shared: the off path allocates nothing


def profiling() -> bool:
    """Whether a `torch.profiler` records now: one read of the flag torch
    sets while one does."""
    return _autograd_profiler._is_profiler_enabled


def live(name: str):
    """A range named `name` on the profiler's own timeline while a
    `torch.profiler` records, entered and left with ``with``; otherwise a
    shared no-op context."""
    if _autograd_profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _OFF


class Tracer:
    """Bounded ring buffer of structured serving events.

    `capacity` bounds memory: when full, the OLDEST events are dropped (the
    tail of a long run is usually what you are debugging) and the drop count
    is reported in the export's `otherData.dropped_events` so a truncated
    trace is never mistaken for a complete one.

    Timestamps are `time.perf_counter_ns` values; callers that already take
    them (the scheduler's host-overhead accounting) pass them in, everything
    else defaults to now. Export normalizes to microseconds since the
    tracer's construction (the `ts`/`dur` unit chrome://tracing expects).
    """

    def __init__(self, capacity: int = 1 << 16,
                 meta: Optional[dict] = None):
        if capacity < 1:
            raise ValueError(f"tracer capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._appended = 0
        self._t0 = time.perf_counter_ns()
        self.meta = dict(meta or {})

    # -- recording (hot path) ------------------------------------------------
    def _push(self, rec) -> None:
        self._ring.append(rec)
        self._appended += 1

    def complete(self, name: str, t0_ns: int, t1_ns: int, cat: str = "tick",
                 args: Optional[dict] = None) -> None:
        """One complete ("X") span from explicit perf_counter_ns stamps."""
        self._push(("X", name, cat, t0_ns, t1_ns, args))

    def instant(self, name: str, cat: str = "tick",
                args: Optional[dict] = None,
                ts_ns: Optional[int] = None) -> None:
        self._push(("I", name, cat,
                    time.perf_counter_ns() if ts_ns is None else ts_ns, args))

    def counter(self, name: str, values: Dict[str, float],
                ts_ns: Optional[int] = None) -> None:
        """A counter ("C") sample: {series: value} rendered as stacked areas."""
        self._push(("C", name,
                    time.perf_counter_ns() if ts_ns is None else ts_ns,
                    dict(values)))

    def async_begin(self, name: str, id: int, cat: str = "request",
                    args: Optional[dict] = None,
                    ts_ns: Optional[int] = None) -> None:
        self._push(("b", name, cat, id,
                    time.perf_counter_ns() if ts_ns is None else ts_ns, args))

    def async_instant(self, name: str, id: int, cat: str = "request",
                      args: Optional[dict] = None,
                      ts_ns: Optional[int] = None) -> None:
        self._push(("n", name, cat, id,
                    time.perf_counter_ns() if ts_ns is None else ts_ns, args))

    def async_end(self, name: str, id: int, cat: str = "request",
                  args: Optional[dict] = None,
                  ts_ns: Optional[int] = None) -> None:
        self._push(("e", name, cat, id,
                    time.perf_counter_ns() if ts_ns is None else ts_ns, args))

    # -- export --------------------------------------------------------------
    @property
    def dropped(self) -> int:
        """Events evicted by the ring (0 for a complete trace)."""
        return self._appended - len(self._ring)

    def _us(self, ts_ns: int) -> float:
        return (ts_ns - self._t0) / 1e3

    def events(self) -> List[dict]:
        """Ring contents as chrome trace_event dicts (ts/dur in us)."""
        out: List[dict] = []
        for rec in self._ring:
            ph = rec[0]
            if ph == "X":
                _, name, cat, t0, t1, args = rec
                ev = {"name": name, "cat": cat, "ph": "X",
                      "ts": self._us(t0), "dur": max((t1 - t0) / 1e3, 0.0),
                      "pid": 0, "tid": 0}
            elif ph == "I":
                _, name, cat, ts, args = rec
                ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
                      "ts": self._us(ts), "pid": 0, "tid": 0}
            elif ph == "C":
                _, name, ts, values = rec
                ev = {"name": name, "cat": "counter", "ph": "C",
                      "ts": self._us(ts), "pid": 0, "tid": 0, "args": values}
                out.append(ev)
                continue
            else:  # async b / n / e
                _, name, cat, id_, ts, args = rec
                ev = {"name": name, "cat": cat, "ph": ph,
                      "id": int(id_), "ts": self._us(ts), "pid": 0, "tid": 0}
            if args:
                ev["args"] = dict(args)
            out.append(ev)
        return out

    def to_json(self) -> dict:
        return {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": {**self.meta,
                          "schema": TRACE_SCHEMA,
                          "dropped_events": self.dropped},
        }

    def export(self, path: str) -> dict:
        """Write the Chrome trace_event JSON artifact; returns the object."""
        obj = self.to_json()
        with open(path, "w") as f:
            json.dump(obj, f)
        return obj


TRACE_SCHEMA = "repro.obs.trace/v1"
_VALID_PH = {"X", "i", "C", "b", "n", "e"}


def validate_trace(obj: dict) -> List[str]:
    """Schema-check a trace artifact; returns a list of violations (empty =
    valid). Checked: top-level shape, per-event required keys, non-negative
    X durations, and — when no events were dropped from the ring — balanced
    async begin/end pairs per (cat, name, id)."""
    errs: List[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["not a trace_event object: missing 'traceEvents'"]
    events = obj["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' is not a list"]
    dropped = (obj.get("otherData") or {}).get("dropped_events", 0)
    balance: Dict[tuple, int] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errs.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _VALID_PH:
            errs.append(f"event {i}: bad ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str):
            errs.append(f"event {i}: missing name")
        if not isinstance(ev.get("ts"), (int, float)):
            errs.append(f"event {i}: missing ts")
        if ph == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                errs.append(f"event {i} ({ev.get('name')}): X span needs "
                            f"dur >= 0, got {ev.get('dur')!r}")
        if ph in _ASYNC_PHASES:
            if "id" not in ev:
                errs.append(f"event {i} ({ev.get('name')}): async event "
                            f"needs an id")
            else:
                key = (ev.get("cat"), ev["id"])
                balance[key] = balance.get(key, 0) + {"b": 1, "e": -1,
                                                      "n": 0}[ph]
    if not dropped:
        for key, n in sorted(balance.items()):
            if n != 0:
                errs.append(f"async events {key}: {abs(n)} unbalanced "
                            f"{'begin' if n > 0 else 'end'}(s)")
    return errs
