"""Streaming metrics registry: counters, gauges, fixed-bucket histograms
(the port's copy of `repro.obs.metrics`; stdlib and numpy only).

The registry is the one accounting substrate of the serving stack — the
scheduler feeds it every tick and `serving.server.run_trace` derives its
final `ServeMetrics` FROM a registry snapshot delta, so the live numbers
and the end-of-run report are one code path by construction.

Three metric kinds:

* `Counter` — monotone accumulator (ticks, evals, completions, per-phase
  host nanoseconds).
* `Gauge` — last-value (makespan clock, probe discrepancy per tier).
* `Histogram` — fixed upper-bound buckets (+inf tail) for the streaming /
  Prometheus view, PLUS the exact observation list, because the serving
  report quotes exact percentiles (`np.percentile` over the samples) and the
  determinism tests demand bit-identical state across pipeline depths.
  `sample_cap` bounds the list for long-lived registries; once capped,
  exact percentiles degrade to bucket state (`samples_truncated` is set so
  a report can say so).

Every metric is created with ``wall=True`` or ``False`` (default): wall
metrics measure host time and are excluded from
``snapshot(deterministic_only=True)`` — the slice that must be bit-identical
across `--pipeline-depth` 1/2/3 on the same admission schedule.

`snapshot()` returns a plain JSON-able dict; `delta(before, after)` subtracts
two snapshots (counters and histogram state subtract; gauges keep the later
value), which is how a reused scheduler reports one run's numbers.
`exposition()` renders the Prometheus text format.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# the reference's schema name: a metrics artifact reads the same from either
METRICS_SCHEMA = "repro.obs.metrics/v1"

_Labels = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Optional[dict]) -> _Labels:
    return tuple(sorted((str(k), str(v))
                        for k, v in (labels or {}).items()))


def _fullname(name: str, labels: _Labels) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v


class Histogram:
    __slots__ = ("buckets", "counts", "sum", "count", "samples",
                 "sample_cap", "samples_truncated")

    def __init__(self, buckets: Sequence[float],
                 sample_cap: Optional[int] = None):
        b = tuple(float(x) for x in buckets)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"histogram buckets must be strictly "
                             f"ascending upper bounds, got {buckets}")
        self.buckets = b
        self.counts = [0] * (len(b) + 1)  # last bucket = +inf
        self.sum = 0.0
        self.count = 0
        self.samples: List[float] = []
        self.sample_cap = sample_cap
        self.samples_truncated = False

    def observe(self, v) -> None:
        v = float(v)
        self.counts[bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1
        if self.sample_cap is None or len(self.samples) < self.sample_cap:
            self.samples.append(v)
        else:
            self.samples_truncated = True

    def percentile(self, q: float) -> float:
        """Exact percentile over the retained samples; 0.0 when empty (the
        zero-completion guard — never an IndexError from np.percentile)."""
        if not self.samples:
            return 0.0
        return float(np.percentile(self.samples, q))


class MetricsRegistry:
    """Get-or-create registry keyed by (name, sorted labels)."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, _Labels], object] = {}
        self._meta: Dict[Tuple[str, _Labels], dict] = {}

    def _get(self, kind, name, labels, wall, help, **kw):
        key = (name, _labels_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = kind(**kw)
            self._metrics[key] = m
            self._meta[key] = {"type": kind.__name__.lower(),
                               "wall": bool(wall), "help": help or ""}
        elif not isinstance(m, kind):
            raise ValueError(f"metric {_fullname(name, key[1])} already "
                             f"registered as {type(m).__name__}")
        return m

    def counter(self, name: str, labels: Optional[dict] = None, *,
                wall: bool = False, help: str = "") -> Counter:
        return self._get(Counter, name, labels, wall, help)

    def gauge(self, name: str, labels: Optional[dict] = None, *,
              wall: bool = False, help: str = "") -> Gauge:
        return self._get(Gauge, name, labels, wall, help)

    def histogram(self, name: str, buckets: Sequence[float],
                  labels: Optional[dict] = None, *, wall: bool = False,
                  help: str = "",
                  sample_cap: Optional[int] = None) -> Histogram:
        return self._get(Histogram, name, labels, wall, help,
                         buckets=buckets, sample_cap=sample_cap)

    # -- snapshots -----------------------------------------------------------
    def snapshot(self, deterministic_only: bool = False,
                 include_samples: bool = True) -> Dict[str, dict]:
        """JSON-able state of every metric, keyed by the Prometheus-style
        full name. `deterministic_only` drops wall-clock metrics (the
        cross-pipeline-depth equality slice); `include_samples=False` drops
        the exact observation lists (the compact periodic-row form)."""
        out: Dict[str, dict] = {}
        for key in sorted(self._metrics):
            meta = self._meta[key]
            if deterministic_only and meta["wall"]:
                continue
            m = self._metrics[key]
            row = {"type": meta["type"], "wall": meta["wall"]}
            if isinstance(m, Histogram):
                row.update(buckets=list(m.buckets), counts=list(m.counts),
                           sum=m.sum, count=m.count,
                           samples_truncated=m.samples_truncated)
                if include_samples:
                    row["samples"] = list(m.samples)
            else:
                row["value"] = m.value
            out[_fullname(*key)] = row
        return out

    def exposition(self) -> str:
        """Prometheus text exposition (counters get the `_total`-as-named
        convention left to the caller's metric names; histograms render
        cumulative `_bucket{le=...}` series plus `_sum`/`_count`)."""
        lines: List[str] = []
        seen_type: Dict[str, str] = {}
        for key in sorted(self._metrics):
            name, labels = key
            m = self._metrics[key]
            meta = self._meta[key]
            if name not in seen_type:
                if meta["help"]:
                    lines.append(f"# HELP {name} {meta['help']}")
                lines.append(f"# TYPE {name} {meta['type']}")
                seen_type[name] = meta["type"]
            if isinstance(m, Histogram):
                cum = 0
                for ub, c in zip(m.buckets + (float("inf"),), m.counts):
                    cum += c
                    le = "+Inf" if ub == float("inf") else f"{ub:g}"
                    lbl = labels + (("le", le),)
                    lines.append(f"{_fullname(name + '_bucket', lbl)} {cum}")
                lines.append(f"{_fullname(name + '_sum', labels)} {m.sum:g}")
                lines.append(f"{_fullname(name + '_count', labels)} "
                             f"{m.count}")
            else:
                v = m.value
                lines.append(f"{_fullname(name, labels)} "
                             f"{v:g}" if isinstance(v, float)
                             else f"{_fullname(name, labels)} {v}")
        return "\n".join(lines) + "\n"


def delta(before: Dict[str, dict], after: Dict[str, dict]) -> Dict[str, dict]:
    """Subtract two snapshots: counter values and histogram counts/sums
    subtract, histogram samples keep the tail appended since `before`, and
    gauges keep the `after` value (last-write-wins semantics). Metrics absent
    from `before` pass through unchanged — they were created during the run."""
    out: Dict[str, dict] = {}
    for full, row in after.items():
        prev = before.get(full)
        if prev is None or row["type"] == "gauge":
            out[full] = dict(row)
            continue
        d = dict(row)
        if row["type"] == "counter":
            d["value"] = row["value"] - prev["value"]
        else:  # histogram
            d["counts"] = [a - b for a, b in zip(row["counts"],
                                                 prev["counts"])]
            d["sum"] = row["sum"] - prev["sum"]
            d["count"] = row["count"] - prev["count"]
            if "samples" in row:
                d["samples"] = row["samples"][len(prev.get("samples", [])):]
        out[full] = d
    return out


def parse_fullname(full: str) -> Tuple[str, Dict[str, str]]:
    """Invert `_fullname`: 'name{k="v",...}' -> (name, {k: v}). Label values
    are the simple identifiers this stack uses (tier names, phase names) —
    no escaping grammar."""
    if "{" not in full:
        return full, {}
    name, rest = full.split("{", 1)
    labels: Dict[str, str] = {}
    for part in rest.rstrip("}").split(","):
        k, v = part.split("=", 1)
        labels[k] = v.strip('"')
    return name, labels


def snapshot_percentile(row: dict, q: float) -> float:
    """Exact percentile from a snapshot histogram row (0.0 when empty)."""
    samples = row.get("samples") or []
    if not samples:
        return 0.0
    return float(np.percentile(samples, q))


def validate_metrics(obj: dict) -> List[str]:
    """Schema-check a metrics artifact (the reference's
    `obs.report.write_metrics_artifact` layout); returns violations (empty =
    valid)."""
    errs: List[str] = []
    if not isinstance(obj, dict):
        return ["metrics artifact is not an object"]
    if obj.get("schema") != METRICS_SCHEMA:
        errs.append(f"schema is {obj.get('schema')!r}, "
                    f"expected {METRICS_SCHEMA!r}")
    run = obj.get("run")
    if not isinstance(run, dict) or "metrics" not in run:
        errs.append("missing 'run.metrics' (the end-of-run snapshot delta)")
        return errs
    for full, row in run["metrics"].items():
        t = row.get("type")
        if t not in ("counter", "gauge", "histogram"):
            errs.append(f"{full}: bad type {t!r}")
        elif t == "histogram":
            if len(row.get("counts", [])) != len(row.get("buckets", [])) + 1:
                errs.append(f"{full}: counts/buckets length mismatch")
            if row.get("count") != sum(row.get("counts", [])):
                errs.append(f"{full}: count != sum(counts)")
        elif "value" not in row:
            errs.append(f"{full}: missing value")
    for name in ("serve_metrics", "exposition"):
        if name not in obj:
            errs.append(f"missing '{name}'")
    if not isinstance(obj.get("rows", []), list):
        errs.append("'rows' is not a list")
    return errs
