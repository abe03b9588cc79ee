"""Render observability artifacts into human-readable reports (the port's
copy of `repro.obs.report`).

`launch/obsreport.py` drives this module: given the trace and/or metrics
artifacts a serve run exported (`--trace-out` / `--metrics-out`), it renders
the DESIGN §11 "where a tick goes" breakdown from *measured* per-phase data
instead of by hand, plus per-tier serving rows, quality-probe drift, and
aggregated span statistics from the Chrome trace. Everything here is pure
text over JSON-able dicts — no framework, no scheduler imports — so a
saved artifact from either package's run renders anywhere.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from .metrics import METRICS_SCHEMA, parse_fullname


def write_metrics_artifact(path: str, *, metrics: Dict[str, dict],
                           serve_metrics: dict, static: dict,
                           exposition: str,
                           rows: Optional[List[dict]] = None,
                           probe: Optional[dict] = None) -> dict:
    """Write the metrics artifact (`obs.metrics.validate_metrics` schema).

    metrics: the run's registry snapshot delta (with samples — exact
        percentile reproduction is part of the artifact's contract).
    serve_metrics: the derived `ServeMetrics.row()` dict.
    static: the derivation's non-registry inputs ({mode, slots, n_rows,
        pipeline_depth}), so `serve_metrics_from_snapshot` can be re-run on
        the artifact alone (`obsreport --check`).
    exposition: the Prometheus text dump of the registry.
    rows: optional periodic snapshot rows (`run_trace(snapshot_every=...)`).
    probe: optional quality-probe summary ({tier: {count, mean, max}}).
    """
    obj = {
        "schema": METRICS_SCHEMA,
        "run": {"static": dict(static), "metrics": metrics},
        "serve_metrics": serve_metrics,
        "rows": list(rows or []),
        "exposition": exposition,
    }
    if probe is not None:
        obj["probe"] = probe
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
    return obj


def _fmt_us(ns_or_us: float) -> str:
    return f"{ns_or_us:10.1f}"


def render_tick_table(serve_metrics: dict) -> str:
    """The "where a tick goes" table (DESIGN §11 / §15), from measured
    per-phase host counters: µs per executed tick and the share of the
    fenced tick wall each phase accounts for."""
    phases = serve_metrics.get("host_phase_us_per_tick") or {}
    tick_us = float(serve_metrics.get("tick_s") or 0.0) * 1e6
    lines = ["where a tick goes (measured, per executed tick):",
             f"  {'phase':<14} {'us/tick':>10}   share of tick"]
    known = sum(phases.values())
    for name in ("admission", "dispatch", "readback", "bookkeeping"):
        us = float(phases.get(name, 0.0))
        share = f"{us / tick_us * 100:5.1f}%" if tick_us > 0 else "    --"
        lines.append(f"  {name:<14} {_fmt_us(us)}   {share}")
    if tick_us > 0:
        # at depth 1 the fenced tick wall also covers device execution the
        # dispatch call handed off asynchronously — report the remainder
        other = max(tick_us - known, 0.0)
        lines.append(f"  {'(device/other)':<14} {_fmt_us(other)}   "
                     f"{other / tick_us * 100:5.1f}%")
        lines.append(f"  {'tick wall':<14} {_fmt_us(tick_us)}   100.0%")
    host = serve_metrics.get("host_us_per_tick")
    if host is not None:
        lines.append(f"  host bookkeeping (admission + bookkeeping): "
                     f"{float(host):.1f} us/tick")
    return "\n".join(lines)


def render_serve_summary(serve_metrics: dict) -> str:
    m = serve_metrics
    lines = [
        f"serve run: mode={m.get('mode')} slots={m.get('slots')} "
        f"depth={m.get('pipeline_depth')} n_rows={m.get('n_rows')}",
        f"  requests {m.get('requests')}  completed {m.get('completed')}  "
        f"ticks {m.get('ticks')}  evals {m.get('evals')}",
        f"  occupancy {float(m.get('occupancy') or 0.0):.3f}  "
        f"evals/latent {float(m.get('evals_per_latent') or 0.0):.2f}  "
        f"makespan {float(m.get('makespan_ticks') or 0.0):.1f} ticks",
        f"  latency p50/p95 {float(m.get('latency_ticks_p50') or 0.0):.1f}/"
        f"{float(m.get('latency_ticks_p95') or 0.0):.1f} ticks  "
        f"throughput {float(m.get('throughput_rps') or 0.0):.2f} req/s",
    ]
    per_tier = m.get("per_tier")
    if per_tier:
        lines.append(f"  {'tier':<10} {'done':>5} {'evals':>6} "
                     f"{'cost':>7} {'lat p50':>8}")
        for t, row in sorted(per_tier.items()):
            lines.append(f"  {t:<10} {row.get('completed', 0):>5} "
                         f"{row.get('evals', 0):>6} "
                         f"{float(row.get('eval_cost') or 0.0):>7.2f} "
                         f"{float(row.get('latency_ticks_p50') or 0.0):>8.1f}")
    return "\n".join(lines)


def render_resilience(serve_metrics: dict,
                      metrics: Optional[Dict[str, dict]] = None) -> str:
    """The fault/resilience ledger (DESIGN §16): what was shed, retried,
    failed and recovered, with the per-label breakdown (rejection reasons,
    injected fault kinds) read back out of the registry delta. Returns ""
    when the run saw no resilience event at all — fault-free reports are
    unchanged."""
    m = serve_metrics
    keys = ("rejected", "expired", "degraded", "retries", "failed",
            "recoveries", "faults_injected")
    if not any(int(m.get(k) or 0) for k in keys):
        return ""
    lines = ["resilience ledger (DESIGN §16):",
             f"  rejected {int(m.get('rejected') or 0)} "
             f"(expired {int(m.get('expired') or 0)})  "
             f"shed-degraded {int(m.get('degraded') or 0)}  "
             f"retries {int(m.get('retries') or 0)}  "
             f"failed {int(m.get('failed') or 0)}",
             f"  desync recoveries {int(m.get('recoveries') or 0)}  "
             f"faults injected {int(m.get('faults_injected') or 0)}"]
    if metrics:
        breakdown = []
        for fullname, row in sorted(metrics.items()):
            name, labels = parse_fullname(fullname)
            if (name in ("serve_rejected", "fault_injected", "serve_retries",
                         "serve_requeued") and row.get("type") == "counter"):
                tag = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
                breakdown.append(f"  {name}{{{tag}}} = "
                                 f"{int(row.get('value') or 0)}")
        lines.extend(breakdown)
    return "\n".join(lines)


def render_probe_summary(probe: Dict[str, dict]) -> str:
    lines = ["quality probe (trajectory discrepancy vs high-NFE reference):",
             f"  {'tier':<10} {'probed':>6} {'mean':>12} {'max':>12}"]
    for t, row in sorted(probe.items()):
        lines.append(f"  {t:<10} {row.get('count', 0):>6} "
                     f"{float(row.get('mean') or 0.0):>12.3e} "
                     f"{float(row.get('max') or 0.0):>12.3e}")
    return "\n".join(lines)


def span_stats(trace: dict) -> Dict[str, dict]:
    """Aggregate the trace's complete ("X") spans by name:
    {name: {count, total_us, mean_us, max_us}}."""
    out: Dict[str, dict] = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        row = out.setdefault(ev["name"], {"count": 0, "total_us": 0.0,
                                          "max_us": 0.0})
        dur = float(ev.get("dur", 0.0))
        row["count"] += 1
        row["total_us"] += dur
        row["max_us"] = max(row["max_us"], dur)
    for row in out.values():
        row["mean_us"] = row["total_us"] / row["count"]
    return out


def render_trace_summary(trace: dict) -> str:
    other = trace.get("otherData") or {}
    n = len(trace.get("traceEvents", []))
    lines = [f"trace: {n} events, {other.get('dropped_events', 0)} dropped "
             f"(schema {other.get('schema')})"]
    meta = {k: v for k, v in other.items()
            if k not in ("schema", "dropped_events")}
    if meta:
        lines.append(f"  meta: {json.dumps(meta, sort_keys=True)}")
    stats = span_stats(trace)
    if stats:
        lines.append(f"  {'span':<14} {'count':>6} {'mean us':>10} "
                     f"{'max us':>10} {'total us':>11}")
        for name, row in sorted(stats.items(),
                                key=lambda kv: -kv[1]["total_us"]):
            lines.append(f"  {name:<14} {row['count']:>6} "
                         f"{row['mean_us']:>10.1f} {row['max_us']:>10.1f} "
                         f"{row['total_us']:>11.1f}")
    # request lifecycle: how many began / ended
    begins = sum(1 for e in trace.get("traceEvents", [])
                 if e.get("ph") == "b")
    ends = sum(1 for e in trace.get("traceEvents", []) if e.get("ph") == "e")
    lines.append(f"  request spans: {begins} submitted, {ends} completed")
    return "\n".join(lines)


def render_report(trace: Optional[dict] = None,
                  metrics: Optional[dict] = None) -> str:
    """The full obsreport text over whichever artifacts were given."""
    parts: List[str] = []
    if metrics is not None:
        sm = metrics.get("serve_metrics") or {}
        parts.append(render_serve_summary(sm))
        parts.append(render_tick_table(sm))
        resil = render_resilience(
            sm, (metrics.get("run") or {}).get("metrics"))
        if resil:
            parts.append(resil)
        if metrics.get("probe"):
            parts.append(render_probe_summary(metrics["probe"]))
        if metrics.get("rows"):
            parts.append(f"periodic snapshots: {len(metrics['rows'])} rows "
                         f"(sample-free registry deltas)")
    if trace is not None:
        parts.append(render_trace_summary(trace))
    return "\n\n".join(parts) if parts else "(no artifacts given)"
