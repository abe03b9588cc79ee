"""Serving observability (the port of `repro.obs`, DESIGN.md §15): tracing,
metrics, quality probe.

Layering: `trace` needs only torch's profiler flag and range type,
`metrics` adds numpy, `report` renders both; `probe` steps the engine only
inside `build_reference_fn` (the reference runner), so importing the
package never drags in the engine. The serving scheduler and the engine's
graphs depend on this package — never the reverse.
"""

from .metrics import (METRICS_SCHEMA, MetricsRegistry, delta, parse_fullname,
                      snapshot_percentile, validate_metrics)
from .probe import QualityProbe, build_reference_fn, probe_selected
from .report import render_report, span_stats, write_metrics_artifact
from .trace import TRACE_SCHEMA, Tracer, validate_trace

__all__ = [
    "METRICS_SCHEMA", "MetricsRegistry", "delta", "parse_fullname",
    "snapshot_percentile", "validate_metrics",
    "QualityProbe", "build_reference_fn", "probe_selected",
    "render_report", "span_stats", "write_metrics_artifact",
    "TRACE_SCHEMA", "Tracer", "validate_trace",
]
