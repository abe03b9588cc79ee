"""Serving observability (the port's slice of `repro.obs`): the metrics
registry the scheduler's accounting rests on (DESIGN.md §15). The tracer,
the report and the quality probe are not ported yet."""

from .metrics import (METRICS_SCHEMA, MetricsRegistry, delta, parse_fullname,
                      snapshot_percentile, validate_metrics)

__all__ = [
    "METRICS_SCHEMA", "MetricsRegistry", "delta", "parse_fullname",
    "snapshot_percentile", "validate_metrics",
]
