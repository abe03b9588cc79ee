"""Render serving observability artifacts (the port of
`repro.launch.obsreport`, DESIGN.md §15).

    PYTHONPATH=src python -m repro_torch.launch.obsreport \
        --trace trace.json --metrics metrics.json --check

Takes the artifacts a serve run exported (`repro_torch.launch.serve
--trace-out / --metrics-out`, or the reference's: the schemas are shared),
validates both against their schemas, and renders the human-readable
breakdown: the "where a tick goes" per-phase table (DESIGN §11, produced
from measured data), per-tier serving rows, quality-probe drift, and
aggregated span statistics from the Chrome trace. `--check`
additionally re-derives `ServeMetrics` from the artifact's raw registry
snapshot via `serving.server.serve_metrics_from_snapshot` and requires it to
EXACTLY equal the artifact's embedded aggregate — the no-drift contract
between live metrics and the end-of-run report, checkable offline.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..obs.metrics import validate_metrics
from ..obs.report import render_report
from ..obs.trace import validate_trace


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def check_metrics_roundtrip(obj: dict) -> list:
    """Re-derive ServeMetrics from the artifact's snapshot delta and diff it
    against the embedded aggregate; returns [(field, embedded, derived)]
    mismatches (empty = the artifact is self-consistent)."""
    from ..serving.server import serve_metrics_from_snapshot

    static = obj["run"]["static"]
    derived = serve_metrics_from_snapshot(
        obj["run"]["metrics"], mode=static["mode"], slots=static["slots"],
        n_rows=static["n_rows"],
        pipeline_depth=static.get("pipeline_depth", 1)).row()
    embedded = obj["serve_metrics"]
    keys = sorted(set(embedded) | set(derived))
    return [(k, embedded.get(k), derived.get(k)) for k in keys
            if embedded.get(k) != derived.get(k)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trace", default=None,
                    help="Chrome trace_event JSON from serve --trace-out")
    ap.add_argument("--metrics", default=None,
                    help="metrics artifact from serve --metrics-out")
    ap.add_argument("--check", action="store_true",
                    help="re-derive ServeMetrics from the metrics artifact's "
                         "raw snapshot and require exact equality with the "
                         "embedded aggregate")
    args = ap.parse_args(argv)
    if args.trace is None and args.metrics is None:
        ap.error("give --trace and/or --metrics (artifacts from "
                 "repro_torch.launch.serve --trace-out/--metrics-out)")

    failed = False
    trace_obj = metrics_obj = None
    if args.trace is not None:
        trace_obj = _load(args.trace)
        errs = validate_trace(trace_obj)
        for e in errs:
            print(f"TRACE INVALID: {e}", file=sys.stderr)
        failed |= bool(errs)
    if args.metrics is not None:
        metrics_obj = _load(args.metrics)
        errs = validate_metrics(metrics_obj)
        for e in errs:
            print(f"METRICS INVALID: {e}", file=sys.stderr)
        failed |= bool(errs)
        if args.check and not errs:
            mismatches = check_metrics_roundtrip(metrics_obj)
            for k, emb, der in mismatches:
                print(f"CHECK FAIL: serve_metrics.{k}: artifact has {emb!r}, "
                      f"re-derivation gives {der!r}", file=sys.stderr)
            if not mismatches:
                print("check ok: embedded ServeMetrics == re-derivation "
                      "from the raw snapshot")
            failed |= bool(mismatches)

    print(render_report(trace=trace_obj, metrics=metrics_obj))
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
