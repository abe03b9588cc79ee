"""serve.latency_p50_ms: the median of the same latencies as
latency_p95_ms."""

from perfbench import harness


def read(run):
    if not run.requests:
        return None
    return harness.quantile(harness.latencies_s(run), 0.5) * 1e3
