"""serve.queue_wait_ms_p95: the 95th percentile over the requests admitted
of the wait from the due time to the start of the tick that admitted it."""

from perfbench import harness


def read(run):
    waits = [r["admit"] - r["due"] for r in run.requests
             if r["admit"] is not None]
    return harness.quantile(waits, 0.95) * 1e3 if waits else None
