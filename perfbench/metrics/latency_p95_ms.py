"""latency_p95_ms: the 95th percentile of the latency of every request due
in the window, from its due time to its latent on the host; a request never
completed counts as waiting to the end of the drain."""

from perfbench import harness


def read(run):
    if not run.requests:
        return None
    return harness.quantile(harness.latencies_s(run), 0.95) * 1e3
