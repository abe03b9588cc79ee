"""The knee of an open-loop cell: one set-up, then a window at each offered
rate, reporting the rate completed in the window, the queue left at the
close, the drain, and the latency percentiles. The knee is the highest
rate whose queue does not grow (nothing left queued at the close and the
completed rate keeping up with the offered one).

    python3 perfbench/knee.py --workload dit-i256.serve32 \
        --rates 34,42,50,59,67,76,84,92,101 --seconds 8
"""

import argparse
import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=3_100_000_003)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness, weights

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    man = harness.manifest(ROOT)
    w = harness.workload(man, args.workload)
    cfg = harness.load_json(harness.HERE / "configs" / f"{w['config']}.json")
    traffic = harness.load_json(
        harness.HERE / "traffic" / f"{w['traffic']}.json")
    driver = harness.driver_of(traffic)
    dev = torch.device("cuda", 0)
    tracer = harness.Tracer(False)
    params = weights.make_params(cfg, args.seed, dev)
    state = driver.setup(cfg, traffic, args.seed, dev, params,
                         harness.quant_mode(cfg), tracer)
    del params
    for rate in [float(r) for r in args.rates.split(",")]:
        state.traffic = copy.deepcopy(traffic)
        state.traffic["arrivals"] = {"kind": "poisson", "rate_per_s": rate}
        state.done, state.ok = {}, {}
        run = driver.window(state, args.seconds, tracer)
        lat = harness.latencies_s(run)
        n = run.notes
        print(json.dumps({
            "rate_per_s": rate, "requests": n["requests"],
            "completed_per_s": n["completed_in_window"] / run.window_s,
            "queued_at_close": n["queued_at_close"],
            "drain_s": n["drain_s"], "tick_ms": run.window_s / run.ticks
            * 1e3, "latency_p50_ms": harness.quantile(lat, 0.5) * 1e3,
            "latency_p95_ms": harness.quantile(lat, 0.95) * 1e3,
            "queue_wait_p95_ms": harness.quantile(
                [r["admit"] - r["due"] for r in run.requests
                 if r["admit"] is not None], 0.95) * 1e3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
