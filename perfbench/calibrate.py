"""The readings a cell's limits are set from: the numbers compared, on many
seeds, for the program as its configuration states it and for the controls
(the program's own lower-precision tiers, or the benchmark's rounding of
the program's weights, `round:e4m3`), in one process:

    python3 perfbench/calibrate.py --workload dit-i256.batch32 \
        --seeds 12 --controls fp8a16,round:e4m3 --seconds 3

Each seed is a whole run of the cell (set-up, a short window at the cell's
load, the comparison), printed as one JSON line; the last line sums up the
largest reading of the program and the smallest of each control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_011)
    ap.add_argument("--controls", default="",
                    help="comma-separated controls run in the program's "
                         "place: the port's quantized tiers (fp8a16) or "
                         "the benchmark's weight rounding (round:e4m3)")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    man = harness.manifest(ROOT)
    dev = torch.device("cuda", 0)
    runs = [(None, args.first_seed + 7919 * i) for i in range(args.seeds)]
    for control in filter(None, args.controls.split(",")):
        runs += [(control, args.first_seed + 104729 + 7919 * i)
                 for i in range(args.control_seeds)]
    summary: dict = {}
    for control, seed in runs:
        t0 = time.perf_counter()
        out = harness.run_cell(man, args.workload, seed, args.seconds,
                               False, dev, t0, control=control)
        line = {"workload": args.workload, "tier": control or "program",
                "seed": seed, "correct": out["correct"],
                "failed": out["failed"],
                **{k: v["value"] for k, v in out["check"].items()},
                "notes": out["notes"], "wall_s": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        harness.free_device()
        key = control or "program"
        for k, v in out["check"].items():
            agg = summary.setdefault(key, {}).setdefault(k, [])
            agg.append(v["value"])
    print(json.dumps({"summary": {
        t: {k: {"min": min(v), "max": max(v), "n": len(v)}
            for k, v in d.items()} for t, d in summary.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
