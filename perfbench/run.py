"""Run one cell of the benchmark once and print its result as the last line
of standard output:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

It needs a CUDA card (as many as the cell asks for) and the port under
src/; it exits non-zero and prints no result without them, or when a
module of JAX, Flax or the JAX package was loaded. `--trace 1` measures the
cell's per-layer metrics under the profiler, `--trace 0` its end-to-end
metrics. The numbers compared with the reference are the last lines of
standard error and the last key of the result.
"""

import time

T_START = time.perf_counter()   # before any import: set-up starts here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import harness

    man = harness.manifest(ROOT)
    cell = harness.workload(man, args.workload)
    t_torch = time.perf_counter()
    import torch

    t_probe = time.perf_counter()
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the port on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = harness.run_cell(man, args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T_START)
    # the first parts of set-up, before the cell's own
    result["notes"].update({
        "setup.harness_s": t_torch - T_START,
        "setup.torch_import_s": t_probe - t_torch,
        "setup.probe_and_driver_s": result["notes"]["setup.before_cell_s"]
        - (t_probe - T_START)})
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    for key, val in result["notes"].items():
        print(f"note {key} {val}", file=sys.stderr)
    if result["device"].get("power"):
        print(f"note card {result['device']['power']}", file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
