"""sample.adaln_roofline: the least time of the adaln work the window's evals
did, from their shapes (yardstick.adaln_bound_s), over the device time of the
kernels that did it, named in sample.adaln_roofline.json."""

from pathlib import Path

from perfbench import harness


def read(run):
    return harness.roofline_share(run, Path(__file__).with_suffix(".json"))
