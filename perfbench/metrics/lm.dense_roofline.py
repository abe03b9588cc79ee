"""lm.dense_roofline: the least time of the dense products the window's
evals did outside the routed experts, from the published sizes
(bounds/deepseek_v2_lite.py:dense_bound_s), over the device time of the
cuBLAS kernels that did them, named in lm.dense_roofline.json."""

from pathlib import Path

from perfbench import harness


def read(run):
    return harness.roofline_share(run, Path(__file__).with_suffix(".json"))
