"""lm.expert_roofline: the least time of the routed experts' grouped GEMMs
the window's evals did, from the published sizes (dropless: k rows a
token; bounds/deepseek_v2_lite.py:expert_bound_s), over the device time of
the kernels that did them, named in lm.expert_roofline.json."""

from pathlib import Path

from perfbench import harness


def read(run):
    return harness.roofline_share(run, Path(__file__).with_suffix(".json"))
