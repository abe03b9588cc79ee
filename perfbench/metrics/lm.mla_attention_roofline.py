"""lm.mla_attention_roofline: the least time of latent attention's score
and value products the window's evals did (Q K^T 192 deep, P V 128 wide;
bounds/deepseek_v2_lite.py:mla_attention_bound_s), over the device time of
the kernels that did them, named in lm.mla_attention_roofline.json."""

from pathlib import Path

from perfbench import harness


def read(run):
    return harness.roofline_share(run, Path(__file__).with_suffix(".json"))
