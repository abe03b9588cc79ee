"""lm.mfu: DeepSeek-V2-Lite's model FLOPs of the sequences completed in the
window (bounds/deepseek_v2_lite.py:model_flops, NFE evals each) over the
window's seconds times the bf16 peak."""

from perfbench import yardstick
from perfbench.bounds import deepseek_v2_lite


def read(run):
    if not run.images:
        return None
    flops = deepseek_v2_lite.model_flops(run.cfg, run.images, run.nfe)
    return 100.0 * flops / (run.window_s * yardstick.MFU_PEAK)
