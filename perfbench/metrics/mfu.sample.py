"""mfu.sample: the model FLOPs of the images completed in the window over
the window's seconds times the bf16 peak. An image counts its sampler's
NFE evals (the engine's extra eval of the last row is not model work), 2
N_active a token, adaLN once a row, and both rows of guidance."""

from perfbench import yardstick


def read(run):
    if not run.images:
        return None
    rows = run.images * yardstick.rows_per_image(run.guided)
    flops = yardstick.model_flops_sample(run.cfg, run.nfe, rows)
    return 100.0 * flops / (run.window_s * yardstick.MFU_PEAK)
