"""A bound a hybrid configuration's roofline names as `hybrid:<function>`:
the Mamba2 layers' input and output projections, the larger of their
operations over the bf16 peak and their bytes over HBM's rate."""

from perfbench import yardstick


def ssm_proj_bound_s(cfg: dict, rows: int, evals: int) -> float:
    port = cfg["port"]
    d, T = cfg["d_model"], cfg["sample_shape"][0]
    di = port["ssm_expand"] * d
    n_in = 2 * di + 2 * port["ssm_groups"] * port["ssm_state"] \
        + di // port["ssm_head_dim"]
    b = yardstick.BYTES[cfg["dtype"]]
    total = 0.0
    for k, n in ((d, n_in), (di, d)):
        M = T * rows
        flops = 2.0 * M * k * n
        nbytes = (M * k + M * n + k * n) * b
        total += max(flops / yardstick.PEAK_FLOPS[cfg["dtype"]],
                     nbytes / yardstick.HBM_BYTES_PER_S)
    return total * cfg["num_layers"] * evals
