"""The benchmark's frozen yardstick: the published peaks of one H100 and
each kernel family's work, computed from shapes.

The peaks and the model-FLOPs formula are copies of
`src/repro_torch/analysis/roofline.py` (HBM_BYTES_PER_S, PEAK_FLOPS,
`model_flops_sample`, `active_params` for the dit family) at commit
27e5708dcb5a9166d3935c99f04626d50d5d7a40. They are copied, not imported,
so that a change to the program cannot move the benchmark's numbers.

Every function takes a configuration as the dict of its file under
`configs/` and returns operations or bytes; the callers divide by the
peaks. A kernel family's work counts each input byte read once and each
output byte written once, whatever the kernel reads again.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM, dense rates without sparsity, 700 W
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "int8": 1979e12, "float8_e4m3fn": 1979e12}
MFU_PEAK = PEAK_FLOPS["bfloat16"]
BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1,
         "float8_e4m3fn": 1}
TIMESTEP_FEATURES = 256   # the DiT's sinusoidal timestep features


def active_params(cfg: dict) -> float:
    """A DiT's parameters counted as `model_flops_sample` counts them: per
    block 4 d^2 (attention) + 2 d d_ff (MLP) + 6 d^2 (adaLN)."""
    d, f, L = cfg["d_model"], cfg["d_ff"], cfg["num_layers"]
    return float(L * (4 * d * d + 2 * d * f + 6 * d * d))


def model_flops_sample(cfg: dict, evals: int, rows: int) -> float:
    """The model FLOPs of `evals` eps-net evals of `rows` rows each: 2
    N_active a token, except the adaLN projections, which run once a row
    on the conditioning vector and count once a row."""
    adaln = 6.0 * cfg["num_layers"] * cfg["d_model"] ** 2
    per_row = (active_params(cfg) - adaln) * cfg["patch_tokens"] + adaln
    return evals * rows * 2.0 * per_row


def rows_per_image(guided: bool) -> int:
    """Eps-net rows one image takes an eval: cond and uncond under CFG."""
    return 2 if guided else 1


def _quantized(cfg: dict) -> set:
    q = cfg.get("quant")
    return set(q["sites"]) if q else set()


def dense_sites(cfg: dict) -> list:
    """(name, M per row, K, N, activation dtype, weight dtype) of every dense
    contraction of one eval of one row, in the order the model runs them.
    M is the number of rows of the product a row contributes: the patch
    tokens for the token-wise sites, 1 for the sites on the conditioning
    vector. A quantized site (the config's `quant.sites`) reads int8
    weights."""
    d, f, L = cfg["d_model"], cfg["d_ff"], cfg["num_layers"]
    T, C = cfg["patch_tokens"], cfg["latent_dim"]
    hd = cfg["num_heads"] * cfg["head_dim"]
    act, q = cfg["dtype"], _quantized(cfg)

    def w(name):
        return cfg["quant"]["weight_dtype"] if name in q else act

    sites = [("in_proj", T, C, d, act, w("in_proj")),
             ("t_mlp1", 1, TIMESTEP_FEATURES, d, "float32", "float32"),
             ("t_mlp2", 1, d, d, "float32", "float32")]
    for _ in range(L):
        sites += [("ada", 1, d, 6 * d, act, w("ada")),
                  ("wq", T, d, hd, act, w("wq")),
                  ("wk", T, d, hd, act, w("wk")),
                  ("wv", T, d, hd, act, w("wv")),
                  ("wo", T, hd, d, act, w("wo")),
                  ("w1", T, d, f, act, w("w1")),
                  ("w2", T, f, d, act, w("w2"))]
    sites += [("final_ada", 1, d, 2 * d, act, w("final_ada")),
              ("out_proj", T, d, C, act, w("out_proj"))]
    return sites


def dense_bound_s(cfg: dict, rows: int, evals: int) -> float:
    """The least time of the dense work of `evals` evals of `rows` rows: per
    site the larger of its operations over the peak of its activation
    dtype (a quantized weight is widened to it) and its bytes (the
    activations in and out once, the weights once) over HBM's rate."""
    total = 0.0
    for _, m, k, n, act, wdt in dense_sites(cfg):
        M = m * rows
        flops = 2.0 * M * k * n
        nbytes = (M * k + M * n) * BYTES[act] + k * n * BYTES[wdt]
        if wdt != act:
            nbytes += n * 4          # the per-channel fp32 scales
        total += max(flops / PEAK_FLOPS[act], nbytes / HBM_BYTES_PER_S)
    return total * evals


def attention_bound_s(cfg: dict, rows: int, evals: int) -> float:
    """The least time of the attention of `evals` evals of `rows` rows: a
    head takes 4 S^2 D operations (Q K^T and P V) and reads q, k, v once
    and writes o once; per layer the larger of the two terms."""
    S, H, D = cfg["patch_tokens"], cfg["num_heads"], cfg["head_dim"]
    act = cfg["dtype"]
    flops = 4.0 * S * S * D * H * rows
    nbytes = 4.0 * S * H * D * rows * BYTES[act]
    per_layer = max(flops / PEAK_FLOPS[act], nbytes / HBM_BYTES_PER_S)
    return per_layer * cfg["num_layers"] * evals


def adaln_bound_s(cfg: dict, rows: int, evals: int) -> float:
    """The least time of the adaLN kernels of `evals` evals of `rows` rows:
    2L + 1 modulations (read x, shift and scale, write out) and 2L gated
    residuals (read the residual, the gate and y, write out), bytes-bound."""
    T, d, L = cfg["patch_tokens"], cfg["d_model"], cfg["num_layers"]
    b = BYTES[cfg["dtype"]]
    modulate = (2 * T * d + 2 * d) * b * rows
    gate = (3 * T * d + d) * b * rows
    return ((2 * L + 1) * modulate + 2 * L * gate) / HBM_BYTES_PER_S * evals
