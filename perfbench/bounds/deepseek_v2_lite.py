"""The bounds DeepSeek-V2-Lite's rooflines name as `deepseek_v2_lite:
<function>`: the least seconds of a kernel family's work in `evals` evals
of `rows` sequences of the configuration's `sample_shape`, the larger of
its operations over the bf16 peak and its bytes over HBM's rate, per
layer, from the published sizes."""

from perfbench import yardstick


def _seconds(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / yardstick.PEAK_FLOPS[dtype],
               nbytes / yardstick.HBM_BYTES_PER_S)


def expert_bound_s(cfg: dict, rows: int, evals: int) -> float:
    """The routed experts' grouped GEMMs of the MoE layers: dropless, so
    each of the N = rows x S tokens takes k experts, R = k N rows of three
    products (gate, up: d -> f; down: f -> d), 3 x 2 R d f operations. The
    bytes: every expert's three weights read once, and each product's rows
    in and out (gate and up read R x d and write R x f each, down reads
    R x f and writes R x d)."""
    d, f = cfg["hidden_size"], cfg["moe_intermediate_size"]
    E, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    R = k * rows * cfg["sample_shape"][0]
    b = yardstick.BYTES[cfg["dtype"]]
    flops = 3 * 2.0 * R * d * f
    nbytes = (3 * E * d * f + 3 * R * d + 3 * R * f) * b
    layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    return _seconds(flops, nbytes, cfg["dtype"]) * layers * evals


def mla_attention_bound_s(cfg: dict, rows: int, evals: int) -> float:
    """Latent attention's score and value products in every layer: per
    head Q K^T at depth qk_nope + qk_rope (192) and P V at width v (128)
    over all S^2 pairs (bidirectional), 2 S^2 (192 + 128) operations; q
    and k (192 wide) and v (128) read once, o (128) written once."""
    S, H = cfg["sample_shape"][0], cfg["num_attention_heads"]
    dk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    dv = cfg["v_head_dim"]
    b = yardstick.BYTES[cfg["dtype"]]
    flops = 2.0 * rows * H * S * S * (dk + dv)
    nbytes = rows * H * S * (2 * dk + 2 * dv) * b
    return (_seconds(flops, nbytes, cfg["dtype"])
            * cfg["num_hidden_layers"] * evals)


def dense_sites(cfg: dict) -> list:
    """(name, M per sequence, K, N, dtype) of every dense product cuBLAS
    runs in one eval of one sequence of S tokens, in the model's order:
    the diffusion head's input projection, its timestep MLP (once a
    sequence, fp32), per layer MLA's four projections, then layer 0's
    dense SwiGLU or a MoE layer's fp32 router and shared-expert SwiGLU
    (the routed experts are the grouped GEMMs, `expert_bound_s`), and the
    output projection."""
    S, C = cfg["sample_shape"]
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    r, dn = cfg["kv_lora_rank"], cfg["qk_nope_head_dim"]
    dr, dv = cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    fs = cfg["n_shared_experts"] * cfg["moe_intermediate_size"]
    f0 = cfg["intermediate_size"]
    act, fp32 = cfg["dtype"], "float32"
    sites = [("in_proj", S, C, d, act),
             ("t_mlp1", 1, yardstick.TIMESTEP_FEATURES, d, fp32),
             ("t_mlp2", 1, d, d, fp32)]
    for layer in range(cfg["num_hidden_layers"]):
        sites += [("wq", S, d, H * (dn + dr), act),
                  ("wkv_a", S, d, r + dr, act),
                  ("wkv_b", S, r, H * (dn + dv), act),
                  ("wo", S, H * dv, d, act)]
        if layer < cfg["first_k_dense_replace"]:
            sites += [("w_gate", S, d, f0, act), ("w_up", S, d, f0, act),
                      ("w_down", S, f0, d, act)]
        else:
            sites += [("router", S, d, cfg["n_routed_experts"], fp32),
                      ("shared_gate", S, d, fs, act),
                      ("shared_up", S, d, fs, act),
                      ("shared_down", S, fs, d, act)]
    sites.append(("out_proj", S, d, C, act))
    return sites


def dense_bound_s(cfg: dict, rows: int, evals: int) -> float:
    """The least time of the dense products of `evals` evals of `rows`
    sequences: per site the larger of its operations over its dtype's
    peak and its bytes (activations in and out once, the weights once)
    over HBM's rate."""
    total = 0.0
    for _, m, k, n, dt in dense_sites(cfg):
        M = m * rows
        total += _seconds(2.0 * M * k * n,
                          (M * k + M * n + k * n) * yardstick.BYTES[dt], dt)
    return total * evals


def model_flops(cfg: dict, rows: int, evals: int) -> float:
    """The model FLOPs of `evals` evals of `rows` sequences: 2 a token for
    each active weight (every dense site of `dense_sites` and each token's
    k routed experts of 3 d f), the timestep MLP once a sequence, and
    attention's 2 S^2 H (qk_nope + qk_rope + v) a sequence and layer."""
    S = cfg["sample_shape"][0]
    d, f = cfg["hidden_size"], cfg["moe_intermediate_size"]
    moe_layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    per_seq = sum(2.0 * m * k * n for _, m, k, n, _ in dense_sites(cfg))
    per_seq += moe_layers * S * 2.0 * cfg["num_experts_per_tok"] * 3 * d * f
    dk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    per_seq += (cfg["num_hidden_layers"] * 2.0 * S * S
                * cfg["num_attention_heads"] * (dk + cfg["v_head_dim"]))
    return per_seq * rows * evals
