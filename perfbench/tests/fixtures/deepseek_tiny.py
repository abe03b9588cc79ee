"""A tiny `deepseek-v2-lite` cell the CPU runs whole through
`harness.run_cell`: the configuration file's keys with every size shrunk
(1 dense and 2 MoE layers of 64, 4 heads, MLA ranks 32 / 16 + 8 / 16, 16
experts of 32, top 4, 1 shared), its YaRN settings and routing rules as
published, bf16 weights and activations, and the benchmark's own weights
(`params/deepseek_v2_lite.py`) and reference (`reference/
deepseek_v2_lite.py`). Its limits file is written where the test says.

Top 4 of 16, where the published model takes 6 of 64: with top 2 of 8 a
near-tie the bf16 program routes otherwise than the fp32 reference swaps
half of a token's MoE output, and the program read up to 0.043 on 20
seeds against round:e4m3's 0.057 (CPU, 0.2 s windows): too close for a
limit between them."""

import copy
import json

from perfbench import harness

CELL = "deepseek-v2-lite-tiny.batch4"
SIZES = {
    "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
    "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
    "v_head_dim": 16, "intermediate_size": 128, "moe_intermediate_size": 32,
    "n_routed_experts": 16, "num_experts_per_tok": 4, "n_shared_experts": 1,
    "num_hidden_layers": 3, "first_k_dense_replace": 1,
}
PORT = {"num_experts": 16, "experts_per_token": 4, "moe_d_ff": 32,
        "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
        "v_head_dim": 16, "num_shared_experts": 1, "first_k_dense": 1,
        "vocab_size": 64}
# the tiny cell's limit, set as PERF.md sets a cell's from CPU readings:
# the bf16 program against the fp32 reference on 16 seeds 3000000011 +
# 7919 i in 0.2, 0.5 and 1 s windows, at most 0.0156 (lower); round:e4m3
# on 6 seeds 3000104740 + 7919 i (0.5 s), 0.0440-0.0652 (upper);
# lower^0.45 upper^0.55 = 0.0276
LIMITS = {"worst_rel_l2": {"limit": 0.028, "control": "round:e4m3"}}


def config() -> dict:
    """The tiny configuration: the file's, shrunk."""
    cfg = harness.load_json(harness.HERE / "configs" / "deepseek-v2-lite.json")
    cfg = copy.deepcopy(cfg)
    cfg.update(SIZES, name="deepseek-v2-lite-tiny", num_layers=3, d_model=64,
               num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
               latent_dim=8, sample_shape=[16, 8])
    cfg["port"].update(PORT)
    return cfg


def cell(monkeypatch, limits_dir, traffic_batch: int = 4) -> tuple:
    """(manifest, configuration, traffic) of the tiny cell, a closed loop
    of unconditional replays, with its limits file in `limits_dir`."""
    monkeypatch.setattr(harness, "LIMITS", limits_dir)
    (limits_dir / f"{CELL}.json").write_text(json.dumps(LIMITS))
    cfg = config()
    man = copy.deepcopy(harness.manifest())
    man["configs"].append({"name": cfg["name"], "source": cfg["source"],
                           "file": "perfbench/configs/tiny.json",
                           "reduced": [], "why": "the CPU proof"})
    man["workloads"].append({"name": CELL, "config": cfg["name"],
                             "traffic": "batch16", "chips": 1,
                             "why": "the CPU proof"})
    for m in man["end_to_end"]:
        if m["name"] == "images_per_s":
            m["workloads"].append(CELL)
    traffic = harness.load_json(harness.HERE / "traffic" / "batch16.json")
    traffic["batch"] = traffic_batch
    return man, cfg, traffic
