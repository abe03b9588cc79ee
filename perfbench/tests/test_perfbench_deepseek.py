"""DeepSeek-V2-Lite's cell whole through `harness.run_cell` on the CPU at a
tiny size (`fixtures/deepseek_tiny.py`: the configuration file's keys
shrunk, the benchmark's own weights and reference): correct on several
seeds, not correct under the weight-rounding control and under planted
faults of the program's MoE (the top-k weights renormalised, the shared
experts left out). And the roofline bounds count the published work."""

import copy
import math
import time

import pytest
import torch

from perfbench import harness, weights
from perfbench.bounds import deepseek_v2_lite as bounds
from perfbench.tests.fixtures import deepseek_tiny

PROGRAM_SEEDS = [3_000_000_011 + 7919 * i for i in range(4)]
CONTROL_SEED = 3_000_104_740


def reading(monkeypatch, tmp_path, seed, control=None, port=None) -> dict:
    man, cfg, traffic = deepseek_tiny.cell(monkeypatch, tmp_path)
    cfg["port"].update(port or {})
    return harness.run_cell(man, deepseek_tiny.CELL, seed, 0.5, False,
                            torch.device("cpu"), time.perf_counter(),
                            control=control, cfg_override=cfg,
                            traffic_override=traffic)


@pytest.mark.parametrize("seed", PROGRAM_SEEDS)
def test_tiny_cell_is_correct(seed, monkeypatch, tmp_path):
    out = reading(monkeypatch, tmp_path, seed)
    assert out["correct"], out["check"]
    assert out["attempted"] >= 4 and out["failed"] == 0
    assert 0 < out["check"]["worst_rel_l2"]["value"]


def test_tiny_cell_is_not_correct_with_rounded_weights(monkeypatch,
                                                       tmp_path):
    out = reading(monkeypatch, tmp_path, CONTROL_SEED, control="round:e4m3")
    assert not out["correct"], out["check"]


def test_tiny_cell_is_not_correct_with_renormalised_top_k(monkeypatch,
                                                          tmp_path):
    out = reading(monkeypatch, tmp_path, PROGRAM_SEEDS[0],
                  port={"norm_topk_prob": True})
    assert not out["correct"], out["check"]


def test_tiny_cell_is_not_correct_without_shared_experts(monkeypatch,
                                                         tmp_path):
    from repro_torch.models import moe

    monkeypatch.setattr(moe, "mlp_apply",
                        lambda p, x, cfg: torch.zeros_like(x))
    out = reading(monkeypatch, tmp_path, PROGRAM_SEEDS[0])
    assert not out["correct"], out["check"]


def test_weights_are_the_seeds_and_only_what_the_eps_net_reads():
    cfg = deepseek_tiny.config()
    a = weights.make_params(cfg, 7, torch.device("cpu"))
    b = weights.make_params(cfg, 7, torch.device("cpu"))
    c = weights.make_params(cfg, 8, torch.device("cpu"))
    assert set(a) == {"backbone", "diffusion_head"}
    assert "embed" not in a["backbone"] and "lm_head" not in a["backbone"]
    assert torch.equal(a["diffusion_head"]["out_proj"],
                       b["diffusion_head"]["out_proj"])
    assert not torch.equal(a["diffusion_head"]["out_proj"],
                           c["diffusion_head"]["out_proj"])
    assert float(a["diffusion_head"]["out_proj"].abs().max()) > 0
    moe = a["backbone"]["layers"]["moe"]
    assert moe["w_gate"].shape == (2, 16, 64, 32)
    assert moe["shared"]["w_gate"].shape == (2, 64, 32)
    assert a["backbone"]["dense_layers"]["mlp"]["w_up"].shape == (1, 64, 128)
    assert moe["w_gate"].dtype == torch.bfloat16


def test_the_configuration_is_the_published_one():
    cfg = harness.load_json(harness.HERE / "configs" / "deepseek-v2-lite.json")
    assert cfg["reduced"] == []
    assert (cfg["num_hidden_layers"], cfg["hidden_size"],
            cfg["n_routed_experts"], cfg["n_shared_experts"],
            cfg["num_experts_per_tok"], cfg["moe_intermediate_size"],
            cfg["intermediate_size"], cfg["kv_lora_rank"]) == (
                27, 2048, 64, 2, 6, 1408, 10944, 512)
    assert cfg["sample_shape"] == [1024, 64]
    assert cfg["dtype"] == cfg["param_dtype"] == "bfloat16"
    assert cfg["deployment"] == "one H100 holds the whole model"


def test_bounds_count_the_published_work():
    cfg = harness.load_json(harness.HERE / "configs" / "deepseek-v2-lite.json")
    flops = 6 * 16384 * 3 * 2 * 2048 * 1408          # a MoE layer's eval
    assert bounds.expert_bound_s(cfg, 16, 1) == pytest.approx(
        26 * flops / 989e12, rel=1e-12)
    attn = 2 * 16 * 16 * 1024 ** 2 * (192 + 128)     # an MLA layer's eval
    assert bounds.mla_attention_bound_s(cfg, 16, 10) == pytest.approx(
        10 * 27 * attn / 989e12, rel=1e-12)
    small = copy.deepcopy(cfg)
    small["sample_shape"] = [1, 64]                    # bytes-bound there
    assert bounds.expert_bound_s(small, 1, 1) > 26 * 6 * 3 * 2 * 2048 \
        * 1408 / 989e12
    assert math.isfinite(bounds.mla_attention_bound_s(small, 1, 1))


def test_dense_bound_and_model_flops_count_the_published_work():
    cfg = harness.load_json(harness.HERE / "configs" / "deepseek-v2-lite.json")
    sites = bounds.dense_sites(cfg)
    # the head's 3 and out_proj, MLA's 4 a layer, layer 0's 3, 4 a MoE layer
    assert len(sites) == 3 + 27 * 4 + 3 + 26 * 4 + 1
    mla_proj = 2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048
    moe = 2048 * 64 + 6 * 3 * 2048 * 1408 + 3 * 2048 * 2816
    per_token = 27 * mla_proj + 3 * 2048 * 10944 + 26 * moe + 2 * 64 * 2048
    head = 256 * 2048 + 2048 * 2048
    attn = 27 * 2 * 1024 ** 2 * 16 * (192 + 128)
    want = 2.0 * (per_token * 1024 + head) + attn
    assert bounds.model_flops(cfg, 16, 10) == pytest.approx(
        160 * want, rel=1e-12)
    # about 7.8e13 an eval of 16 sequences, the work the cell is sized by
    assert 7.5e13 < bounds.model_flops(cfg, 16, 1) < 8.0e13
    # operations-bound at the cell's size: the products over the peaks
    flops_bf16 = sum(2.0 * 16 * m * k * n for _, m, k, n, dt in sites
                     if dt == "bfloat16")
    assert bounds.dense_bound_s(cfg, 16, 1) >= flops_bf16 / 989e12
    assert bounds.dense_bound_s(cfg, 16, 3) == pytest.approx(
        3 * bounds.dense_bound_s(cfg, 16, 1), rel=1e-12)


@pytest.mark.parametrize("name,dense", [
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", True),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x32", True),
    ("cutlass_80_simt_sgemm_256x128_8x4_nn_align1", True),
    ("void cublasLt::splitKreduce_kernel<32, 16, int, float>", True),
    ("_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_for_"
     "sm9xINS_4gemm6kernel13GemmUniversalINS5_17GroupProblemShapeIN4cute5"
     "tupleIJiiiEEEEE", False),
    ("void attn_mla_kernel<24, 16>(__nv_bfloat16 const*)", False),
    ("void at::native::elementwise_kernel<128, 4>", False),
])
def test_dense_roofline_names_cublas_and_not_the_grouped_gemms(name, dense):
    import re

    spec = harness.load_json(harness.HERE / "metrics"
                             / "lm.dense_roofline.json")
    hit = any(re.search(p, name, re.IGNORECASE) for p in spec["kernels"])
    assert hit == dense
    experts = harness.load_json(harness.HERE / "metrics"
                                / "lm.expert_roofline.json")
    grouped = any(re.search(p, name, re.IGNORECASE)
                  for p in experts["kernels"])
    assert not (hit and grouped)
