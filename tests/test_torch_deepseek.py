"""DeepSeek-V2-Lite in the port (`configs/deepseek_v2_lite.py`): latent
attention (`models/mla.py`) with YaRN rope, the dropless MoE
(`models/moe.py:moe_apply_dropless`) over `kernels/grouped_mm`, shared
experts and a leading dense layer, held in fp32 against the benchmark's
plain reference (`perfbench/reference/deepseek_v2_lite.py`, which imports
nothing of the port) on weights drawn from a seed at a tiny size: each
part, the whole eps-net and one UniPC trajectory. The seeds keep the
router's top k free of ties in fp32, so both sides route alike.

The `gpu` tests run the kernels on the card: the flash_attention forward's
bf16 bodies bit for bit as before its MLA body was added (digests of the
outputs the parent commit's kernel gave on an H100 for the same inputs),
the MLA body (192-deep scores, 128-wide values) against the plain
version, and the grouped matmul and a dropless layer under a CUDA graph.
They take no JAX: `pytest --noconftest -m gpu tests/test_torch_deepseek.py`
runs them on a card.
"""

import dataclasses
import hashlib
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from perfbench import harness  # noqa: E402
from perfbench.params import deepseek_v2_lite as ds_params  # noqa: E402
from perfbench.reference import deepseek_v2_lite as ref  # noqa: E402
from perfbench.reference import unipc as ref_unipc  # noqa: E402
from perfbench.tests.fixtures import deepseek_tiny  # noqa: E402
from repro_torch.configs.base import DeepSeekConfig, ModelConfig  # noqa: E402
from repro_torch.configs.registry import (ARCH_IDS, all_arch_ids,  # noqa: E402
                                          get_config)
from repro_torch.diffusion.schedules import VPLinear  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.grouped_mm import ops as gmm_ops  # noqa: E402
from repro_torch.launch.sample import build_engine  # noqa: E402
from repro_torch.models import api, layers, mla, moe, transformer  # noqa: E402
from repro_torch.obs.counters import DeviceCounters  # noqa: E402

SEED = 2 ** 31 + 4243
TOL = 1e-5          # fp32 against fp32: sums in another order
CPU = torch.device("cpu")


def tiny(**sizes) -> dict:
    """The tiny configuration file in fp32 (weights and activations)."""
    cfg = deepseek_tiny.config()
    cfg.update(dtype="float32", param_dtype="float32", **sizes)
    return cfg


def port(cfg: dict) -> DeepSeekConfig:
    return harness.port_config(cfg)


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------


def test_registry_resolves_it_and_keeps_the_reference_lists():
    cfg = get_config("deepseek-v2-lite")
    assert isinstance(cfg, DeepSeekConfig) and cfg.family == "moe"
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_experts,
            cfg.experts_per_token, cfg.moe_d_ff, cfg.d_ff) == (
                27, 2048, 16, 64, 6, 1408, 10944)
    assert (cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
            cfg.v_head_dim, cfg.num_shared_experts, cfg.first_k_dense) == (
                512, 128, 64, 128, 2, 1)
    assert not cfg.norm_topk_prob and cfg.router_fp32 and cfg.moe_dropless
    assert "deepseek-v2-lite" not in all_arch_ids(True)
    assert all_arch_ids(True) == ARCH_IDS
    # the other configs keep the reference's fields only, at the defaults
    # every model but this one reads
    other = get_config("mixtral-8x7b")
    assert "kv_lora_rank" not in dataclasses.asdict(other)
    assert (other.kv_lora_rank, other.norm_topk_prob, other.norm_eps,
            other.moe_dropless) == (0, True, 1e-5, False)


def test_reduced_keeps_every_kind_of_layer():
    r = get_config("deepseek-v2-lite").reduced()
    assert isinstance(r, DeepSeekConfig)
    assert (r.num_layers, r.first_k_dense, r.num_shared_experts) == (2, 1, 1)
    assert r.kv_lora_rank and r.moe_dropless and r.rope_yarn_factor == 40.0
    p = api.init_params(r, 0, CPU)
    assert set(p["backbone"]) >= {"dense_layers", "layers"}
    assert "moe" in p["backbone"]["layers"]
    assert "mlp" in p["backbone"]["dense_layers"]


def test_the_file_drives_the_port_config():
    cfg = port(harness.load_json(harness.HERE / "configs"
                                 / "deepseek-v2-lite.json"))
    want = get_config("deepseek-v2-lite")
    for f in dataclasses.fields(want):
        assert getattr(cfg, f.name) == getattr(want, f.name), f.name


# ---------------------------------------------------------------------------
# YaRN and latent attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("factor", [40, 1])
def test_yarn_rope_and_scale_match_the_reference(factor):
    cfg = tiny()
    cfg["rope_scaling"] = dict(cfg["rope_scaling"], factor=factor)
    cfg["port"]["rope_yarn_factor"] = float(factor)
    pc = port(cfg)
    S, dr = 37, cfg["qk_rope_head_dim"]
    cos, sin, scale = ref.yarn(cfg, S, CPU)
    freqs = mla.rope_of(pc, CPU)
    x = torch.randn(1, S, 1, dr, generator=torch.Generator().manual_seed(3))
    pos = torch.arange(S)[None]
    got = layers.apply_rope(x, pos, pc.rope_theta, freqs)
    want = ref.rope(x[0, :, 0], cos, sin)
    assert rel(got[0, :, 0], want) < TOL
    assert mla.softmax_scale(pc) == pytest.approx(scale, rel=1e-12)
    if factor > 1:
        assert mla.softmax_scale(pc) == pytest.approx(
            (0.1 * 0.707 * math.log(40) + 1) ** 2 / math.sqrt(24), rel=1e-12)


def _layer(cfg, seed, kind):
    """One layer's fp32 weights from the benchmark's draw: the dense layer
    (kind "dense") or the first MoE layer."""
    p = ds_params.make_params(cfg, seed, CPU)["backbone"]
    tree = p["dense_layers"] if kind == "dense" else p["layers"]
    return {k: v for k, v in ref.f32(tree, 0).items()}


@pytest.mark.parametrize("S", [16, 37])
@pytest.mark.parametrize("factor", [40, 1])
def test_mla_matches_plain_attention(S, factor):
    cfg = tiny()
    cfg["rope_scaling"] = dict(cfg["rope_scaling"], factor=factor)
    cfg["port"]["rope_yarn_factor"] = float(factor)
    w = _layer(cfg, SEED, "dense")["attn"]
    h = torch.randn(3, S, cfg["hidden_size"],
                    generator=torch.Generator().manual_seed(S))
    got = mla.mla_apply(w, h, port(cfg))
    cos, sin, scale = ref.yarn(cfg, S, CPU)
    want = ref.mla(h, w, cfg, cos, sin, scale)
    assert rel(got, want) < TOL


def test_mla_sees_every_position_and_the_rope():
    """Bidirectional: the first position's output moves with the last
    token; and the rope heads matter (a shift of the positions changes the
    scores, where the nope part alone would not see it)."""
    cfg = tiny()
    w = _layer(cfg, SEED, "dense")["attn"]
    pc = port(cfg)
    h = torch.randn(2, 16, cfg["hidden_size"],
                    generator=torch.Generator().manual_seed(9))
    h2 = h.clone()
    h2[:, -1] += 1.0
    assert rel(mla.mla_apply(w, h2, pc)[:, 0], mla.mla_apply(w, h, pc)[:, 0]) \
        > 1e-4
    no_rope = dict(w, wq=w["wq"].clone())
    H, dn, dr = pc.num_heads, pc.qk_nope_head_dim, pc.qk_rope_head_dim
    no_rope["wq"].view(-1, H, dn + dr)[..., dn:] = 0
    assert rel(mla.mla_apply(no_rope, h, pc), mla.mla_apply(w, h, pc)) > 1e-3


# ---------------------------------------------------------------------------
# the dropless MoE
# ---------------------------------------------------------------------------


def _moe_case(skewed: bool):
    cfg = tiny()
    m = _layer(cfg, SEED, "moe")["moe"]
    x = torch.randn(2, 40, cfg["hidden_size"],
                    generator=torch.Generator().manual_seed(11))
    if skewed:
        # every token's first choice is expert 3: its column dominates
        m = dict(m, router=m["router"].clone())
        m["router"][:, 3] = 0.0
        x[..., 0] = x[..., 0].abs() + 4.0
        m["router"][0, 3] = 5.0
    return cfg, m, x


@pytest.mark.parametrize("skewed", [False, True], ids=["spread", "skewed"])
def test_dropless_moe_matches_the_loop_over_experts(skewed):
    cfg, m, x = _moe_case(skewed)
    pc = port(cfg)
    counter = torch.zeros(pc.num_experts, dtype=torch.int64)
    got, _ = moe.moe_apply_dropless(m, x, pc, counter)
    record = []
    want = ref.moe(x.reshape(-1, x.shape[-1]), m, cfg, record)
    assert rel(got.reshape(want.shape), want) < TOL
    assert torch.equal(counter, torch.bincount(record[0].reshape(-1),
                                               minlength=pc.num_experts))
    assert int(counter.sum()) == x.shape[0] * x.shape[1] * pc.experts_per_token
    if skewed:
        assert int(counter[3]) == x.shape[0] * x.shape[1]
        # the capacity-bucketed path drops what overflows expert 3
        capped, _ = moe.moe_apply(m, x, dataclasses.replace(
            pc, moe_dropless=False))
        assert rel(capped.reshape(want.shape), want) > 0.05


def test_routing_rules_are_the_published_ones():
    """Top k not renormalised (their sum is under 1), the router in fp32;
    renormalising moves the result."""
    cfg, m, x = _moe_case(False)
    pc = port(cfg)
    xf = x.reshape(-1, x.shape[-1])
    top_p, top_i, _ = moe._route(m, xf, pc)
    assert float(top_p.sum(-1).max()) < 1.0
    probs = torch.softmax(xf @ m["router"], dim=-1)
    assert torch.equal(top_p, torch.gather(probs, 1, top_i))
    renorm = dataclasses.replace(pc, norm_topk_prob=True)
    a, _ = moe.moe_apply_dropless(m, x, pc)
    b, _ = moe.moe_apply_dropless(m, x, renorm)
    assert rel(b, a) > 1e-2


@pytest.mark.parametrize("sizes", [(5, 0, 7, 3), (0, 0, 9, 0), (4, 4, 4, 4)])
def test_grouped_mm_plain_is_the_product_of_each_group(sizes):
    g = torch.Generator().manual_seed(sum(sizes))
    M, K, N = sum(sizes), 16, 24
    a = torch.randn(M, K, generator=g)
    w = torch.randn(len(sizes), K, N, generator=g)
    offs = torch.cumsum(torch.tensor(sizes), 0).to(torch.int32)
    got = gmm_ops.grouped_mm(a, w, offs)
    start, rows = 0, []
    for e, n in enumerate(sizes):
        rows.append(a[start:start + n] @ w[e])
        start += n
    assert torch.equal(got, torch.cat(rows))


def test_grouped_mm_counts_its_work():
    a, w = torch.zeros(10, 16), torch.zeros(3, 16, 8)
    c = gmm_ops.cost(a, w, torch.tensor([2, 5, 10], dtype=torch.int32))
    assert c.flops == 2 * 10 * 16 * 8 and c.matmul


# ---------------------------------------------------------------------------
# the whole eps-net and a trajectory
# ---------------------------------------------------------------------------


def test_whole_eps_net_matches_the_reference():
    cfg = tiny()
    params = ds_params.make_params(cfg, SEED, CPU)
    x = torch.randn(2, 16, cfg["latent_dim"],
                    generator=torch.Generator().manual_seed(5))
    t = torch.tensor([0.9, 0.2])
    got = api.eps_network(port(cfg))(params, x, t, {})
    record = []
    want = ref.eps(params, cfg, x, t, record)
    assert rel(got, want) < TOL
    assert len(record) == cfg["num_hidden_layers"] - 1
    assert float(want.abs().max()) > 0.1         # out_proj drawn, not zero


def test_unipc_trajectory_matches_the_reference():
    cfg = tiny()
    traffic = harness.load_json(harness.HERE / "traffic" / "batch16.json")
    solver = traffic["solver"]
    eng = build_engine(port(cfg), ds_params.make_params(cfg, SEED, CPU),
                       VPLinear(), batch=3, seed=SEED, device=CPU)
    from perfbench import program

    run = eng.build(program.spec(cfg, traffic, "none"))
    x_T = torch.randn(3, 16, cfg["latent_dim"],
                      generator=torch.Generator().manual_seed(6))
    got = run(x_T)
    want = ref.sample(cfg, ds_params.make_params(cfg, SEED, CPU), x_T, None,
                      None, solver)
    err = ((got.double() - want).flatten(1).norm(dim=1)
           / want.flatten(1).norm(dim=1))
    assert float(err.max()) < TOL
    assert len(ref_unipc.timesteps(ref_unipc.schedule_of(solver), 10,
                                   "logsnr")) == 11


def test_engine_runs_carry_the_routed_rows():
    cfg = tiny()
    pc = port(cfg)
    eng = build_engine(pc, ds_params.make_params(cfg, SEED, CPU), VPLinear(),
                       batch=2, seed=SEED, device=CPU)
    assert isinstance(eng.counters, DeviceCounters)
    from perfbench import program

    traffic = harness.load_json(harness.HERE / "traffic" / "batch16.json")
    run = eng.build(program.spec(cfg, traffic, "none"))
    run(torch.randn(2, 16, cfg["latent_dim"]))
    rows = run.counters.read()["moe.routed_rows"]
    assert rows.shape == (cfg["num_hidden_layers"] - 1, pc.num_experts)
    # every eval routes each of the 2 x 16 tokens to k experts in each layer
    assert (rows.sum(dim=1) == run.evals * 2 * 16 * pc.experts_per_token).all()
    run.counters.reset()
    assert int(run.counters.read()["moe.routed_rows"].sum()) == 0


def test_an_eager_eval_lays_its_ranges_and_changes_nothing():
    """While a profiler records, an eager eval lays `mla.attention` once a
    layer and `moe.route`, `moe.experts`, `moe.combine` once a MoE layer
    on its timeline; the result is the one without it."""
    from torch.profiler import ProfilerActivity, profile

    cfg = tiny()
    params = ds_params.make_params(cfg, SEED, CPU)
    net = api.eps_network(port(cfg))
    x = torch.randn(2, 16, cfg["latent_dim"],
                    generator=torch.Generator().manual_seed(8))
    t = torch.tensor([0.5, 0.5])
    plain = net(params, x, t, {})
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = net(params, x, t, {})
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    L = cfg["num_hidden_layers"]
    moe_layers = L - cfg["first_k_dense_replace"]
    assert names.count("mla.attention") == L
    for name in ("moe.route", "moe.experts", "moe.combine"):
        assert names.count(name) == moe_layers, name
    assert torch.equal(plain, traced)


def test_weights_kept_once_leave_the_router_in_fp32():
    cfg = dict(tiny(), dtype="bfloat16")
    pc = port(cfg)
    p = api.cast_weights_once(pc, ds_params.make_params(cfg, SEED, CPU))
    layers_ = p["backbone"]["layers"]
    assert layers_["moe"]["router"].dtype == torch.float32
    assert layers_["moe"]["w_gate"].dtype == torch.bfloat16
    assert layers_["attn"]["wkv_b"].dtype == torch.bfloat16
    assert p["diffusion_head"]["t_mlp1"].dtype == torch.float32


@pytest.mark.parametrize("fn", ["prefill", "decode_step", "init_cache"])
def test_the_decode_cache_paths_refuse_latent_attention(fn):
    pc = get_config("deepseek-v2-lite").reduced()
    args = {"prefill": (None, pc, torch.zeros(1, 4, dtype=torch.long), 8),
            "decode_step": (None, pc, None, torch.zeros(1, 1), 0),
            "init_cache": (pc, 1, 8)}[fn]
    with pytest.raises(ValueError, match="latent attention"):
        getattr(transformer, fn)(*args)


def test_other_families_blocks_are_unchanged():
    """A mixtral-shaped MoE block still takes the capacity path with its
    renormalised top k, and the transformer builds no dense_layers."""
    pc = get_config("mixtral-8x7b").reduced()
    assert isinstance(pc, ModelConfig) and not isinstance(pc, DeepSeekConfig)
    p = api.init_params(pc, 0, CPU)
    assert "dense_layers" not in p["backbone"]
    xf = torch.randn(6, pc.d_model)
    router = p["backbone"]["layers"]["moe"]["router"][0]
    top_p, _, _ = moe._route({"router": router}, xf, pc)
    assert torch.allclose(top_p.sum(-1), torch.ones(6))


# ---------------------------------------------------------------------------
# flash_attention: the shape checks, and MLA's form off the card
# ---------------------------------------------------------------------------


def _qkv(q, k, v, dtype=torch.bfloat16):
    return tuple(torch.zeros(s, dtype=dtype) for s in (q, k, v))


# shapes the forward refused before the MLA body and still refuses
REFUSED = [
    ((1, 2, 8, 136), (1, 2, 8, 136), (1, 2, 8, 136)),    # D > 128
    ((1, 2, 8, 64), (1, 2, 8, 64), (1, 2, 9, 64)),       # v's Skv
    ((1, 2, 8, 64), (1, 2, 8, 64), (1, 2, 8, 32)),       # v narrower
    ((1, 3, 8, 64), (1, 2, 8, 64), (1, 2, 8, 64)),       # Hq % Hkv
    ((1, 2, 8, 64), (1, 2, 8, 72), (1, 2, 8, 72)),       # q's D
    ((2, 2, 8, 64), (1, 2, 8, 64), (1, 2, 8, 64)),       # B
    ((1, 2, 8, 192), (1, 2, 8, 192), (1, 2, 8, 64)),     # no such MLA pair
    ((1, 2, 8, 192), (1, 2, 8, 192), (1, 2, 8, 192)),    # D > 128
]


@pytest.mark.parametrize("shapes", REFUSED, ids=range(len(REFUSED)))
def test_attention_shape_checks_still_raise(shapes):
    with pytest.raises(ValueError):
        fa_kernel.check_operands(*_qkv(*shapes))


def test_attention_checks_take_the_mla_pair_in_bf16_only():
    shapes = ((2, 4, 8, 192), (2, 4, 8, 192), (2, 4, 8, 128))
    assert fa_kernel.check_operands(*_qkv(*shapes)) == (2, 4, 4, 8, 8, 192,
                                                        128)
    with pytest.raises(ValueError, match="bf16"):
        fa_kernel.check_operands(*_qkv(*shapes, dtype=torch.float32))
    q, k, _ = _qkv(*shapes)
    v = torch.zeros(2, 4, 128, 8, dtype=torch.bfloat16).transpose(2, 3)
    with pytest.raises(ValueError, match="stride"):
        fa_kernel.check_operands(q, k, v)
    for D in (32, 64, 72, 128):
        s = (1, 2, 8, D)
        assert fa_kernel.check_operands(*_qkv(s, s, s))[5:] == (D, D)


def test_the_mla_plan_compiles_no_padding():
    q = torch.zeros(2, 8, 4, 16, 192, dtype=torch.bfloat16)[0].transpose(1, 2)
    k = q.clone()
    v = torch.zeros(2, 8, 4, 16, 128, dtype=torch.bfloat16)[0].transpose(1, 2)
    out = fa_kernel._empty_out(q, 128)
    assert out.shape == (8, 16, 4, 128) and out.stride(3) == 1
    p = fa_kernel.plan(q, k, v, out)
    assert (p["body"], p["chunks"] * 8, p["chunks_v"] * 8) == ("mla", 192,
                                                                128)


def test_mla_form_takes_the_plain_version_off_the_card():
    g = torch.Generator().manual_seed(2)
    q, k = (torch.randn(2, 4, 33, 192, generator=g) for _ in range(2))
    v = torch.randn(2, 4, 33, 128, generator=g)
    got = fa_ops.attention(q, k, v, causal=False, scale=0.3)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * 0.3
    want = torch.softmax(s, -1) @ v
    assert got.shape == (2, 4, 33, 128) and rel(got, want) < TOL
    q.requires_grad_(True)
    with pytest.raises(ValueError, match="forward only"):
        fa_ops.attention(q, k, v, causal=False, scale=0.3)


def test_attention_cost_counts_both_widths():
    q = k = torch.zeros(1, 2, 8, 192, dtype=torch.bfloat16)
    v = torch.zeros(1, 2, 8, 128, dtype=torch.bfloat16)
    c = fa_ops.cost(q, k, v, causal=False, window=None)
    assert c.flops == 2 * 2 * 64 * (192 + 128)
    assert c.bytes == 2 * (2 * 16 * 192 + 16 * 128 + 16 * 128)
    same = fa_ops.cost(q, k, k, causal=True, window=None)
    assert same.flops == 4 * 2 * 36 * 192        # as before: 4 pairs D


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


# (B, H, S, D, causal) -> sha256[:32] of out, lse and o32 that the parent
# commit's flash_attention gave for these inputs on an NVIDIA H100 80GB HBM3
# (torch 2.11.0+cu128): the bf16 bodies of D 72 (dit-i256, 9 chunks), 64
# (dit-s4-cifar, 8), 32 (4) and 128 (16)
PARENT_DIGESTS = {
    (4, 16, 256, 72, False): ("e705efcf94c70b00887c355b173cfec9",
                              "76abc69e236e75e2991e48e8f8fda786",
                              "4d5fd00182248ed5f097c911a67d5f99"),
    (8, 6, 64, 64, False): ("6dbe9f859dbe6a09fcdb51af97207122",
                            "265561ceca3de2393e421226e86d3eac",
                            "37845472f2b2663b3267078c2f0b8c16"),
    (4, 4, 256, 32, False): ("8daa761ccb2d76f4ac83b22803dfa8ca",
                             "2bb1703f7c8f2f202430ff87cef29d9c",
                             "82991029b5ae17640b50ac7115fb0ec4"),
    (2, 8, 512, 128, False): ("c9cceb939c07f75ce8d6ad5ff30e0172",
                              "6e33310ef1e55c36f3f95216e38799a7",
                              "ee81fe111987fd8fd6ab44b244cd7f4e"),
    (2, 8, 300, 128, True): ("e8446527e464415ab5ce00471dec1fac",
                             "08d17102f3ef8528378406310bb394df",
                             "49b0280289aea66688328494b4ff200a"),
    (3, 16, 256, 72, True): ("6ab1790ce18c68d4cc9673f183fc4ba3",
                             "1ce30c2a6f3d3f4430d0be681267fd6b",
                             "51f1d5cc9fc62df50eca4252a66646dc"),
}


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().view(torch.uint8)
                          .numpy().tobytes()).hexdigest()[:32]


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(PARENT_DIGESTS), ids=str)
def test_card_dit_bodies_are_bit_equal_to_the_parents(cuda, case):
    B, H, S, D, causal = case
    g = torch.Generator().manual_seed(1000 + list(PARENT_DIGESTS).index(case))
    q, k, v = (torch.randn(B, S, H, D, generator=g).to(torch.bfloat16)
               .to(cuda).transpose(1, 2) for _ in range(3))
    out = fa_kernel.flash_attention(q, k, v, causal=causal)
    o2, lse, o32 = fa_kernel.flash_attention(q, k, v, causal=causal,
                                             lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, o2)
    assert (_digest(out), _digest(lse), _digest(o32)) == PARENT_DIGESTS[case]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,S,causal", [(2, 16, 1024, False),
                                          (3, 4, 300, False),
                                          (2, 4, 200, True)])
def test_card_mla_body_matches_plain(cuda, B, H, S, causal):
    g = torch.Generator(device=cuda).manual_seed(S)
    # the model's layout: head-major views of (B, S, H, D) projections, v a
    # view of the kv projection's second half
    q, k = (torch.randn(B, S, H, 192, generator=g, device=cuda)
            .to(torch.bfloat16).transpose(1, 2) for _ in range(2))
    kv = torch.randn(B, S, H, 256, generator=g, device=cuda).to(
        torch.bfloat16)
    v = kv[..., 128:].transpose(1, 2)
    scale = 192 ** -0.5 * 1.5896
    assert fa_kernel.plan(q, k, v, fa_kernel._empty_out(q, 128))["vec_in"]
    got = fa_ops.attention(q, k, v, causal=causal, scale=scale)
    want = fa_ref.attention32(q, k, v, causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert got.shape == (B, H, S, 128) and got.transpose(1, 2).is_contiguous()
    err = float((got.float() - want).abs().max() / want.abs().max())
    assert err <= 1e-2
    out, lse, o32 = fa_kernel.flash_attention(q, k, v, causal=causal,
                                              scale=scale, lse=True)
    assert float((o32 - want).abs().max() / want.abs().max()) <= 1e-3
    assert torch.equal(out, got)


@pytest.mark.gpu
def test_card_grouped_mm_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    sizes = torch.tensor([300, 0, 1536, 77, 1000, 16])
    a = torch.randn(int(sizes.sum()), 2048, generator=g, device=cuda).to(
        torch.bfloat16)
    w = (torch.randn(6, 2048, 1408, generator=g, device=cuda)
         / 45.0).to(torch.bfloat16)
    offs = torch.cumsum(sizes, 0).to(torch.int32).to(cuda)
    got = gmm_ops.grouped_mm(a, w, offs)
    want = gmm_ops.grouped_mm(a.float(), w.float(), offs, backend="plain")
    torch.cuda.synchronize()
    assert float((got.float() - want).norm() / want.norm()) < 1e-2


@pytest.mark.gpu
def test_card_dropless_layer_replays_as_its_eager_run(cuda):
    cfg = dict(tiny(), dtype="bfloat16", param_dtype="bfloat16")
    cfg.update(hidden_size=256, moe_intermediate_size=64, d_model=256)
    cfg["port"].update(moe_d_ff=64)
    pc = port(cfg)
    m = ds_params.make_params(cfg, SEED, cuda)["backbone"]["layers"]
    m = {k: v[0] for k, v in m["moe"].items() if k != "shared"}
    x = torch.randn(4, 128, 256, device=cuda).to(torch.bfloat16)
    counter = torch.zeros(pc.num_experts, dtype=torch.int64, device=cuda)
    eager, _ = moe.moe_apply_dropless(m, x, pc, counter)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        moe.moe_apply_dropless(m, x, pc, counter)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, _ = moe.moe_apply_dropless(m, x, pc, counter)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert int(counter.sum()) == 3 * 4 * 128 * pc.experts_per_token
    want = ref.moe(x.float().reshape(-1, 256),
                   {k: v.float() for k, v in m.items()}
                   | {"shared": {"w_gate": torch.zeros(256, 1, device=cuda),
                                 "w_up": torch.zeros(256, 1, device=cuda),
                                 "w_down": torch.zeros(1, 256, device=cuda)}},
                   cfg)
    assert rel(out.float().reshape(want.shape), want) < 2e-2
