"""deepseek-v2-lite [moe]: 27L d_model=2048 16H, multi-head latent
attention (kv_lora_rank 512, no q LoRA; qk heads of 128 + 64 rope, v heads
of 128) with YaRN rope (factor 40 over 4096 positions, theta 10000); layer
0 a dense SwiGLU of 10944, layers 1-26 MoE: 64 routed SwiGLU experts of
1408, top 6 by a softmax router, weights not renormalised, and 2 shared
experts; RMSNorm eps 1e-6, vocab 102400. Its `routed_scaling_factor` is 1
and its YaRN `mscale` equals `mscale_all_dim` (0.707), so the routed
weights and rope's cos and sin are not scaled; YaRN's other settings
(original 4096 positions, beta_fast 32, beta_slow 1, mscale_all_dim
0.707) are `models/layers.py`'s YARN_* constants.
[hf:deepseek-ai/DeepSeek-V2-Lite config.json; arXiv:2405.04434]

15.29B parameters without the embedding and the LM head, 30.6 GB in bf16:
one H100 holds it whole, so it keeps its weights in bf16, as released.
Inference is dropless: every token reaches its 6 experts."""

from .base import DeepSeekConfig


def config() -> DeepSeekConfig:
    return DeepSeekConfig(
        arch_id="deepseek-v2-lite", family="moe",
        source="hf:deepseek-ai/DeepSeek-V2-Lite",
        num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
        head_dim=128, d_ff=10944, vocab_size=102400, rope_theta=10000.0,
        num_experts=64, experts_per_token=6, moe_d_ff=1408,
        kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128, rope_yarn_factor=40.0, norm_eps=1e-6,
        num_shared_experts=2, first_k_dense=1, norm_topk_prob=False, router_fp32=True,
        moe_dropless=True, latent_dim=64, param_dtype="bfloat16",
    )
