"""zamba2-7b [hybrid]: Mamba2 backbone + one parameter-SHARED attention block
applied every 6 SSM layers. 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64. [arXiv:2411.15242]

Note: the released checkpoints add per-invocation LoRA deltas to the shared
block and concatenate the original embedding into the attention input; both
are omitted here (parameter sharing itself is the architectural feature).
long_500k uses sliding_window=8192 on the shared attention (DESIGN.md §7.2).

About 6.65B parameters: 26.6 GB in fp32 and a 13.3 GB bf16 copy of the
weights kept once, so it serves and samples at full depth on one 80 GB
H100; a full-depth training step (params, gradients and AdamW's two fp32
moments, about 106 GB) does not fit one card."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="zamba2-7b", family="hybrid", source="arXiv:2411.15242",
        num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
        d_ff=14336, vocab_size=32000,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
        attn_every=6, latent_dim=64,
    )
