"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) per-expert
d_ff=512, vocab=49155, 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base family]

About 3.4B parameters: 13.5 GB in fp32 and 6.7 GB in bf16, so it fits one
H100 at full width."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="granite-moe-3b-a800m", family="moe",
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
        num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
        d_ff=512, vocab_size=49155,
        num_experts=40, experts_per_token=8, moe_d_ff=512,
        latent_dim=64,
    )
