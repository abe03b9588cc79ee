"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
8 experts top-2, native sliding-window attention (4096). [arXiv:2401.04088]

About 47B parameters: it does not fit one H100 (80 GB) at full width, so
the port runs it reduced (`reduced()`), in the CPU tests only."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="mixtral-8x7b", family="moe", source="arXiv:2401.04088",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=32000,
        num_experts=8, experts_per_token=2, moe_d_ff=14336,
        sliding_window=4096, latent_dim=64,
    )
