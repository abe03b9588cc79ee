"""deepseek-67b [dense]: llama-arch, 95L d_model=8192 64H (GQA kv=8)
d_ff=22016 vocab=102400. [arXiv:2401.02954]

About 67B parameters: it does not fit one H100 (80 GB) at full width, so
the port runs it reduced (`reduced()`), in the CPU tests only."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="deepseek-67b", family="dense", source="arXiv:2401.02954",
        num_layers=95, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=22016, vocab_size=102400, latent_dim=64,
    )
