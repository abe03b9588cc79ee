"""qwen2-0.5b [dense]: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936,
QKV bias, tied embeddings, rope theta 1e6. [arXiv:2407.10671]

Fits one H100 at full width (about 0.5B parameters: 2.0 GB in fp32 and a
1.0 GB bf16 copy of the weights kept once)."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen2-0.5b", family="dense", source="arXiv:2407.10671",
        num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
        d_ff=4864, vocab_size=151936, qkv_bias=True, tie_embeddings=True,
        rope_theta=1e6, latent_dim=64,
    )
