"""qwen2.5-3b [dense]: 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936, QKV bias. [hf:Qwen/Qwen2.5-3B; family card hf:Qwen/Qwen2.5-0.5B]"""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen2.5-3b", family="dense", source="hf:Qwen/Qwen2.5-0.5B",
        num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2,
        d_ff=11008, vocab_size=151936, qkv_bias=True, rope_theta=1e6,
        latent_dim=64,
    )
