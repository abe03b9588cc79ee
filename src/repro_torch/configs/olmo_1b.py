"""olmo-1b [dense]: 16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304,
non-parametric LayerNorm, GELU MLP (OLMo uses plain SwiGLU-free MLP at 1B),
tied embeddings. [arXiv:2402.00838]"""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="olmo-1b", family="dense", source="arXiv:2402.00838",
        num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=8192, vocab_size=50304, norm="nonparam_ln", act="gelu",
        tie_embeddings=True, latent_dim=64,
    )
