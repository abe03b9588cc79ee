"""dit-cifar — unconditional CIFAR10-scale pixel diffusion backbone: 8 blocks,
d_model=384, 64 tokens of dim 48 (4x4 patches of 32x32x3 pixels).
[Song et al. 2021b for the setting]."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="dit-cifar", family="dit", source="arXiv:2011.13456",
        num_layers=8, d_model=384, num_heads=6, num_kv_heads=6,
        d_ff=1536, vocab_size=0, act="gelu", norm="layernorm",
        latent_dim=48, patch_tokens=64,
    )
