"""dit-i256 — conditional ImageNet-256 latent diffusion backbone with DiT-XL/2
geometry: 28 blocks, d_model=1152, 16 heads of dim 72, 256 latent patch
tokens of dim 32 (2x2 patches of a 32x32x8 latent). [Peebles & Xie 2023;
Dhariwal & Nichol 2021 for the guided-sampling setting]."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="dit-i256", family="dit", source="arXiv:2212.09748",
        num_layers=28, d_model=1152, num_heads=16, num_kv_heads=16,
        d_ff=4608, vocab_size=0, act="gelu", norm="layernorm",
        latent_dim=32, patch_tokens=256,
    )
