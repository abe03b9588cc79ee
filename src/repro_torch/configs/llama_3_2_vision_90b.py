"""llama-3.2-vision-90b [vlm]: 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256; gated cross-attention layers every 5th layer read a fixed
buffer of projected image-patch embeddings (ViT encoder STUBBED).
[hf:meta-llama/Llama-3.2-11B-Vision, scaled per assignment]

About 0.86B parameters a layer and a 1.05B embedding (tied: no separate LM
head): about 87B, 173 GB in bf16, so one H100 serves it cut in depth, in
whole groups of 5 layers (`models/vlm.py`)."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="llama-3.2-vision-90b", family="vlm",
        source="hf:meta-llama/Llama-3.2-11B-Vision",
        num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=28672, vocab_size=128256,
        cross_attn_every=5, image_tokens=1600, rope_theta=5e5,
        latent_dim=64,
    )
