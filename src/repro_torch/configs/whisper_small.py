"""whisper-small [audio]: enc-dec, 12 encoder + 12 decoder layers,
d_model=768 12H d_ff=3072 vocab=51865; conv/mel frontend STUBBED: the
inputs are 1500 precomputed frame embeddings. [arXiv:2212.04356]

Fits one H100 at full width and depth (about 0.24B parameters)."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="whisper-small", family="audio", source="arXiv:2212.04356",
        num_layers=12, encoder_layers=12, d_model=768, num_heads=12,
        num_kv_heads=12, d_ff=3072, vocab_size=51865, act="gelu",
        norm="layernorm", audio_frames=1500, latent_dim=64,
    )
