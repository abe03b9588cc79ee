"""mamba2-780m [ssm]: attention-free SSD stack, 48L d_model=1536,
ssm_state=128, vocab=50280. [arXiv:2405.21060]

About 0.79B parameters: 3.1 GB in fp32 and a 1.6 GB bf16 copy of the
weights kept once, so it serves and trains at full depth on one H100."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="mamba2-780m", family="ssm", source="arXiv:2405.21060",
        num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0, head_dim=0,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
        latent_dim=64,
    )
