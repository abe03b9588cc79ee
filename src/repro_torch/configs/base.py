"""Model configuration dataclass shared by every architecture family (the
port of `repro.configs.base`: the same fields, defaults and `reduced()`;
`activation_dtype` and `weight_dtype` are torch dtypes)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class ModelConfig:
    arch_id: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio | dit
    source: str = ""                # citation for the exact numbers

    # transformer core
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: Optional[int] = None
    head_dim: Optional[int] = None
    d_ff: int = 1024
    vocab_size: int = 1000
    qkv_bias: bool = False
    norm: str = "rmsnorm"           # rmsnorm | layernorm | nonparam_ln
    act: str = "swiglu"             # swiglu | gelu
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None
    tie_embeddings: bool = False

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: Optional[int] = None  # per-expert hidden (granite: 512)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # SSM (Mamba2 / SSD): the ssm family and the hybrid's Mamba2 layers
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 128

    # hybrid (zamba2-style shared attention)
    attn_every: int = 0             # one shared attn block per this many ssm layers

    # VLM (llama-3.2-vision-style cross-attention layers)
    cross_attn_every: int = 0
    image_tokens: int = 0

    # audio enc-dec (whisper-style)
    encoder_layers: int = 0
    audio_frames: int = 0

    # diffusion
    latent_dim: int = 0             # diffusion-LM latent width (0 = AR only)
    patch_tokens: int = 0           # DiT tokens per image

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = False            # checkpoint each block (training)

    # performance knobs (0 = baseline)
    attention_chunk: int = 0       # blockwise attention over query chunks
    moe_shard_map: bool = False    # MoE block under a mesh (none on one card)
    moe_dispatch_groups: int = 0   # group-local MoE dispatch: G groups

    # kernel dispatch pins (kernels/dispatch.py): None = by the tensor's
    # device (the kernel on CUDA, the plain version on the CPU); "plain"
    # pins the plain PyTorch version for parity runs.
    attention_backend: Optional[str] = None
    adaln_backend: Optional[str] = None
    quant_backend: Optional[str] = None      # kernels/quant_matmul dispatch

    # quantized denoiser path (models/quant.py): a QuantSpec when the param
    # tree carries quant records, None for the float path. Typed loosely to
    # keep configs free of a models import.
    quant: Optional[object] = None

    # DeepSeek-V2's latent attention (MLA), YaRN rope and MoE settings are
    # fields of `DeepSeekConfig` only, below (this dataclass carries the
    # reference's fields, field for field); every other config reads their
    # defaults, set on this class from DeepSeekConfig's after it, which
    # leave its model as it was.

    def __post_init__(self):
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads
        if self.head_dim is None and self.num_heads:
            self.head_dim = self.d_model // self.num_heads

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def weight_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def reduced(self, **overrides) -> "ModelConfig":
        """CPU-smoke-test variant of the same family (<=2 layers, small dims);
        the same numbers as `repro.configs.base.ModelConfig.reduced`."""
        base = dict(
            num_layers=2,
            d_model=min(self.d_model, 128),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else None,
            head_dim=32,
            d_ff=min(self.d_ff, 256) or 256,
            vocab_size=min(self.vocab_size, 512),
            dtype="float32",
            param_dtype="float32",
        )
        if self.num_experts:
            base.update(num_experts=min(self.num_experts, 4),
                        experts_per_token=min(self.experts_per_token, 2),
                        moe_d_ff=min(self.moe_d_ff or self.d_ff, 128))
        if self.ssm_state:
            base.update(ssm_state=min(self.ssm_state, 16), ssm_head_dim=32,
                        ssm_chunk=32)
        if self.attn_every:
            base.update(attn_every=2, num_layers=4)
        if self.cross_attn_every:
            base.update(cross_attn_every=2, num_layers=4,
                        image_tokens=min(self.image_tokens, 16) or 16)
        if self.encoder_layers:
            base.update(encoder_layers=2,
                        audio_frames=min(self.audio_frames, 32) or 32)
        if self.latent_dim:
            base.update(latent_dim=min(self.latent_dim, 32))
        base.update(overrides)
        return dataclasses.replace(self, **base)


@dataclass
class DeepSeekConfig(ModelConfig):
    """A DeepSeek-V2 model: multi-head latent attention (MLA), YaRN rope,
    leading dense layers, then MoE layers with shared experts and a
    softmax router over routed experts, dispatched dropless."""

    kv_lora_rank: int = 0           # > 0: MLA over a latent of this width
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    rope_yarn_factor: float = 1.0   # > 1: YaRN-scaled rope (layers.yarn_rope)
    norm_eps: float = 1e-5
    num_shared_experts: int = 0     # one SwiGLU of num_shared x moe_d_ff
    first_k_dense: int = 0          # leading layers with a dense MLP
    norm_topk_prob: bool = True     # renormalise the top-k router weights
    router_fp32: bool = False       # router logits from fp32 x and weights
    moe_dropless: bool = False      # sorted by expert, every token kept

    def reduced(self, **overrides) -> "DeepSeekConfig":
        """The CPU variant: `ModelConfig.reduced`'s sizes, one dense and
        one MoE layer, a small latent and small head splits."""
        base = dict(num_layers=2, first_k_dense=min(self.first_k_dense, 1),
                    num_kv_heads=min(self.num_heads, 4),
                    kv_lora_rank=min(self.kv_lora_rank, 32),
                    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                    head_dim=16, num_shared_experts=min(
                        self.num_shared_experts, 1))
        base.update(overrides)
        return super().reduced(**base)


for _f in dataclasses.fields(DeepSeekConfig):
    if not hasattr(ModelConfig, _f.name):
        setattr(ModelConfig, _f.name, _f.default)
del _f


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
