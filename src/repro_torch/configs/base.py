"""Model configuration dataclass: the DiT fields of `repro.configs.base`."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class ModelConfig:
    arch_id: str
    family: str                     # only "dit" is ported
    source: str = ""                # citation for the exact numbers

    # transformer core
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: Optional[int] = None
    head_dim: Optional[int] = None
    d_ff: int = 1024

    # diffusion
    latent_dim: int = 0
    patch_tokens: int = 0           # DiT tokens per image

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

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
            dtype="float32",
            param_dtype="float32",
        )
        if self.latent_dim:
            base.update(latent_dim=min(self.latent_dim, 32))
        base.update(overrides)
        return dataclasses.replace(self, **base)
