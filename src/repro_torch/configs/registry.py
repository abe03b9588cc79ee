"""Architecture registry: --arch lookup over the ported configs (every
family of the reference: the decoder-only, SSM, hybrid, vlm and audio token
families and the two DiTs). Each config file cites its source."""

from __future__ import annotations

import importlib

from .base import ModelConfig

ARCH_IDS = [
    # decoder-only token families: dense and MoE transformers
    "qwen2-0.5b", "qwen2.5-3b", "olmo-1b", "deepseek-67b",
    "granite-moe-3b-a800m", "mixtral-8x7b",
    # SSM (Mamba2 / SSD) and hybrid (Mamba2 + shared attention) token families
    "mamba2-780m", "zamba2-7b",
    # vlm (gated cross-attention) and audio (encoder-decoder) token families
    "llama-3.2-vision-90b", "whisper-small",
    # paper-native diffusion backbones
    "dit-i256", "dit-cifar",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; ported: "
                       f"{sorted(_MODULES)}")
    mod = importlib.import_module(f"{__package__}.{_MODULES[arch_id]}")
    return mod.config()
