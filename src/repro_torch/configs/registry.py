"""Architecture registry: --arch lookup over the ported configs (every
family of the reference: the decoder-only, SSM, hybrid, vlm and audio token
families and the two DiTs), in the reference's order. Each config file
cites its source."""

from __future__ import annotations

import importlib

from .base import INPUT_SHAPES, InputShape, ModelConfig

ARCH_IDS = [
    # the ten assigned archs, in the reference's order (`all_arch_ids()`)
    "zamba2-7b", "mixtral-8x7b", "qwen2-0.5b", "olmo-1b", "whisper-small",
    "qwen2.5-3b", "granite-moe-3b-a800m", "llama-3.2-vision-90b",
    "deepseek-67b", "mamba2-780m",
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


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]


def all_arch_ids(include_paper_native: bool = False) -> list:
    """The ten assigned archs, and with `include_paper_native` the two DiTs
    after them."""
    return list(ARCH_IDS if include_paper_native else ARCH_IDS[:10])
