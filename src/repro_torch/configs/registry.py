"""Architecture registry: --arch lookup over the ported (DiT) configs."""

from __future__ import annotations

import importlib

from .base import ModelConfig

ARCH_IDS = ["dit-i256", "dit-cifar"]

_MODULES = {a: a.replace("-", "_") for a in ARCH_IDS}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown or not yet ported arch {arch_id!r}; "
                       f"ported: {sorted(_MODULES)}")
    mod = importlib.import_module(f"{__package__}.{_MODULES[arch_id]}")
    return mod.config()
