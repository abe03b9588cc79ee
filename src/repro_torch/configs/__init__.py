"""Model configurations of the DiT family (the port's slice of `repro.configs`)."""

from .base import ModelConfig
from .registry import ARCH_IDS, get_config

__all__ = ["ModelConfig", "ARCH_IDS", "get_config"]
