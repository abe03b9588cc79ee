"""Model configurations of the ported families (the port's slice of
`repro.configs`): the decoder-only, SSM, hybrid, vlm and audio token
families and the DiTs."""

from .base import INPUT_SHAPES, InputShape, ModelConfig
from .registry import ARCH_IDS, all_arch_ids, get_config, get_shape

__all__ = ["ModelConfig", "InputShape", "INPUT_SHAPES", "ARCH_IDS",
           "all_arch_ids", "get_config", "get_shape"]
