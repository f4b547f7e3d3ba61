"""Model configurations: a copy of the reference's, one module per
architecture (see :mod:`.base`)."""
from .base import ModelConfig, MoECfg, SSMCfg, TernaryCfg
from .registry import ARCH_IDS, all_configs, get_config, get_smoke_config
from .shapes import SHAPES, SMOKE_SHAPES, ShapeCell, applicable

__all__ = ["ModelConfig", "MoECfg", "SSMCfg", "TernaryCfg", "ARCH_IDS",
           "all_configs", "get_config", "get_smoke_config", "SHAPES",
           "SMOKE_SHAPES", "ShapeCell", "applicable"]
