"""Architecture registry: ``--arch <id>`` -> (config, smoke_config).

The registry is the reference package's list, held equal to it id for id
and field for field (``tests/test_torch_configs.py``).  A configuration
the port serves beyond it (:mod:`.granite_4_0_h_small`, whose knobs are
fields of subclasses the reference has not) lives in a module of its own
and is not registered."""
from __future__ import annotations

from . import (gemma3_27b, jamba_v0_1_52b, mamba2_2_7b, moonshot_v1_16b_a3b,
               phi3_vision_4_2b, qwen2_72b, qwen3_0_6b, qwen3_moe_30b_a3b,
               seamless_m4t_medium, yi_34b)
from .base import ModelConfig

_MODULES = {
    "jamba-v0.1-52b": jamba_v0_1_52b,
    "qwen3-0.6b": qwen3_0_6b,
    "gemma3-27b": gemma3_27b,
    "qwen2-72b": qwen2_72b,
    "yi-34b": yi_34b,
    "phi-3-vision-4.2b": phi3_vision_4_2b,
    "seamless-m4t-medium": seamless_m4t_medium,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "mamba2-2.7b": mamba2_2_7b,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    return _MODULES[arch].config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _MODULES[arch].smoke_config()


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
