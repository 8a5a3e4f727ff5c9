"""--arch <id> registry for the 10 assigned architectures."""
from __future__ import annotations

from . import (deepseek_moe_16b, llama4_maverick_400b_a17b, mistral_nemo_12b,
               olmo_1b, pixtral_12b, qwen1_5_110b, qwen2_7b, rwkv6_7b,
               seamless_m4t_medium, zamba2_1_2b)
from .base import SHAPES, ModelConfig, ShapeConfig, shape_applicable

_MODULES = [
    qwen1_5_110b, qwen2_7b, mistral_nemo_12b, olmo_1b, zamba2_1_2b,
    deepseek_moe_16b, llama4_maverick_400b_a17b, seamless_m4t_medium,
    pixtral_12b, rwkv6_7b,
]

ARCHS: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
SMOKES: dict[str, ModelConfig] = {m.CONFIG.name: m.SMOKE for m in _MODULES}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_smoke(name: str) -> ModelConfig:
    return SMOKES[name]


def list_archs() -> list[str]:
    return list(ARCHS)
