"""Architecture registry: ``get_config(arch_id)`` / ``ARCH_IDS``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES_BY_NAME,
    TRAIN_4K,
    ModelConfig,
    Segment,
    ShapeConfig,
    shape_applicable,
)

_MODULES = {
    "rwkv6-1.6b": "rwkv6_1p6b",
    "stablelm-12b": "stablelm_12b",
    "qwen3-1.7b": "qwen3_1p7b",
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "qwen1.5-110b": "qwen1p5_110b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "whisper-medium": "whisper_medium",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "paligemma-3b": "paligemma_3b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


__all__ = [
    "ARCH_IDS",
    "get_config",
    "ModelConfig",
    "Segment",
    "ShapeConfig",
    "ALL_SHAPES",
    "SHAPES_BY_NAME",
    "TRAIN_4K",
    "PREFILL_32K",
    "DECODE_32K",
    "LONG_500K",
    "shape_applicable",
]
