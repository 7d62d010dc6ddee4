"""Architecture registry (counterpart of ``repro.configs``): ``--arch <id>``
resolution for the launchers. Lookup refuses no known arch; the model
refuses what the port does not run yet."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (ArchConfig, InputShape, MoEConfig,
                                      SamplerConfig)
from repro_torch.configs.shapes import (DECODE_32K, LONG_500K, PREFILL_32K,
                                        SHAPES, TRAIN_4K)

_MODULES: Dict[str, str] = {
    "qwen3-1.7b": "qwen3_1_7b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "minitron-8b": "minitron_8b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "grok-1-314b": "grok_1_314b",
    "whisper-large-v3": "whisper_large_v3",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "gemma-7b": "gemma_7b",
    "rwkv6-7b": "rwkv6_7b",
}

ARCH_NAMES = tuple(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    return _module(name).smoke_config()


def get_shape(name: str) -> InputShape:
    return SHAPES[name]


__all__ = [
    "ArchConfig", "InputShape", "MoEConfig", "SamplerConfig",
    "ARCH_NAMES", "SHAPES", "get_config", "get_smoke_config", "get_shape",
    "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
]
