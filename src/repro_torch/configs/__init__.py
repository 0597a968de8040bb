"""Config registry: the paper's compressor configurations (S3D, E3SM, XGC)
and ``get_config("<arch-id>")`` for the LM architectures the port runs."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "qwen3-1.7b": "qwen3_1_7b",
    "qwen2-1.5b": "qwen2_1_5b",
    "mamba2-370m": "mamba2_370m",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "whisper-medium": "whisper_medium",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def get_compressor_config(dataset: str):
    mod = importlib.import_module(f"repro_torch.configs.{dataset}")
    return mod.CONFIG
