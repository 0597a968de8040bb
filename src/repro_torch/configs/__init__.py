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
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"arch {arch!r} is not ported yet (ported: "
                       f"{sorted(_ARCH_MODULES)}); see ROADMAP.md for the rest")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def get_compressor_config(dataset: str):
    mod = importlib.import_module(f"repro_torch.configs.{dataset}")
    return mod.CONFIG
