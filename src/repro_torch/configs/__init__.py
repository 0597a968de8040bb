"""The paper's compressor configurations (S3D, E3SM, XGC)."""
from __future__ import annotations

import importlib


def get_compressor_config(dataset: str):
    mod = importlib.import_module(f"repro_torch.configs.{dataset}")
    return mod.CONFIG
