"""Arch family -> model functions, tiny configs for CPU tests, and weights
carried across from the JAX package.

The port has the dense (qwen) and SSM (mamba2) families; the others wait for
later slices (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.exec import resolve_device


@dataclasses.dataclass(frozen=True)
class ModelApi:
    init_params: Callable        # (cfg, run, generator, device) -> params
    forward: Callable            # (params, cfg, run, tokens) -> logits
    init_decode_state: Callable  # (params, cfg, run, batch, max_len) -> state
    decode_step: Callable        # (params, cfg, run, token, state) -> (logits, state)


def get_model(cfg: ModelConfig) -> ModelApi:
    if cfg.family == "dense":
        from repro_torch.models import transformer as m
    elif cfg.family == "ssm":
        from repro_torch.models import ssd as m
    else:
        raise NotImplementedError(f"{cfg.arch}: the {cfg.family} family is "
                                  f"not ported yet (ROADMAP.md)")
    return ModelApi(init_params=m.init_params, forward=m.forward,
                    init_decode_state=m.init_decode_state,
                    decode_step=m.decode_step)


def init_params(cfg: ModelConfig, run: RunConfig, generator: torch.Generator,
                device=None) -> dict:
    """Seeded random params of ``cfg`` on ``device`` (the card by default),
    with the JAX init's shapes and scales; ``generator`` may live on the
    card, so that full-width weights are drawn there."""
    return get_model(cfg).init_params(cfg, run, generator,
                                      resolve_device(device))


def params_from_jax(tree: Any, device=None) -> dict:
    """The JAX package's param tree (numpy leaves, as ``jax.device_get``
    returns them, stacked-layer axis kept) as tensors on ``device`` with the
    same paths."""
    device = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node)).to(device)
    return convert(tree)


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU tests, as the JAX package's."""
    changes: dict[str, Any] = dict(
        n_layers=max(2, min(4, cfg.n_layers)),
        d_model=64, n_heads=4, n_kv_heads=min(max(1, cfg.n_kv_heads // 4), 4),
        d_ff=128 if cfg.d_ff else 0, vocab=512, head_dim=16, max_seq=512)
    if cfg.family == "ssm":
        changes.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16,
                       n_heads=1, n_kv_heads=1)
    return dataclasses.replace(cfg, **changes)
