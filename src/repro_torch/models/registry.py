"""Arch family -> model functions, tiny configs for CPU tests, and weights
carried across from the JAX package.

The port has every family of the JAX package: dense (qwen, deepseek), MoE
(granite, llama4-scout), VLM (llama-3.2-vision), SSM (mamba2), hybrid
(recurrentgemma) and audio (whisper, an encoder-decoder).
``params_from_jax`` and ``train_state_from_jax`` carry the JAX package's
params and training state across as numpy, every nested tree (whisper's
``enc_layers`` and ``dec_layers`` too) with its paths and stacked axes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import bf16
from repro_torch.core.exec import resolve_device


@dataclasses.dataclass(frozen=True)
class ModelApi:
    init_params: Callable        # (cfg, run, generator, device) -> params
    forward: Callable            # (params, cfg, run, tokens, ...) -> logits
    train_loss: Callable         # (params, cfg, run, batch) -> scalar
    init_decode_state: Callable  # (params, cfg, run, batch, max_len, ...) -> state
    decode_step: Callable        # (params, cfg, run, token, state) -> (logits, state)


def get_model(cfg: ModelConfig) -> ModelApi:
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models import transformer as m
    elif cfg.family == "ssm":
        from repro_torch.models import ssd as m
    elif cfg.family == "hybrid":
        from repro_torch.models import rglru as m
    elif cfg.family == "audio":
        from repro_torch.models import whisper as m
    else:
        raise NotImplementedError(f"{cfg.arch}: no model family "
                                  f"{cfg.family!r}")
    return ModelApi(init_params=m.init_params, forward=m.forward,
                    train_loss=m.train_loss,
                    init_decode_state=m.init_decode_state,
                    decode_step=m.decode_step)


# the families whose params compute split over a "model" axis
TENSOR_PARALLEL_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")


def check_tensor_parallel(cfg: ModelConfig, tp: int) -> None:
    """Raise ``NotImplementedError`` for a model axis of ``tp`` > 1 where
    the family's tensor parallelism is not ported."""
    if tp > 1 and cfg.family not in TENSOR_PARALLEL_FAMILIES:
        raise NotImplementedError(
            f"{cfg.arch}: tensor parallelism of the {cfg.family} family "
            f"waits for its slice (ROADMAP.md §1)")


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
    same paths; a bare array comes back as one tensor.  A bf16 leaf
    (ml_dtypes' ``bfloat16``, which torch cannot read) comes across bit for
    bit through its uint16 view."""
    device = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        arr = np.array(node)
        if bf16.is_bf16(arr):
            return bf16.from_bits(arr).to(device)
        return torch.from_numpy(arr).to(device)
    return convert(tree)


def train_state_from_jax(state: Any, device=None):
    """The JAX package's ``TrainState`` (numpy leaves, as ``jax.device_get``
    returns it) as the port's ``train.loop.TrainState`` on ``device``: the
    params, Adam's ``step``/``mu``/``nu``, the ``pca_ef`` basis and error
    buffers, and the step.  Read by field name, so nothing of the JAX
    package is imported."""
    from repro_torch.runtime.grad_compress import GradCompressionState
    from repro_torch.train.loop import TrainState
    from repro_torch.train.optim import AdamState

    device = resolve_device(device)

    def conv(tree):
        return params_from_jax(tree, device)

    gc = None
    if state.gc is not None:
        gc = GradCompressionState(basis=conv(state.gc.basis),
                                  error=conv(state.gc.error),
                                  step=conv(state.gc.step))
    return TrainState(params=conv(state.params),
                      opt=AdamState(step=conv(state.opt.step),
                                    mu=conv(state.opt.mu),
                                    nu=conv(state.opt.nu)),
                      gc=gc, step=conv(state.step))


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU tests, as the JAX package's."""
    changes: dict[str, Any] = dict(
        n_layers=max(2, min(4, cfg.n_layers)),
        d_model=64, n_heads=4, n_kv_heads=min(max(1, cfg.n_kv_heads // 4), 4),
        d_ff=128 if cfg.d_ff else 0, vocab=512, head_dim=16, max_seq=512)
    if cfg.family == "moe":
        changes.update(n_experts=4, top_k=min(cfg.top_k, 2), d_ff=64)
    if cfg.family == "hybrid":
        changes.update(n_layers=5, attn_period=3, window=16, lru_width=64)
    if cfg.family == "ssm":
        changes.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16,
                       n_heads=1, n_kv_heads=1)
    if cfg.family == "audio":
        changes.update(n_enc_layers=2, n_frames=24)
    if cfg.family == "vlm":
        changes.update(cross_period=5, n_layers=5, n_vision_tokens=16)
    return dataclasses.replace(cfg, **changes)
