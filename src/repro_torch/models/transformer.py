"""Decoder-only transformer backbone, dense family (qwen), in PyTorch.

Layer params are stacked along a leading layer axis, as in the JAX package;
``apply_stack`` loops over it.  Decode caches are stacked along the same
axis.  The MoE and VLM families wait for later slices (ROADMAP.md).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import (apply_stack, compute_dtype, embed,
                                       lecun_init, randn, rmsnorm,
                                       rmsnorm_init, swiglu, swiglu_init,
                                       unembed)

Tensor = torch.Tensor


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.arch}: the {cfg.family} family is "
                                  f"not ported yet (ROADMAP.md)")


# ---------------------------------------------------------------------------
# layer body
# ---------------------------------------------------------------------------

def _self_layer(p: dict, cfg: ModelConfig, x: Tensor,
                positions: Tensor) -> Tensor:
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + attn_mod.full_attention(p["attn"], h, positions=positions,
                                    theta=cfg.rope_theta, causal=True)
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + swiglu(p["mlp"], h)


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, run: RunConfig, generator: torch.Generator,
                device) -> dict:
    """Seeded random params with the JAX init's shapes and scales (not its
    numbers), drawn on the generator's device and moved to ``device``."""
    _check_family(cfg)
    hq, hkv = cfg.padded_heads(run.tp)
    vocab = cfg.padded_vocab(run.tp)
    lead = (cfg.n_layers,)
    params = {"embed": {"w": randn(generator, (vocab, cfg.d_model), device)
                        * 0.02},
              "final_norm": rmsnorm_init(cfg.d_model, device)}
    if not cfg.tie_embeddings:
        params["unembed"] = {"w": lecun_init(generator, (cfg.d_model, vocab),
                                             device)}
    params["layers"] = {
        "ln1": rmsnorm_init(cfg.d_model, device, lead),
        "ln2": rmsnorm_init(cfg.d_model, device, lead),
        "attn": attn_mod.attn_init(generator, cfg.d_model, hq, hkv,
                                   cfg.resolved_head_dim, device,
                                   qkv_bias=cfg.qkv_bias,
                                   qk_norm=cfg.qk_norm, lead=lead),
        "mlp": swiglu_init(generator, cfg.d_model, cfg.d_ff, device, lead)}
    return params


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def forward(params: dict, cfg: ModelConfig, run: RunConfig,
            tokens: Tensor) -> Tensor:
    """tokens (B, S) -> logits (B, S, padded_vocab)."""
    _check_family(cfg)
    b, s = tokens.shape
    x = embed(params["embed"], tokens).to(compute_dtype(run))
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    x = apply_stack(lambda h, lp: _self_layer(lp, cfg, h, positions), x,
                    params["layers"])
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _lm_head(params, cfg, run, x)


def _lm_head(params: dict, cfg: ModelConfig, run: RunConfig, x: Tensor) -> Tensor:
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["w"].to(x.dtype).T
    else:
        logits = unembed(params["unembed"], x)
    pv = cfg.padded_vocab(run.tp)
    if pv != cfg.vocab:
        # physical vocab padding: dead columns masked to -inf
        mask = torch.where(torch.arange(pv, device=x.device) < cfg.vocab,
                           0.0, -1e30)
        logits = logits + mask.to(logits.dtype)
    return logits


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    caches: attn_mod.KVCache      # stacked over the leading layer axis
    pos: int


def init_decode_state(params: dict, cfg: ModelConfig, run: RunConfig,
                      batch: int, max_len: int) -> DecodeState:
    _check_family(cfg)
    _, hkv = cfg.padded_heads(run.tp)
    device = params["embed"]["w"].device
    caches = attn_mod.KVCache.zeros(batch, max_len, hkv, cfg.resolved_head_dim,
                                    compute_dtype(run), device,
                                    lead=(cfg.n_layers,))
    return DecodeState(caches=caches, pos=0)


def decode_step(params: dict, cfg: ModelConfig, run: RunConfig, token: Tensor,
                state: DecodeState) -> tuple[Tensor, DecodeState]:
    """token (B, 1) int -> (logits (B, 1, V), new state).  The caches are
    updated in place; the returned state shares their tensors."""
    _check_family(cfg)
    x = embed(params["embed"], token).to(compute_dtype(run))
    caches = state.caches

    def body(h, sl):
        lp = sl["p"]
        z = rmsnorm(lp["ln1"], h, cfg.norm_eps)
        cache = attn_mod.KVCache(k=sl["k"], v=sl["v"], pos=caches.pos,
                                 window=caches.window)
        a, _ = attn_mod.decode_attention(lp["attn"], z, cache,
                                         theta=cfg.rope_theta)
        h = h + a
        z = rmsnorm(lp["ln2"], h, cfg.norm_eps)
        return h + swiglu(lp["mlp"], z)

    x = apply_stack(body, x, {"p": params["layers"], "k": caches.k,
                              "v": caches.v})
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _lm_head(params, cfg, run, x)
    new = attn_mod.KVCache(k=caches.k, v=caches.v, pos=caches.pos + 1,
                           window=caches.window)
    return logits, DecodeState(caches=new, pos=state.pos + 1)
