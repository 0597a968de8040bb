"""Decoder-only transformer backbone in PyTorch: dense (qwen, deepseek), MoE
(granite, llama4-scout) and VLM (llama-3.2-vision, cross-attention every
``cross_period``-th layer) families.

Layer params are stacked along a leading layer axis, as in the JAX package;
``apply_stack`` loops over it.  For the VLM family the unit of the stack is
a group of ``cross_period`` layers: ``cross_period - 1`` self-attention
layers (``groups/selfs``, two leading axes) and one cross-attention layer
(``groups/cross``) with its two tanh gates, which attends the projected
vision embeddings.  Decode caches are stacked along the same axes; the
VLM's cross K/V are computed once, in ``init_decode_state``, and kept in
``DecodeState.vision_kv``.

Tensor parallelism: ``forward`` and ``train_loss`` take the params of each
``"model"`` shard as a ``parallel.tensor.Shards`` (``sharding.shard_params``'
pieces) and run the JAX package's model code on it, with ``constrain`` at
the JAX package's call sites deciding each boundary's collective under
``activation_rules(False, sp=run.sp)`` (or the rules a caller installed).
The VLM's cross layers run on each shard's heads over the vision
embeddings, which every shard projects with its copy of ``vision_proj``;
the replicated tanh gates scale the reduced outputs.  The logits stay
vocab-split into the loss; ``forward`` gathers them.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import common
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (apply_stack, compute_dtype, embed,
                                       layer, lecun_init, randn, remat,
                                       rmsnorm, rmsnorm_init, swiglu,
                                       swiglu_init, tp_rules)
from repro_torch.models.registry import check_tensor_parallel
from repro_torch.parallel import tensor as tp
from repro_torch.parallel.sharding import constrain
from repro_torch.parallel.tensor import shardwise

Tensor = torch.Tensor

FAMILIES = ("dense", "moe", "vlm")


def _check_decode(cfg: ModelConfig, params) -> None:
    _check_family(cfg)
    common.refuse_sharded_decode(cfg, params)


def _check_family(cfg: ModelConfig, params=None) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"{cfg.arch}: the {cfg.family} family is "
                                  f"not a transformer family of the port "
                                  f"(ROADMAP.md)")
    if isinstance(params, tp.Shards):
        check_tensor_parallel(cfg, len(params.pieces))


# ---------------------------------------------------------------------------
# layer bodies
# ---------------------------------------------------------------------------

def _layer_init(gen: torch.Generator, cfg: ModelConfig, run: RunConfig,
                device, lead) -> dict:
    hq, hkv = cfg.padded_heads(run.tp)
    p = {"ln1": rmsnorm_init(cfg.d_model, device, lead),
         "ln2": rmsnorm_init(cfg.d_model, device, lead),
         "attn": attn_mod.attn_init(gen, cfg.d_model, hq, hkv,
                                    cfg.resolved_head_dim, device,
                                    qkv_bias=cfg.qkv_bias,
                                    qk_norm=cfg.qk_norm, lead=lead)}
    if cfg.family == "moe":
        p["moe"] = moe_mod.moe_init(gen, cfg.d_model, cfg.d_ff,
                                    cfg.n_experts, device,
                                    shared_expert=cfg.shared_expert,
                                    lead=lead)
    else:
        p["mlp"] = swiglu_init(gen, cfg.d_model, cfg.d_ff, device, lead)
    return p


def _cross_layer_init(gen: torch.Generator, cfg: ModelConfig, run: RunConfig,
                      device, lead) -> dict:
    p = _layer_init(gen, cfg, run, device, lead)
    p["gate_attn"] = torch.zeros(lead, device=device)   # llama-3.2 tanh gates
    p["gate_mlp"] = torch.zeros(lead, device=device)
    return p


def _apply_ffn(p: dict, cfg: ModelConfig, run: RunConfig, h: Tensor) -> Tensor:
    if cfg.family == "moe":
        return moe_mod.moe_apply(p["moe"], h, top_k=cfg.top_k,
                                 capacity_factor=cfg.capacity_factor,
                                 dispatch_groups=run.moe_dispatch_groups)
    return swiglu(p["mlp"], h)


def _self_layer(p: dict, cfg: ModelConfig, run: RunConfig, x: Tensor,
                positions: Tensor) -> Tensor:
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    a = attn_mod.full_attention(p["attn"], tp.whole(h), positions=positions,
                                theta=cfg.rope_theta, causal=True)
    x = x + constrain(a, "act_btd")
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + constrain(_apply_ffn(p, cfg, run, tp.whole(h)), "act_btd")


@shardwise()
def _tanh_gate(gate: Tensor, a: Tensor) -> Tensor:
    return torch.tanh(gate).to(a.dtype) * a


def _cross_layer(p: dict, cfg: ModelConfig, run: RunConfig, x: Tensor,
                 vision: Tensor, positions: Tensor) -> Tensor:
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    # no rope on cross-attention: the positions are not read
    a = attn_mod.full_attention(p["attn"], tp.whole(h),
                                positions=torch.zeros_like(positions),
                                theta=cfg.rope_theta, x_kv=vision)
    x = x + _tanh_gate(p["gate_attn"], constrain(a, "act_btd"))
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + _tanh_gate(p["gate_mlp"], constrain(
        _apply_ffn(p, cfg, run, tp.whole(h)), "act_btd"))


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, run: RunConfig, generator: torch.Generator,
                device) -> dict:
    """Seeded random params with the JAX init's shapes and scales (not its
    numbers), drawn on the generator's device and moved to ``device``; the
    VLM's tanh gates start at 0, as in the JAX package."""
    _check_family(cfg)
    vocab = cfg.padded_vocab(run.tp)
    params = {"embed": {"w": randn(generator, (vocab, cfg.d_model), device)
                        * 0.02},
              "final_norm": rmsnorm_init(cfg.d_model, device)}
    if not cfg.tie_embeddings:
        params["unembed"] = {"w": lecun_init(generator, (cfg.d_model, vocab),
                                             device)}
    if cfg.family == "vlm":
        n_groups = cfg.n_layers // cfg.cross_period
        params["groups"] = {
            "selfs": _layer_init(generator, cfg, run, device,
                                 (n_groups, cfg.cross_period - 1)),
            "cross": _cross_layer_init(generator, cfg, run, device,
                                       (n_groups,))}
        params["vision_proj"] = {"w": lecun_init(
            generator, (cfg.d_model, cfg.d_model), device)}
    else:
        params["layers"] = _layer_init(generator, cfg, run, device,
                                       (cfg.n_layers,))
    return params


def cast_params(params: dict, dtype) -> dict:
    """``params`` with every floating tensor leaf cast to ``dtype`` (a torch
    dtype or its name); integer and non-tensor leaves as they are, as the
    JAX package's ``cast_params``.  Any family's tree."""
    return _cast(params, getattr(torch, dtype) if isinstance(dtype, str)
                 else dtype)


def _cast(node, dtype):
    if isinstance(node, dict):
        return {k: _cast(v, dtype) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_cast(v, dtype) for v in node)
    if isinstance(node, Tensor) and node.is_floating_point():
        return node.to(dtype)
    return node


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _vision(params: dict, run: RunConfig, vision_embeds: Optional[Tensor]
            ) -> Tensor:
    """The vision embeddings (B, N_vision, D) projected into the decoder
    (by each shard with its copy of the replicated ``vision_proj``)."""
    if vision_embeds is None:
        raise ValueError("the vlm family needs vision_embeds (B, "
                         "n_vision_tokens, d_model): the frontend's patch "
                         "embeddings")
    dt = compute_dtype(run)
    return tp.each(lambda v, w: v.to(dt) @ w.to(dt), vision_embeds,
                   params["vision_proj"]["w"], layout=tp.REPLICATED)


def forward(params: dict, cfg: ModelConfig, run: RunConfig, tokens: Tensor,
            vision_embeds: Optional[Tensor] = None,
            return_hidden: bool = False) -> Tensor:
    """tokens (B, S) -> logits (B, S, padded_vocab), or with
    ``return_hidden`` the final normed hidden states (B, S, d_model); the
    VLM family also takes ``vision_embeds`` (B, N_vision, d_model).  From
    params as ``Shards`` the result is gathered onto the first shard's
    device (one all-gather)."""
    return tp.gather(_forward(params, cfg, run, tokens, vision_embeds,
                              return_hidden))


def _forward(params: dict, cfg: ModelConfig, run: RunConfig, tokens: Tensor,
             vision_embeds: Optional[Tensor] = None,
             return_hidden: bool = False) -> Tensor:
    """``forward`` without the gather: under tensor parallelism the logits
    split over the vocab (the hidden states as ``act_btd`` places
    them)."""
    _check_family(cfg, params)
    with tp_rules(params, run):
        b, s = tokens.shape
        x = embed(params["embed"], tokens).to(compute_dtype(run))
        x = constrain(x, "act_btd")
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device)[None].expand(b, s)
        # remat: each self-attention layer, not the VLM's cross layer (as JAX)
        self_body = remat(
            lambda h, lp: _self_layer(lp, cfg, run, h, positions), run)
        if cfg.family == "vlm":
            vision = _vision(params, run, vision_embeds)

            def group_body(h, gp):
                h = apply_stack(self_body, h, gp["selfs"])
                return _cross_layer(gp["cross"], cfg, run, h, vision,
                                    positions)
            x = apply_stack(group_body, x, params["groups"])
        else:
            x = apply_stack(self_body, x, params["layers"])
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        if return_hidden:
            return constrain(x, "act_btd")
        return constrain(_lm_head(params, cfg, run, x), "logits")


def _head_w(params: dict, cfg: ModelConfig):
    """The LM head's (D, V_padded) weight: the tied embedding's transpose
    or ``unembed/w`` (each shard's piece under tensor parallelism)."""
    return (params["embed"]["w"].T if cfg.tie_embeddings
            else params["unembed"]["w"])


def _lm_head(params: dict, cfg: ModelConfig, run: RunConfig, x: Tensor) -> Tensor:
    # physical vocab padding: dead columns masked to -inf
    return common.lm_head(x, _head_w(params, cfg), cfg.vocab,
                          cfg.padded_vocab(run.tp))


def train_loss(params: dict, cfg: ModelConfig, run: RunConfig,
               batch: dict) -> Tensor:
    """Mean next-token CE of ``batch`` (with ``vision_embeds`` for the VLM
    family); chunked with ``run.ce_chunk``.  Under tensor parallelism the
    CE is vocab-parallel (no shard holds a whole row of logits), under the
    activation rules of ``forward``."""
    with tp_rules(params, run):
        return common.train_loss(_forward, params, cfg, run, batch,
                                 _head_w(params, cfg))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    caches: Any       # KVCache stacked over the layer axis; the VLM's
    #                   {"selfs": KVCache stacked over (group, layer)}
    vision_kv: Any    # VLM only: (k, v), each (n_groups, B, N_vision, KV, hd)
    pos: int


def init_decode_state(params: dict, cfg: ModelConfig, run: RunConfig,
                      batch: int, max_len: int,
                      vision_embeds: Optional[Tensor] = None) -> DecodeState:
    """Zero caches; for the VLM family also each group's cross K/V of the
    projected ``vision_embeds``, computed once here."""
    _check_decode(cfg, params)
    _, hkv = cfg.padded_heads(run.tp)
    device = params["embed"]["w"].device
    dt = compute_dtype(run)
    hd = cfg.resolved_head_dim
    if cfg.family == "vlm":
        n_groups = cfg.n_layers // cfg.cross_period
        caches = {"selfs": attn_mod.KVCache.zeros(
            batch, max_len, hkv, hd, dt, device,
            lead=(n_groups, cfg.cross_period - 1))}
        vision = _vision(params, run, vision_embeds)
        zeros = torch.zeros(vision.shape[:2], dtype=torch.int32,
                            device=device)
        kvs = [attn_mod._project_qkv(layer(params["groups"]["cross"]["attn"],
                                           g), vision, vision, zeros,
                                     cfg.rope_theta, rope=False)[1:]
               for g in range(n_groups)]
        vision_kv = (torch.stack([k for k, _ in kvs]),
                     torch.stack([v for _, v in kvs]))
        return DecodeState(caches=caches, vision_kv=vision_kv, pos=0)
    caches = attn_mod.KVCache.zeros(batch, max_len, hkv, hd, dt, device,
                                    lead=(cfg.n_layers,))
    return DecodeState(caches=caches, vision_kv=None, pos=0)


def decode_step(params: dict, cfg: ModelConfig, run: RunConfig, token: Tensor,
                state: DecodeState) -> tuple[Tensor, DecodeState]:
    """token (B, 1) int -> (logits (B, 1, V), new state).  The caches are
    updated in place; the returned state shares their tensors."""
    _check_decode(cfg, params)
    x = embed(params["embed"], token).to(compute_dtype(run))
    caches = state.caches["selfs"] if cfg.family == "vlm" else state.caches

    def self_decode(h, sl):
        lp = sl["p"]
        z = rmsnorm(lp["ln1"], h, cfg.norm_eps)
        cache = attn_mod.KVCache(k=sl["k"], v=sl["v"], pos=caches.pos,
                                 window=caches.window)
        a, _ = attn_mod.decode_attention(lp["attn"], z, cache,
                                         theta=cfg.rope_theta)
        h = h + a
        z = rmsnorm(lp["ln2"], h, cfg.norm_eps)
        return h + _apply_ffn(lp, cfg, run, z)

    if cfg.family == "vlm":
        def group_body(h, gl):
            h = apply_stack(self_decode, h, {"p": gl["p"]["selfs"],
                                             "k": gl["k"], "v": gl["v"]})
            # the cross layer: attends the vision K/V, no cache
            p = gl["p"]["cross"]
            z = rmsnorm(p["ln1"], h, cfg.norm_eps)
            a, _ = attn_mod.decode_attention(
                p["attn"], z, _dummy_cache(h, cfg, run), theta=cfg.rope_theta,
                kv_cross=(gl["vk"], gl["vv"]))
            h = h + torch.tanh(p["gate_attn"]).to(h.dtype) * a
            z = rmsnorm(p["ln2"], h, cfg.norm_eps)
            return h + torch.tanh(p["gate_mlp"]).to(h.dtype) * \
                _apply_ffn(p, cfg, run, z)

        vk, vv = state.vision_kv
        x = apply_stack(group_body, x, {"p": params["groups"], "k": caches.k,
                                        "v": caches.v, "vk": vk, "vv": vv})
    else:
        x = apply_stack(self_decode, x, {"p": params["layers"],
                                         "k": caches.k, "v": caches.v})
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _lm_head(params, cfg, run, x)
    new = attn_mod.KVCache(k=caches.k, v=caches.v, pos=caches.pos + 1,
                           window=caches.window)
    if cfg.family == "vlm":
        new = {"selfs": new}
    return logits, DecodeState(caches=new, vision_kv=state.vision_kv,
                               pos=state.pos + 1)


def _dummy_cache(x: Tensor, cfg: ModelConfig,
                 run: RunConfig) -> attn_mod.KVCache:
    """The one-slot cache a cross layer's ``decode_attention`` is handed and
    returns untouched."""
    _, hkv = cfg.padded_heads(run.tp)
    return attn_mod.KVCache.zeros(x.shape[0], 1, hkv, cfg.resolved_head_dim,
                                  x.dtype, x.device)
