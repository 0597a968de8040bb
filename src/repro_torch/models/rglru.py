"""Griffin / RecurrentGemma hybrid: RG-LRU recurrent blocks + local
attention, in PyTorch.

Layer pattern is (recurrent, recurrent, local-attention) triples (Griffin's
2:1); 38 layers = 12 stacked triples + 2 stacked tail recurrent layers.

RG-LRU (De et al. 2024):  r,i = sigma(W x + b);  a = exp(-c softplus(L) r)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
Prefill runs the diagonal recurrence as a log-depth scan (``linear_scan``),
where the JAX package calls ``jax.lax.associative_scan``: neither is a
kernel, and ceil(log2 S) elementwise passes over (B, S, W) take the place of
S sequential steps.  The local attention goes through the flash-attention
wrapper with ``window=cfg.window`` (the kernel on CUDA, its plain version on
the CPU).  Decode is a single elementwise state update per layer (the state
is O(1)), updated in place; the attention layers' KV cache is a
``window``-sized ring buffer.  The coefficients of the recurrence and its
state ``h`` stay float32 whatever the compute dtype, as in the JAX package.

Tensor parallelism splits the LRU width W (``w_x``, ``w_gate_branch``,
``conv/w``, the gates' columns and biases; ``lru_out`` by row), the MLP and
the attention heads.  ``lru/alpha`` and ``conv/b`` are replicated (JAX's
spec, cut to their one dim, names no axis), so each shard takes its
channels of them.  Each gate is a (W, W) matmul split by column, so every
shard needs the whole conv output: one all-gather of it a block, in the
compute dtype, shared by both gates.  The scan is per channel.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import common
from repro_torch.models.common import (apply_stack, compute_dtype, embed,
                                       gelu, lecun_init, randn, remat,
                                       rmsnorm, rmsnorm_init, swiglu_init,
                                       tp_rules, uniform)
from repro_torch.parallel import tensor as tp
from repro_torch.parallel.sharding import constrain
from repro_torch.parallel.tensor import shardwise

Tensor = torch.Tensor
_C = 8.0  # RG-LRU decay sharpness constant


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

# GeGLU's weights have SwiGLU's paths, shapes and scales; only the gate's
# activation differs
_geglu_init = swiglu_init


@shardwise(tp.PARTIAL)
def _geglu(p: dict, x: Tensor) -> Tensor:
    dt = x.dtype
    return (gelu(x @ p["w_gate"].to(dt)) * (x @ p["w_in"].to(dt))
            ) @ p["w_out"].to(dt)


def _rec_block_init(gen: torch.Generator, cfg: ModelConfig, device,
                    lead=()) -> dict:
    d, w = cfg.d_model, cfg.lru_width
    return {
        "ln1": rmsnorm_init(d, device, lead), "ln2": rmsnorm_init(d, device, lead),
        "w_x": lecun_init(gen, (*lead, d, w), device),
        "w_gate_branch": lecun_init(gen, (*lead, d, w), device),
        "conv": {"w": lecun_init(gen, (*lead, cfg.conv_width, w), device,
                                 fan_in=cfg.conv_width),
                 "b": torch.zeros(*lead, w, device=device)},
        "lru": {
            "alpha": uniform(gen, (*lead, w), 0.7, 0.95, device),
            "in_gate": {"w": lecun_init(gen, (*lead, w, w), device),
                        "b": torch.zeros(*lead, w, device=device)},
            "rec_gate": {"w": lecun_init(gen, (*lead, w, w), device),
                         "b": torch.zeros(*lead, w, device=device)},
        },
        "lru_out": lecun_init(gen, (*lead, w, d), device, fan_in=w),
        "mlp": _geglu_init(gen, d, cfg.d_ff, device, lead),
    }


def _attn_block_init(gen: torch.Generator, cfg: ModelConfig, run: RunConfig,
                     device, lead=()) -> dict:
    hq, hkv = cfg.padded_heads(run.tp)
    return {"ln1": rmsnorm_init(cfg.d_model, device, lead),
            "ln2": rmsnorm_init(cfg.d_model, device, lead),
            "attn": attn_mod.attn_init(gen, cfg.d_model, hq, hkv,
                                       cfg.resolved_head_dim, device,
                                       lead=lead),
            "mlp": _geglu_init(gen, cfg.d_model, cfg.d_ff, device, lead)}


def _own(v: Tensor, s: int, width: int) -> Tensor:
    """Shard ``s``'s ``width`` channels of a replicated (..., W) leaf (all
    of it on one device)."""
    return v[..., s * width:(s + 1) * width]


def _causal_conv(p: dict, x: Tensor, s: int = 0) -> Tensor:
    """Depthwise causal temporal conv, width cw. x: (B,S,W), shard ``s``'s
    channels of the replicated bias."""
    cw = p["w"].shape[0]
    dt = x.dtype
    pad = F.pad(x, (0, 0, cw - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * p["w"][i].to(dt)
              for i in range(cw))
    return out + _own(p["b"], s, x.shape[-1]).to(dt)


def _lru_coeffs(p: dict, xc: Tensor, xc_all: Optional[Tensor] = None,
                s: int = 0) -> tuple[Tensor, Tensor]:
    """a_t and b_t of the diagonal recurrence h_t = a_t h_{t-1} + b_t, in
    float32, for shard ``s``'s channels ``xc`` of the conv output (the
    gates read all of it, ``xc_all``; by default ``xc``)."""
    x32 = xc.to(torch.float32)
    g32 = x32 if xc_all is None else xc_all.to(torch.float32)
    # bf16 gate weights go up to float32, as JAX's promotion takes them
    r = torch.sigmoid(g32 @ p["rec_gate"]["w"].to(torch.float32)
                      + p["rec_gate"]["b"])
    i = torch.sigmoid(g32 @ p["in_gate"]["w"].to(torch.float32)
                      + p["in_gate"]["b"])
    log_a = -_C * F.softplus(_own(p["alpha"], s, xc.shape[-1])) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) \
        * (i * x32)
    return a, b


def linear_scan(a: Tensor, b: Tensor, dim: int = 1) -> tuple[Tensor, Tensor]:
    """Inclusive scan of the steps (a_t, b_t) along ``dim`` under
    (a1, b1) then (a2, b2) = (a1 a2, a2 b1 + b2): the cumulative decays and
    the states h_t = a_t h_{t-1} + b_t from h_{-1} = 0.  The same function
    as ``jax.lax.associative_scan`` with that combine, in ceil(log2 S)
    doubling passes (after the pass of offset d, element t composes steps
    t - 2d + 1 .. t); the products are taken in another order."""
    s = a.shape[dim]
    d = 1
    while d < s:
        a_cur, b_cur = a.narrow(dim, d, s - d), b.narrow(dim, d, s - d)
        b = torch.cat([b.narrow(dim, 0, d),
                       a_cur * b.narrow(dim, 0, s - d) + b_cur], dim)
        a = torch.cat([a.narrow(dim, 0, d),
                       a_cur * a.narrow(dim, 0, s - d)], dim)
        d *= 2
    return a, b


def _rec_block(p: dict, cfg: ModelConfig, x: Tensor) -> Tensor:
    h = tp.whole(rmsnorm(p["ln1"], x, cfg.norm_eps))
    xc = tp.each(_rec_conv, p, h, layout=h.ndim - 1, indexed=True)
    y = tp.each(_rec_mix, p, h, xc, tp.whole(xc), layout=tp.PARTIAL,
                indexed=True)
    x = x + constrain(y, "act_btd")
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + constrain(_geglu(p["mlp"], tp.whole(h)), "act_btd")


def _rec_conv(s: int, p: dict, h: Tensor) -> Tensor:
    """Shard ``s``'s channels of the causal conv of ``h @ w_x``."""
    return _causal_conv(p["conv"], h @ p["w_x"].to(h.dtype), s)


def _rec_mix(s: int, p: dict, h: Tensor, xc: Tensor,
             xc_all: Tensor) -> Tensor:
    """Shard ``s``'s channels of the recurrence, gated, through its rows
    of ``lru_out``."""
    dt = h.dtype
    gate = gelu(h @ p["w_gate_branch"].to(dt))
    a, b = _lru_coeffs(p["lru"], xc, xc_all, s)
    _, hseq = linear_scan(a, b)
    return (gate * hseq.to(dt)) @ p["lru_out"].to(dt)


def _attn_block(p: dict, cfg: ModelConfig, x: Tensor,
                positions: Tensor) -> Tensor:
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    a = attn_mod.full_attention(p["attn"], tp.whole(h), positions=positions,
                                theta=cfg.rope_theta, causal=True,
                                window=cfg.window)
    x = x + constrain(a, "act_btd")
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + constrain(_geglu(p["mlp"], tp.whole(h)), "act_btd")


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def _n_triples_tail(cfg: ModelConfig) -> tuple[int, int]:
    period = cfg.attn_period  # 3: (rec, rec, attn)
    return cfg.n_layers // period, cfg.n_layers % period


def init_params(cfg: ModelConfig, run: RunConfig, generator: torch.Generator,
                device) -> dict:
    """Seeded random params with the JAX init's paths, shapes and scales
    (not its numbers), drawn on the generator's device and moved to
    ``device``; the triples and the tail stacked on a leading axis."""
    n_triples, n_tail = _n_triples_tail(cfg)
    vocab = cfg.padded_vocab(run.tp)
    g = generator
    params = {"embed": {"w": randn(g, (vocab, cfg.d_model), device) * 0.02},
              "final_norm": rmsnorm_init(cfg.d_model, device),
              "unembed": {"w": lecun_init(g, (cfg.d_model, vocab), device)}}
    lead = (n_triples,)
    params["triples"] = {
        "rec1": _rec_block_init(g, cfg, device, lead),
        "rec2": _rec_block_init(g, cfg, device, lead),
        "attn_layer": _attn_block_init(g, cfg, run, device, lead)}
    if n_tail:
        params["tail"] = _rec_block_init(g, cfg, device, (n_tail,))
    return params


def _logits(params: dict, cfg: ModelConfig, run: RunConfig, x: Tensor) -> Tensor:
    return common.lm_head(x, params["unembed"]["w"], cfg.vocab,
                          cfg.padded_vocab(run.tp))


def forward(params: dict, cfg: ModelConfig, run: RunConfig, tokens: Tensor,
            return_hidden: bool = False) -> Tensor:
    """tokens (B, S) -> logits (B, S, padded_vocab), or with
    ``return_hidden`` the final normed hidden states (B, S, d_model).  From
    params as ``Shards`` the result is gathered onto the first shard's
    device."""
    return tp.gather(_forward(params, cfg, run, tokens, return_hidden))


def _forward(params: dict, cfg: ModelConfig, run: RunConfig, tokens: Tensor,
             return_hidden: bool = False) -> Tensor:
    """``forward`` without the gather: under tensor parallelism the logits
    split over the vocab."""
    with tp_rules(params, run):
        b, s = tokens.shape
        x = embed(params["embed"], tokens).to(compute_dtype(run))
        x = constrain(x, "act_btd")
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device)[None].expand(b, s)

        def body(h, tl):
            h = _rec_block(tl["rec1"], cfg, h)
            h = _rec_block(tl["rec2"], cfg, h)
            return _attn_block(tl["attn_layer"], cfg, h, positions)

        # remat wraps each triple, not the tail, as in the JAX package
        x = apply_stack(remat(body, run), x, params["triples"])
        if _n_triples_tail(cfg)[1]:
            x = apply_stack(lambda h, tl: _rec_block(tl, cfg, h), x,
                            params["tail"])
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        if return_hidden:
            return constrain(x, "act_btd")
        return constrain(_logits(params, cfg, run, x), "logits")


def train_loss(params: dict, cfg: ModelConfig, run: RunConfig,
               batch: dict) -> Tensor:
    """Mean next-token CE of ``batch``; chunked with ``run.ce_chunk``;
    vocab-parallel under tensor parallelism."""
    with tp_rules(params, run):
        return common.train_loss(_forward, params, cfg, run, batch,
                                 params["unembed"]["w"])


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

class RecState(NamedTuple):
    conv_buf: Tensor   # (..., B, conv_width-1, lru_width) last inputs
    h: Tensor          # (..., B, lru_width) fp32


class DecodeState(NamedTuple):
    triples: dict      # {"rec1", "rec2": RecState, "attn": KVCache}, stacked
    tail: Optional[RecState]   # stacked over the tail layers
    pos: int


def _zero_rec_state(cfg: ModelConfig, batch: int, dt, device,
                    lead=()) -> RecState:
    return RecState(
        conv_buf=torch.zeros(*lead, batch, cfg.conv_width - 1, cfg.lru_width,
                             dtype=dt, device=device),
        h=torch.zeros(*lead, batch, cfg.lru_width, dtype=torch.float32,
                      device=device))


def init_decode_state(params: dict, cfg: ModelConfig, run: RunConfig,
                      batch: int, max_len: int) -> DecodeState:
    common.refuse_sharded_decode(cfg, params)
    n_triples, n_tail = _n_triples_tail(cfg)
    dt = compute_dtype(run)
    device = params["embed"]["w"].device
    _, hkv = cfg.padded_heads(run.tp)
    lead = (n_triples,)
    triples = {"rec1": _zero_rec_state(cfg, batch, dt, device, lead),
               "rec2": _zero_rec_state(cfg, batch, dt, device, lead),
               "attn": attn_mod.KVCache.zeros(
                   batch, max_len, hkv, cfg.resolved_head_dim, dt, device,
                   window=cfg.window, lead=lead)}
    tail = (_zero_rec_state(cfg, batch, dt, device, (n_tail,)) if n_tail
            else None)
    return DecodeState(triples=triples, tail=tail, pos=0)


def _rec_decode(p: dict, cfg: ModelConfig, x: Tensor, st: RecState) -> Tensor:
    """x: (B,1,D).  ``st`` (one layer's state) is updated in place."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    dt = x.dtype
    gate = gelu(h @ p["w_gate_branch"].to(dt))
    u = (h @ p["w_x"].to(dt))[:, 0]                            # (B, W)
    # conv over [buf, u]
    hist = torch.cat([st.conv_buf, u[:, None]], dim=1)         # (B, cw, W)
    cw = p["conv"]["w"].shape[0]
    uc = sum(hist[:, i] * p["conv"]["w"][i].to(dt) for i in range(cw)) \
        + p["conv"]["b"].to(dt)
    a, bcoef = _lru_coeffs(p["lru"], uc)
    hnew = a * st.h + bcoef
    y = (gate[:, 0] * hnew.to(dt)) @ p["lru_out"].to(dt)
    x = x + y[:, None]
    z = rmsnorm(p["ln2"], x, cfg.norm_eps)
    x = x + _geglu(p["mlp"], z)
    st.conv_buf.copy_(hist[:, 1:])
    st.h.copy_(hnew)
    return x


def decode_step(params: dict, cfg: ModelConfig, run: RunConfig, token: Tensor,
                state: DecodeState) -> tuple[Tensor, DecodeState]:
    """token (B, 1) int -> (logits (B, 1, V), new state).  The recurrent
    states and the ring-buffer caches are updated in place; the returned
    state shares their tensors."""
    common.refuse_sharded_decode(cfg, params)
    x = embed(params["embed"], token).to(compute_dtype(run))
    tr = state.triples
    cache = tr["attn"]

    def body(h, sl):
        tl = sl["p"]
        h = _rec_decode(tl["rec1"], cfg, h, RecState(sl["c1"], sl["h1"]))
        h = _rec_decode(tl["rec2"], cfg, h, RecState(sl["c2"], sl["h2"]))
        z = rmsnorm(tl["attn_layer"]["ln1"], h, cfg.norm_eps)
        layer_cache = attn_mod.KVCache(k=sl["k"], v=sl["v"], pos=cache.pos,
                                       window=cache.window)
        a, _ = attn_mod.decode_attention(tl["attn_layer"]["attn"], z,
                                         layer_cache, theta=cfg.rope_theta)
        h = h + a
        z = rmsnorm(tl["attn_layer"]["ln2"], h, cfg.norm_eps)
        return h + _geglu(tl["attn_layer"]["mlp"], z)

    x = apply_stack(body, x, {
        "p": params["triples"], "c1": tr["rec1"].conv_buf, "h1": tr["rec1"].h,
        "c2": tr["rec2"].conv_buf, "h2": tr["rec2"].h, "k": cache.k,
        "v": cache.v})
    if state.tail is not None:
        x = apply_stack(
            lambda h, sl: _rec_decode(sl["p"], cfg, h,
                                      RecState(sl["c"], sl["h"])),
            x, {"p": params["tail"], "c": state.tail.conv_buf,
                "h": state.tail.h})
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    triples = dict(tr, attn=dataclasses.replace(cache, pos=cache.pos + 1))
    return _logits(params, cfg, run, x), DecodeState(
        triples=triples, tail=state.tail, pos=state.pos + 1)
