"""Whisper-style encoder-decoder backbone in PyTorch (the conv/mel frontend
is a stub, as in the JAX package).

``frames`` (B, n_frames, d_model) are precomputed frame embeddings that
stand in for the output of whisper's two conv layers over the mel
spectrogram.  After that: sinusoidal encoder positions, a pre-LN
bidirectional encoder, a decoder with learned positions, causal
self-attention and cross-attention, GELU MLPs, a tied unembedding.
whisper-medium's 24 layers are 24 encoder and 24 decoder layers.

Every attention of ``encode`` and ``forward`` goes through the flash
wrapper (``attention.full_attention``): the encoder non-causal with T = S,
the decoder causal, the cross layers non-causal with T != S.  The JAX
package runs the encoder and the cross layers on its einsum path (its
``full_attention`` defaults to ``use_kernel=False`` and never sends
cross-attention to the kernel); the port's plain version is that einsum
path.  Decode attends the cross K/V, computed once in
``init_decode_state``, by the plain grouped einsum, as JAX does.

Layer params are stacked along a leading layer axis (``enc_layers``,
``dec_layers``), as in the JAX package; ``apply_stack`` loops over it.

Tensor parallelism splits the heads of the encoder's, the decoder's and the
cross attention (their biases with them), the MLPs' ``w_in`` by column and
``w_out`` by row, and the vocab.  The frames go whole to every shard; the
replicated ``b_in`` is added by columns and ``b_out`` once
(``common.gelu_mlp``); the position table, which the rules cut by rows,
adds each row to the vocab-parallel embedding's partial sum from the shard
that holds it; the tied unembedding is the vocab-split head.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import common
from repro_torch.models.common import (apply_stack, compute_dtype,
                                       cross_entropy_loss, embed,
                                       embedding_init, gelu_mlp,
                                       gelu_mlp_init, layer, layernorm,
                                       layernorm_init, randn, remat,
                                       sincos_positions, tp_rules)
from repro_torch.parallel import tensor as tp
from repro_torch.parallel.sharding import constrain

Tensor = torch.Tensor


def _attn_init(gen, cfg: ModelConfig, run: RunConfig, device, lead) -> dict:
    hq, hkv = cfg.padded_heads(run.tp)
    return attn_mod.attn_init(gen, cfg.d_model, hq, hkv,
                              cfg.resolved_head_dim, device, qkv_bias=True,
                              lead=lead)


def _pos_rows(cfg: ModelConfig) -> int:
    """Rows of the learned decoder position table."""
    return 4096 if cfg.max_seq > 4096 else cfg.max_seq


def init_params(cfg: ModelConfig, run: RunConfig, generator: torch.Generator,
                device) -> dict:
    """Seeded random params with the JAX init's shapes and scales (not its
    numbers), drawn on the generator's device and moved to ``device``."""
    d, ne, nd = cfg.d_model, (cfg.n_enc_layers,), (cfg.n_layers,)
    return {
        "embed": embedding_init(generator, cfg.padded_vocab(run.tp), d,
                                device),
        "pos_embed": {"w": randn(generator, (_pos_rows(cfg), d), device)
                      * 0.02},
        "enc_layers": {"ln1": layernorm_init(d, device, ne),
                       "ln2": layernorm_init(d, device, ne),
                       "attn": _attn_init(generator, cfg, run, device, ne),
                       "mlp": gelu_mlp_init(generator, d, cfg.d_ff, device,
                                            ne)},
        "dec_layers": {"ln1": layernorm_init(d, device, nd),
                       "ln2": layernorm_init(d, device, nd),
                       "ln3": layernorm_init(d, device, nd),
                       "attn": _attn_init(generator, cfg, run, device, nd),
                       "xattn": _attn_init(generator, cfg, run, device, nd),
                       "mlp": gelu_mlp_init(generator, d, cfg.d_ff, device,
                                            nd)},
        "enc_final_ln": layernorm_init(d, device),
        "dec_final_ln": layernorm_init(d, device),
    }


def encode(params: dict, cfg: ModelConfig, run: RunConfig,
           frames: Tensor) -> Tensor:
    """frames: (B, F, D) precomputed frame embeddings (frontend stub) ->
    the encoder output (B, F, D) in the compute dtype (as ``act_btd``
    places it, under tensor parallelism)."""
    with tp_rules(params, run):
        dt = compute_dtype(run)
        x = frames.to(dt) + sincos_positions(frames.shape[1], cfg.d_model,
                                             frames.device).to(dt)[None]
        x = constrain(tp.replicate(x, params), "act_btd")
        dummy_pos = torch.zeros(frames.shape[:2], dtype=torch.int32,
                                device=frames.device)

        def body(h, lp):
            z = layernorm(lp["ln1"], h)
            a = attn_mod.full_attention(lp["attn"], tp.whole(z),
                                        positions=dummy_pos, causal=False,
                                        rope=False)
            h = h + constrain(a, "act_btd")
            z = layernorm(lp["ln2"], h)
            return h + constrain(gelu_mlp(lp["mlp"], tp.whole(z)), "act_btd")

        x = apply_stack(remat(body, run), x, params["enc_layers"])
        return layernorm(params["enc_final_ln"], x)


def _dec_layer(lp: dict, x: Tensor, positions: Tensor,
               enc_out: Tensor) -> Tensor:
    h = layernorm(lp["ln1"], x)
    a = attn_mod.full_attention(lp["attn"], tp.whole(h), positions=positions,
                                causal=True, rope=False)
    x = x + constrain(a, "act_btd")
    h = layernorm(lp["ln2"], x)
    a = attn_mod.full_attention(lp["xattn"], tp.whole(h), positions=positions,
                                x_kv=enc_out, rope=False)
    x = x + constrain(a, "act_btd")
    h = layernorm(lp["ln3"], x)
    return x + constrain(gelu_mlp(lp["mlp"], tp.whole(h)), "act_btd")


def forward(params: dict, cfg: ModelConfig, run: RunConfig, tokens: Tensor,
            frames: Tensor) -> Tensor:
    """Teacher-forced decoder logits: tokens (B, S) over frames (B, F, D)
    -> (B, S, padded_vocab), through the tied unembedding, padded vocab
    columns (``tp`` > 1 only) masked to -1e30.  A decoder longer than the
    learned position table wraps around it (``pos % rows``), as in the JAX
    package.  From params as ``Shards`` the logits are gathered onto the
    first shard's device."""
    return tp.gather(_forward(params, cfg, run, tokens, frames))


def _forward(params: dict, cfg: ModelConfig, run: RunConfig, tokens: Tensor,
             frames: Tensor) -> Tensor:
    """``forward`` without the gather: under tensor parallelism the logits
    split over the vocab."""
    with tp_rules(params, run):
        dt = compute_dtype(run)
        enc_out = tp.whole(encode(params, cfg, run, frames))
        b, s = tokens.shape
        rows = _pos_rows(cfg)
        x = tp.each(_add_positions, embed(params["embed"], tokens).to(dt),
                    params["pos_embed"]["w"],
                    torch.arange(s, device=tokens.device) % rows, rows,
                    indexed=True)
        x = constrain(x, "act_btd")
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device)[None].expand(b, s)
        x = apply_stack(remat(lambda h, lp: _dec_layer(lp, h, positions,
                                                       enc_out), run),
                        x, params["dec_layers"])
        x = layernorm(params["dec_final_ln"], x)
        logits = common.lm_head(x, params["embed"]["w"].T, cfg.vocab,
                                cfg.padded_vocab(run.tp))
        return constrain(logits, "logits")


def _add_positions(s: int, x: Tensor, table: Tensor, pos: Tensor,
                   rows: int) -> Tensor:
    """The learned position rows ``pos`` (of ``rows``) added to the
    embedding.  Under tensor parallelism ``x`` is the vocab-parallel
    embedding's partial sum and the table is split by rows (the partition
    rules' ``embed/w$`` matches ``pos_embed/w``): each shard adds the rows
    it holds."""
    r = table.shape[0]
    local = pos - s * r
    got = table[local.clamp(0, r - 1)].to(x.dtype)
    if r < rows:
        inside = (local >= 0) & (local < r)
        got = torch.where(inside[:, None], got, torch.zeros_like(got))
    return x + got[None]


def train_loss(params: dict, cfg: ModelConfig, run: RunConfig,
               batch: dict) -> Tensor:
    """Mean next-token CE of ``batch`` ({"tokens", "labels", "frames"}) on
    the full logits (vocab-parallel under tensor parallelism);
    ``run.ce_chunk`` is not read, as in the JAX package."""
    logits = _forward(params, cfg, run, batch["tokens"], batch["frames"])
    return cross_entropy_loss(logits, batch["labels"], cfg.vocab)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    caches: Any       # self-attention KVCache stacked over the decoder layers
    cross_kv: Any     # (k, v), each (n_layers, B, F, KV, hd), from the encoder
    pos: int


def init_decode_state(params: dict, cfg: ModelConfig, run: RunConfig,
                      batch: int, max_len: int,
                      frames: Tensor) -> DecodeState:
    """Zero self-attention caches, and each decoder layer's cross K/V of the
    encoded ``frames`` (one ``encode``), projected with its ``xattn``."""
    common.refuse_sharded_decode(cfg, params)
    dt = compute_dtype(run)
    _, hkv = cfg.padded_heads(run.tp)
    enc_out = encode(params, cfg, run, frames)
    zeros = torch.zeros(enc_out.shape[:2], dtype=torch.int32,
                        device=enc_out.device)
    kvs = [attn_mod._project_qkv(layer(params["dec_layers"]["xattn"], i),
                                 enc_out, enc_out, zeros, 0.0, rope=False)[1:]
           for i in range(cfg.n_layers)]
    cross_kv = (torch.stack([k for k, _ in kvs]),
                torch.stack([v for _, v in kvs]))
    caches = attn_mod.KVCache.zeros(batch, max_len, hkv,
                                    cfg.resolved_head_dim, dt,
                                    enc_out.device, lead=(cfg.n_layers,))
    return DecodeState(caches=caches, cross_kv=cross_kv, pos=0)


def decode_step(params: dict, cfg: ModelConfig, run: RunConfig, token: Tensor,
                state: DecodeState) -> tuple[Tensor, DecodeState]:
    """token (B, 1) int -> (logits (B, 1, V), new state).  The caches are
    updated in place; the returned state shares their tensors."""
    common.refuse_sharded_decode(cfg, params)
    dt = compute_dtype(run)
    pos_table = params["pos_embed"]["w"]
    x = embed(params["embed"], token).to(dt) + \
        pos_table[state.pos % pos_table.shape[0]].to(dt)[None, None]
    caches = state.caches

    def body(h, sl):
        lp = sl["p"]
        z = layernorm(lp["ln1"], h)
        cache = attn_mod.KVCache(k=sl["k"], v=sl["v"], pos=caches.pos)
        a, cache = attn_mod.decode_attention(lp["attn"], z, cache, rope=False)
        h = h + a
        z = layernorm(lp["ln2"], h)
        a, _ = attn_mod.decode_attention(lp["xattn"], z, cache, rope=False,
                                         kv_cross=(sl["ck"], sl["cv"]))
        h = h + a
        z = layernorm(lp["ln3"], h)
        return h + gelu_mlp(lp["mlp"], z)

    ck, cv = state.cross_kv
    x = apply_stack(body, x, {"p": params["dec_layers"], "k": caches.k,
                              "v": caches.v, "ck": ck, "cv": cv})
    x = layernorm(params["dec_final_ln"], x)
    logits = x @ params["embed"]["w"].to(dt).T      # unmasked, as in JAX
    new = attn_mod.KVCache(k=caches.k, v=caches.v, pos=caches.pos + 1)
    return logits, DecodeState(
        caches=new, cross_kv=state.cross_kv, pos=state.pos + 1)
