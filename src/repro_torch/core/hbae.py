"""Hyper-Block AutoEncoder (HBAE) — paper Sec. II-B, in PyTorch.

Encoding path (per hyper-block of k blocks, each block flattened to ``in_dim``):
  1. each block -> 2-layer FC encoder (ReLU middle) -> embedding e_i in R^emb
  2. e~ = Atten(LayerNorm(e)) + e                       (Eq. 6)
  3. flatten (k, emb) -> FC -> latent L_h in R^latent

Decoding mirrors it: L_h -> FC -> (k, emb) -> same attention block form ->
per-block 2-layer FC decoder -> reconstructed blocks y_i.

Shapes: x is (B, k, in_dim); latent is (B, latent); output is (B, k, in_dim).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.attention import (attention_block, attention_block_init,
                                        linear, linear_init)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class HbaeMeta:
    k: int
    emb: int
    use_attention: bool


def mlp2_init(gen: torch.Generator, d_in: int, d_hidden: int, d_out: int) -> dict:
    return {"fc1": linear_init(gen, d_in, d_hidden),
            "fc2": linear_init(gen, d_hidden, d_out)}


def mlp2(params: dict, x: Tensor) -> Tensor:
    return linear(params["fc2"], torch.relu(linear(params["fc1"], x)))


def hbae_init(gen: torch.Generator, *, in_dim: int, k: int, emb: int = 128,
              hidden: int = 256, latent: int = 128, heads: int = 1,
              use_attention: bool = True) -> dict:
    """``use_attention=False`` builds the 'HBAE-woa' ablation of paper Fig. 5."""
    params = {
        "enc": mlp2_init(gen, in_dim, hidden, emb),
        "to_latent": linear_init(gen, k * emb, latent),
        "from_latent": linear_init(gen, latent, k * emb),
        "dec": mlp2_init(gen, emb, hidden, in_dim),
        "meta": HbaeMeta(k=k, emb=emb, use_attention=use_attention),
    }
    if use_attention:
        params["enc_attn"] = attention_block_init(gen, emb, heads=heads)
        params["dec_attn"] = attention_block_init(gen, emb, heads=heads)
    return params


def hbae_encode(params: dict, x: Tensor) -> Tensor:
    """(B, k, in_dim) -> (B, latent)."""
    meta = params["meta"]
    e = mlp2(params["enc"], x)                           # (B, k, emb)
    if meta.use_attention:
        e = attention_block(params["enc_attn"], e)
    flat = e.reshape(e.shape[0], -1)                      # (B, k*emb)
    return linear(params["to_latent"], flat)


def hbae_decode(params: dict, latent: Tensor) -> Tensor:
    """(B, latent) -> (B, k, in_dim)."""
    meta = params["meta"]
    k, emb = meta.k, meta.emb
    e = linear(params["from_latent"], latent).reshape(latent.shape[0], k, emb)
    if meta.use_attention:
        e = attention_block(params["dec_attn"], e)
    return mlp2(params["dec"], e)


def hbae_apply(params: dict, x: Tensor) -> tuple[Tensor, Tensor]:
    """Returns (reconstruction y, latent L_h)."""
    latent = hbae_encode(params, x)
    y = hbae_decode(params, latent)
    return y, latent
