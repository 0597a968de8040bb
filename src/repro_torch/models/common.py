"""Shared model building blocks, in PyTorch (params = nested dicts).

Conventions, as in the JAX package's ``models/common.py``:
  * params are float32 at init;
  * all functions take explicit shapes — nothing reads global state;
  * weight layouts keep the JAX package's paths and shapes:
      ("embed", "w")        -> (vocab, d)
      ("...attn", "wq")     -> (d, H, hd)
      ("...mlp", "w_in")    -> (d, f)

Initializers draw from an explicit ``torch.Generator`` on its own device and
move the result to ``device``; they do not reproduce ``jax.random``.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def compute_dtype(run) -> torch.dtype:
    """``RunConfig.compute_dtype`` ("float32", "bfloat16") as a torch dtype."""
    return getattr(torch, run.compute_dtype)


def randn(gen: torch.Generator, shape, device) -> Tensor:
    return torch.randn(shape, generator=gen, device=gen.device).to(device)


def uniform(gen: torch.Generator, shape, lo: float, hi: float, device) -> Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device)
    return (lo + (hi - lo) * u).to(device)


def lecun_init(gen: torch.Generator, shape, device, fan_in=None) -> Tensor:
    fan_in = fan_in or shape[-2]
    return randn(gen, shape, device) * (1.0 / fan_in) ** 0.5


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, device, lead=()) -> dict:
    return {"scale": torch.ones(*lead, d, device=device)}


def rmsnorm(params: dict, x: Tensor, eps: float = 1e-6) -> Tensor:
    x32 = x.to(torch.float32)
    y = x32 * torch.rsqrt(torch.mean(torch.square(x32), dim=-1, keepdim=True)
                          + eps)
    return (y * params["scale"]).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings (split-half rotation, fp32 angles)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)               # (hd/2,)
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].to(torch.float32) * freqs     # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / unembedding / MLP
# ---------------------------------------------------------------------------

def embed(params: dict, tokens: Tensor) -> Tensor:
    return params["w"][tokens]


def unembed(params: dict, x: Tensor) -> Tensor:
    return x @ params["w"].to(x.dtype)


def swiglu_init(gen: torch.Generator, d: int, f: int, device, lead=()) -> dict:
    return {"w_gate": lecun_init(gen, (*lead, d, f), device),
            "w_in": lecun_init(gen, (*lead, d, f), device),
            "w_out": lecun_init(gen, (*lead, f, d), device, fan_in=f)}


def swiglu(params: dict, x: Tensor) -> Tensor:
    dt = x.dtype
    gate = F.silu(x @ params["w_gate"].to(dt))
    return (gate * (x @ params["w_in"].to(dt))) @ params["w_out"].to(dt)


# ---------------------------------------------------------------------------
# layer stacks
# ---------------------------------------------------------------------------

def layer(tree, i: int):
    """Slice ``i`` of the leading (stacked-layer) axis of every leaf."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def apply_stack(body: Callable, carry, xs):
    """Run ``body(carry, layer_slice) -> carry`` over the leading axis of
    ``xs``: the Python loop that takes the place of ``jax.lax.scan``."""
    n = next(iter(_leaves(xs))).shape[0]
    for i in range(n):
        carry = body(carry, layer(xs, i))
    return carry


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
