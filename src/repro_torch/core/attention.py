"""Self-attention primitives for the hyper-block autoencoder (paper Eqs. 2-6),
in PyTorch.

Parameters are plain dicts of tensors with the JAX package's tree paths and
layouts, so a ``repro-compressor-v2`` manifest loads without renaming:
``linear`` stores ``w`` as ``(d_in, d_out)`` and computes ``y = x @ w`` (the
transpose of ``nn.Linear.weight``).

Inputs are batched hyper-blocks ``(B, k, d)``.  The attention core goes
through ``repro_torch.kernels.block_attention.ops.block_attention``, which
launches the CUDA kernel for CUDA tensors and runs its plain version
``block_attention_plain`` (the JAX package's ``_reference_attention``) for
CPU tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.block_attention.ops import block_attention

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AttnMeta:
    """Static attention hyperparameters carried in the params tree."""
    heads: int


# ---------------------------------------------------------------------------
# layer norm
# ---------------------------------------------------------------------------

def layernorm_init(d: int) -> dict:
    return {"scale": torch.ones(d), "bias": torch.zeros(d)}


def layernorm(params: dict, x: Tensor, eps: float = 1e-5) -> Tensor:
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)   # as jnp.var
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * params["scale"] + params["bias"]


# ---------------------------------------------------------------------------
# linear
# ---------------------------------------------------------------------------

def linear_init(gen: torch.Generator, d_in: int, d_out: int,
                bias: bool = True) -> dict:
    scale = 1.0 / d_in ** 0.5
    w = torch.empty(d_in, d_out).uniform_(-scale, scale, generator=gen)
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros(d_out)
    return p


def linear(params: dict, x: Tensor) -> Tensor:
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y


# ---------------------------------------------------------------------------
# self-attention (paper Eq. 2-3)
# ---------------------------------------------------------------------------

def attention_init(gen: torch.Generator, d: int, d_k: Optional[int] = None,
                   d_v: Optional[int] = None, heads: int = 1) -> dict:
    """Learned W_Q, W_K, W_V and the output projection."""
    d_k = d_k or d
    d_v = d_v or d
    if d_k % heads or d_v % heads:
        raise ValueError(f"heads={heads} must divide d_k={d_k} and d_v={d_v}")
    return {
        "wq": linear_init(gen, d, d_k, bias=False),
        "wk": linear_init(gen, d, d_k, bias=False),
        "wv": linear_init(gen, d, d_v, bias=False),
        "wo": linear_init(gen, d_v, d, bias=False),
        "meta": AttnMeta(heads=heads),
    }


def self_attention(params: dict, x: Tensor) -> Tensor:
    """Plain softmax self-attention over axis -2.  x: (..., k, d) -> (..., k, d)."""
    heads = params["meta"].heads
    q = linear(params["wq"], x)
    k = linear(params["wk"], x)
    v = linear(params["wv"], x)
    return linear(params["wo"], block_attention(q, k, v, heads))


def attention_block_init(gen: torch.Generator, d: int, heads: int = 1) -> dict:
    """The full Eq.6 block: e~ = Atten(norm(e)) + e."""
    return {"ln": layernorm_init(d), "attn": attention_init(gen, d, heads=heads)}


def attention_block(params: dict, e: Tensor) -> Tensor:
    return self_attention(params["attn"], layernorm(params["ln"], e)) + e
