"""GQA attention: full-sequence (prefill) and cached decode paths, in
PyTorch.

Supports grouped-query / multi-query heads, RoPE, QKV bias (qwen1.5/qwen2),
qk-norm (qwen3), a ring-buffer KV cache for sliding-window decode, and
cross-attention (llama-3.2-vision): K/V from another sequence, unrotated,
every key visible.  Under tensor parallelism ``full_attention`` runs on each
``"model"`` shard's heads (``shardwise``): shard *s* holds query heads
``[s H/N, (s+1) H/N)`` and KV heads ``[s KV/N, (s+1) KV/N)`` (the JAX
package groups query heads contiguously per KV head), launches the flash
kernel on them, and gives its part of the output projection, a partial sum.

Every prefill path goes through the flash-attention wrapper, cross-attention
too (non-causal, T != S): the JAX package sends cross-attention to its
einsum path and never to the kernel (``src/repro/models/attention.py:98``);
the port's kernel takes it, and its plain version is that einsum path with
no mask.

Weight layout, as in the JAX package:
    wq: (d, H, hd)   wk/wv: (d, KV, hd)   wo: (H, hd, d)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.common import apply_rope, lecun_init, rmsnorm, rmsnorm_init
from repro_torch.parallel.sharding import constrain
from repro_torch.parallel.tensor import PARTIAL, shardwise

Tensor = torch.Tensor


def attn_init(gen: torch.Generator, d: int, n_heads: int, n_kv: int,
              head_dim: int, device, *, qkv_bias: bool = False,
              qk_norm: bool = False, lead=()) -> dict:
    p = {
        "wq": lecun_init(gen, (*lead, d, n_heads, head_dim), device, fan_in=d),
        "wk": lecun_init(gen, (*lead, d, n_kv, head_dim), device, fan_in=d),
        "wv": lecun_init(gen, (*lead, d, n_kv, head_dim), device, fan_in=d),
        "wo": lecun_init(gen, (*lead, n_heads, head_dim, d), device,
                         fan_in=n_heads * head_dim),
    }
    if qkv_bias:
        p["bq"] = torch.zeros(*lead, n_heads, head_dim, device=device)
        p["bk"] = torch.zeros(*lead, n_kv, head_dim, device=device)
        p["bv"] = torch.zeros(*lead, n_kv, head_dim, device=device)
    if qk_norm:
        p["q_norm"] = rmsnorm_init(head_dim, device, lead)
        p["k_norm"] = rmsnorm_init(head_dim, device, lead)
    return p


def _project_qkv(params: dict, x: Tensor, x_kv: Tensor, positions: Tensor,
                 theta: float, rope: bool) -> tuple[Tensor, Tensor, Tensor]:
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x_kv, params["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x_kv, params["wv"].to(dt))
    if "bq" in params:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    if "q_norm" in params:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if rope:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k, v


@shardwise(PARTIAL)
def full_attention(params: dict, x: Tensor, *, positions: Tensor,
                   theta: float = 1e4, causal: bool = True, window: int = 0,
                   rope: bool = True, x_kv: Optional[Tensor] = None) -> Tensor:
    """Prefill path. x: (B,S,d).  ``x_kv`` (B,T,d) makes it cross-attention:
    positions apply to q only, k/v are unrotated, and every query sees every
    key (``causal`` and ``window`` are not read).  Always goes through the
    flash-attention wrapper: the kernel on CUDA, its plain version on the
    CPU."""
    cross = x_kv is not None
    q, k, v = _project_qkv(params, x, x_kv if cross else x, positions, theta,
                           rope and not cross)
    if cross:
        causal, window = False, 0
    ctx = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    return torch.einsum("bshk,hkd->bsd", ctx, params["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# decode with KV cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    """K/V of the tokens seen so far.  ``k``/``v``: (..., B, S_cache, KV, hd),
    with any leading stacked-layer axes; ``pos``: tokens already in the
    cache (a host int, so decode never waits on the device for it)."""
    k: Tensor
    v: Tensor
    pos: int
    window: int = 0    # 0 = full cache; >0 = ring buffer of this size

    @staticmethod
    def zeros(batch: int, length: int, n_kv: int, head_dim: int, dtype,
              device, window: int = 0, lead=()) -> "KVCache":
        size = min(length, window) if window else length
        shape = (*lead, batch, size, n_kv, head_dim)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device),
                       pos=0, window=window)


def decode_attention(params: dict, x: Tensor, cache: KVCache, *,
                     theta: float = 1e4, rope: bool = True,
                     kv_cross: Optional[tuple[Tensor, Tensor]] = None
                     ) -> tuple[Tensor, KVCache]:
    """One-token decode. x: (B,1,d).  The new K/V are written into the
    cache's slot in place (``index_copy_``), so the returned cache shares
    its tensors with ``cache``; only ``pos`` advances.  With ``kv_cross``
    (precomputed K/V of another sequence) it attends those instead, by the
    plain grouped einsum, and returns ``cache`` untouched."""
    dt = x.dtype
    pos = cache.pos
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    if kv_cross is not None:
        q, _, _ = _project_qkv(params, x, x, positions, theta, rope=False)
        ctx = fa_ops.grouped_attention(q, *kv_cross, None)
        return torch.einsum("bshk,hkd->bsd", ctx, params["wo"].to(dt)), cache
    q, k_new, v_new = _project_qkv(params, x, x, positions, theta, rope)
    slot = pos % cache.window if cache.window else pos
    # made on the device: a host-to-device copy would wait for the stream
    index = torch.full((1,), slot, dtype=torch.long, device=x.device)
    cache.k.index_copy_(1, index, k_new.to(cache.k.dtype))
    cache.v.index_copy_(1, index, v_new.to(cache.v.dtype))
    # pins the updated cache's sharding in the JAX package; on one device a
    # no-op
    k = constrain(cache.k, "kv_cache")
    v = constrain(cache.v, "kv_cache")
    t = torch.arange(k.shape[1], device=x.device)
    live = min(pos + 1, cache.window) if cache.window else pos + 1
    mask = (t < live)[None, None, None, None, :]
    ctx = fa_ops.grouped_attention(q, k, v, mask)
    out = torch.einsum("bshk,hkd->bsd", ctx, params["wo"].to(dt))
    return out, KVCache(k=k, v=v, pos=pos + 1, window=cache.window)


def prefill_cache(params: dict, x: Tensor, *, positions: Tensor, theta: float,
                  rope: bool, max_len: int, window: int = 0) -> KVCache:
    """Build a cache from a full prompt (keys stored rotated).  With a
    window shorter than the prompt, the last ``window`` keys fill the ring:
    the key of absolute time t lives at slot t % window."""
    _, k, v = _project_qkv(params, x, x, positions, theta, rope)
    b, s = x.shape[0], x.shape[1]
    cache = KVCache.zeros(b, max_len, k.shape[2], k.shape[3], k.dtype,
                          x.device, window)
    if window and s > window:
        slots = torch.arange(s - window, s, device=x.device) % window
        cache.k[:, slots] = k[:, -window:]
        cache.v[:, slots] = v[:, -window:]
    else:
        cache.k[:, :s] = k
        cache.v[:, :s] = v
    cache.pos = s
    return cache
