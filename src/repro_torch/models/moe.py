"""Mixture-of-Experts layer with sort-based static-capacity dispatch, in
PyTorch.

As in the JAX package's ``models/moe.py``: tokens are routed by sorting
(token, slot) pairs by expert id and gathering each expert's segment into a
static (E, C, D) buffer, so the expert FLOPs are proportional to the active
tokens,

    FLOPs = 2 * E * C * (3 * D * F)   with   C = ceil(T * top_k * cf / E),

and over-capacity pairs are dropped (the earlier (token, slot) pairs of an
over-full expert are kept).  The experts run as batched matmuls over the
buffer (``torch.bmm``): the JAX package computes them outside any Pallas
kernel.  Expert weights are laid out (E, D, F).

Under tensor parallelism (``parallel.tensor``) the router is replicated and
the experts are split over the ``"model"`` shards: by expert (expert
parallelism, E / N each) or, where N does not divide E, by each expert's F
(``param_partition_specs``' fallback).  Every shard routes the whole batch
(``tokens_flat`` is replicated over the model axis), so the capacity, the
order of the pairs and the drops are the same on every shard; each shard
runs only its own experts' slots (or its slice of every expert), and the
``tokens_flat`` constraint after the combine sums the shards' outputs.

Parity with ``jax.lax.top_k`` and ``jnp.argsort``: the top k come from a
stable descending sort of the gates, so among equal gates the lower expert
index comes first, and the pairs are sorted by expert with a stable sort.
The scatter into the buffer sends dropped pairs to a spare row ``E * C``
(JAX's out-of-bounds ``mode="drop"``), cut off before the matmuls.  The
combine is ``index_add_``; on CUDA it sums with atomics, so the order of a
token's k contributions, and the last bits of the sum, vary from run to run.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import lecun_init, swiglu, swiglu_init
from repro_torch.parallel import tensor as tp
from repro_torch.parallel.sharding import constrain

Tensor = torch.Tensor


def moe_init(gen: torch.Generator, d: int, f: int, n_experts: int, device, *,
             shared_expert: bool, shared_f: Optional[int] = None,
             lead=()) -> dict:
    p = {
        "router": lecun_init(gen, (*lead, d, n_experts), device),
        "w_gate": lecun_init(gen, (*lead, n_experts, d, f), device, fan_in=d),
        "w_in": lecun_init(gen, (*lead, n_experts, d, f), device, fan_in=d),
        "w_out": lecun_init(gen, (*lead, n_experts, f, d), device, fan_in=f),
    }
    if shared_expert:
        p["shared"] = swiglu_init(gen, d, shared_f or f, device, lead)
    return p


def _capacity(tokens: int, top_k: int, n_experts: int, cf: float) -> int:
    c = int(tokens * top_k * cf / n_experts) + 1
    return max(8, min(c, tokens))


def _route(params: dict, xf: Tensor, top_k: int) -> tuple[Tensor, Tensor]:
    """(gates of the top k (T, k) fp32, their expert ids (T, k)): the router
    matmul in the compute dtype, its softmax in fp32, and the top k in
    ``jax.lax.top_k``'s order (ties to the lower index)."""
    logits = xf @ params["router"].to(xf.dtype)
    gates = torch.softmax(logits.to(torch.float32), dim=-1)
    weights, expert_idx = torch.sort(gates, dim=-1, descending=True,
                                     stable=True)
    return weights[:, :top_k], expert_idx[:, :top_k]


def moe_apply(params: dict, x: Tensor, *, top_k: int,
              capacity_factor: float = 1.25,
              dispatch_groups: int = 0) -> Tensor:
    """x: (B, S, D) -> (B, S, D).  ``dispatch_groups`` > 1 splits the B * S
    tokens into that many groups, each routed with its own capacity, as the
    JAX package's ``vmap`` over groups does."""
    b, s, d = x.shape
    if dispatch_groups > 1:
        t = b * s
        if t % dispatch_groups:
            raise ValueError(f"moe_apply: {t} tokens do not split into "
                             f"{dispatch_groups} dispatch groups")
        xg = constrain(x.reshape(dispatch_groups, t // dispatch_groups, d),
                       "tokens_grouped")
        yg = tp.each(torch.stack, [
            _dispatch_tokens(params, xg[i], top_k=top_k,
                             capacity_factor=capacity_factor)
            for i in range(dispatch_groups)])
        return constrain(yg, "tokens_grouped").reshape(b, s, d)
    y = _dispatch_tokens(params, x.reshape(b * s, d), top_k=top_k,
                         capacity_factor=capacity_factor)
    return y.reshape(b, s, d)


def _counts(ids: Tensor, e: int) -> Tensor:
    """Occurrences of each of the ``e`` ids, as ``torch.bincount`` counts
    them, without its device-to-host read of the largest id."""
    return torch.zeros(e, dtype=torch.long, device=ids.device).scatter_add_(
        0, ids.reshape(-1), torch.ones_like(ids.reshape(-1)))


def _plan(expert_idx: Tensor, e: int, c: int) -> tuple[Tensor, Tensor, Tensor]:
    """The (token, slot) pairs of ``expert_idx`` (T, k) sorted by expert,
    stably: ``order`` (T*k,) indexes the flat pairs, ``keep`` marks the
    pairs within their expert's capacity ``c``, ``buf_slot`` is each pair's
    row of the (E*C, D) buffer (0 within its expert where dropped)."""
    flat_expert = expert_idx.reshape(-1)                          # (T*k,)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    counts = _counts(sorted_expert, e)
    seg_starts = torch.cumsum(counts, 0) - counts
    # position of each routed slot within its expert segment
    pos_in_expert = (torch.arange(flat_expert.numel(), device=order.device)
                     - seg_starts[sorted_expert])
    keep = pos_in_expert < c
    return order, keep, sorted_expert * c + torch.where(keep, pos_in_expert, 0)


def _dispatch_tokens(params: dict, xf: Tensor, *, top_k: int,
                     capacity_factor: float) -> Tensor:
    """Sort-based dispatch over a flat (T, D) token table (module
    docstring); from ``Shards`` each shard's experts, summed by the
    ``tokens_flat`` constraint."""
    xf = constrain(xf, "tokens_flat")
    y = tp.each(_dispatch_shard, params, xf, top_k, capacity_factor,
                layout=tp.PARTIAL, indexed=True)
    return constrain(y, "tokens_flat")


def _dispatch_shard(shard: int, params: dict, xf: Tensor, top_k: int,
                    capacity_factor: float) -> Tensor:
    """Shard ``shard``'s part of the dispatch: the routing of all the
    tokens over all E experts, then the slots of the experts whose weights
    it holds (all of them on one device or under F-splitting, where its
    output is its F-slice's part) and its part of the shared expert."""
    t, d = xf.shape
    e = params["router"].shape[-1]
    dt = xf.dtype
    weights, expert_idx = _route(params, xf, top_k)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)

    c = _capacity(t, top_k, e, capacity_factor)
    order, keep, buf_slot = _plan(expert_idx, e, c)
    token_of = order // top_k                                     # source token
    held = params["w_gate"].shape[-3]                # this shard's experts
    if held < e:
        # expert parallelism: the pairs of experts [lo, lo + held)
        lo = shard * held * c
        mine = (buf_slot >= lo) & (buf_slot < lo + held * c)
        keep = keep & mine
        buf_slot = torch.where(mine, buf_slot - lo, 0)

    # gather tokens into the (E*C, D) buffer; over-capacity slots go to the
    # spare row E*C, which is cut off
    buffer = torch.zeros((held * c + 1, d), dtype=dt, device=xf.device)
    buffer[torch.where(keep, buf_slot, held * c)] = xf[token_of]
    hidden = buffer[:held * c].reshape(held, c, d)

    gate = F.silu(torch.bmm(hidden, params["w_gate"].to(dt)))
    up = torch.bmm(hidden, params["w_in"].to(dt))
    out_flat = torch.bmm(gate * up, params["w_out"].to(dt)).reshape(held * c,
                                                                    d)

    # scatter back with the combine weights
    w_of_slot = weights.reshape(-1)[order]                        # (T*k,)
    contrib = torch.where(keep[:, None],
                          out_flat[buf_slot] * w_of_slot[:, None].to(dt),
                          torch.zeros((), dtype=dt, device=xf.device))
    y = torch.zeros((t, d), dtype=dt, device=xf.device).index_add_(
        0, token_of, contrib)

    if "shared" in params:
        y = y + swiglu(params["shared"], xf)
    return y


def moe_router_stats(params: dict, x: Tensor, top_k: int) -> dict:
    """Load-balance diagnostics: each expert's count of routed (token, slot)
    pairs over x (B, S, D), and the count's coefficient of variation."""
    xf = x.reshape(-1, x.shape[-1])
    _, expert_idx = _route(params, xf, top_k)
    load = _counts(expert_idx, params["router"].shape[-1])
    lf = load.to(torch.float32)
    return {"expert_load": load,
            "load_cv": torch.std(lf, correction=0)
            / torch.clamp(lf.mean(), min=1e-9)}
