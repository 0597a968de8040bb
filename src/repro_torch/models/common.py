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

Under tensor parallelism the params of each ``"model"`` shard come as a
``parallel.tensor.Shards``: the norms and the MLPs run on each shard's piece
(``shardwise``), the embedding, the LM head and the cross-entropy are
vocab-parallel, and the layer stack walks every shard's stack at once.  A
model's ``forward`` and ``train_loss`` run under :func:`tp_rules`, and its
decode refuses split params (:func:`refuse_sharded_decode`).  Under FSDP a
stacked leaf cut over the ``"data"`` axis comes as a
``parallel.fsdp.RowView``, which :func:`apply_stack` gathers at the layer
that uses it (inside :func:`remat`'s checkpoint where the body has one).
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.parallel import fsdp, sharding
from repro_torch.parallel import tensor as tp
from repro_torch.parallel.tensor import Shards, shardwise

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


@shardwise()
def rmsnorm(params: dict, x: Tensor, eps: float = 1e-6) -> Tensor:
    x32 = x.to(torch.float32)
    y = x32 * torch.rsqrt(torch.mean(torch.square(x32), dim=-1, keepdim=True)
                          + eps)
    return (y * params["scale"]).to(x.dtype)


def layernorm_init(d: int, device, lead=()) -> dict:
    return {"scale": torch.ones(*lead, d, device=device),
            "bias": torch.zeros(*lead, d, device=device)}


def rmsnorm_over_shards(params: dict, x, eps: float = 1e-6):
    """``rmsnorm`` of ``x`` whose last dim the shards split (each shard's
    piece of ``x`` and of ``params["scale"]``): the mean of squares is the
    sum of every shard's squares (one all-reduce) over the whole width.  A
    tensor goes through ``rmsnorm``."""
    if not isinstance(x, Shards):
        return rmsnorm(params, x, eps)
    width = x.shape[-1]

    def norm(xs, ss, scale):
        y = xs.to(torch.float32) * torch.rsqrt(ss / width + eps)
        return (y * scale).to(xs.dtype)
    return tp.each(norm, x, tp.sum_of_squares(x), params["scale"],
                   layout=x.layout)


@shardwise()
def layernorm(params: dict, x: Tensor, eps: float = 1e-5) -> Tensor:
    """In fp32 (the variance with ddof 0), cast back to ``x``'s dtype."""
    x32 = x.to(torch.float32)
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mean), dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)


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


def sincos_positions(n: int, d: int, device=None) -> Tensor:
    """Fixed sinusoidal embeddings (the whisper encoder's), (n, d) fp32:
    ``[sin | cos]`` concatenated, not interleaved."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    angles = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


# ---------------------------------------------------------------------------
# embeddings / unembedding / MLP
# ---------------------------------------------------------------------------

def embedding_init(gen: torch.Generator, vocab: int, d: int, device) -> dict:
    return {"w": randn(gen, (vocab, d), device) * 0.02}


def embed(params: dict, tokens: Tensor) -> Tensor:
    """The rows of ``tokens``; from vocab-split params a partial sum
    (``tensor.embed``)."""
    if isinstance(params, Shards):
        return tp.embed(params, tokens)
    return params["w"][tokens]


def unembed(params: dict, x: Tensor) -> Tensor:
    return x @ params["w"].to(x.dtype)


def gelu(x: Tensor) -> Tensor:
    """The tanh approximation, ``jax.nn.gelu``'s default
    (``torch.nn.functional.gelu``'s default is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def swiglu_init(gen: torch.Generator, d: int, f: int, device, lead=()) -> dict:
    return {"w_gate": lecun_init(gen, (*lead, d, f), device),
            "w_in": lecun_init(gen, (*lead, d, f), device),
            "w_out": lecun_init(gen, (*lead, f, d), device, fan_in=f)}


@shardwise(tp.PARTIAL)
def swiglu(params: dict, x: Tensor) -> Tensor:
    dt = x.dtype
    gate = F.silu(x @ params["w_gate"].to(dt))
    return (gate * (x @ params["w_in"].to(dt))) @ params["w_out"].to(dt)


def gelu_mlp_init(gen: torch.Generator, d: int, f: int, device,
                  lead=()) -> dict:
    return {"w_in": lecun_init(gen, (*lead, d, f), device),
            "b_in": torch.zeros(*lead, f, device=device),
            "w_out": lecun_init(gen, (*lead, f, d), device, fan_in=f),
            "b_out": torch.zeros(*lead, d, device=device)}


def gelu_mlp(params: dict, x: Tensor) -> Tensor:
    """From split params a partial sum: each shard adds its columns of the
    replicated ``b_in``, and shard 0 alone adds ``b_out``."""
    return tp.each(_gelu_mlp, params, x, layout=tp.PARTIAL, indexed=True)


def _gelu_mlp(s: int, params: dict, x: Tensor) -> Tensor:
    dt = x.dtype
    f = params["w_in"].shape[-1]
    h = gelu(x @ params["w_in"].to(dt)
             + params["b_in"][..., s * f:(s + 1) * f].to(dt))
    y = h @ params["w_out"].to(dt)
    return y + params["b_out"].to(dt) if s == 0 else y


# ---------------------------------------------------------------------------
# layer stacks
# ---------------------------------------------------------------------------

def layer(tree, i: int):
    """Slice ``i`` of the leading (stacked-layer) axis of every leaf (of
    every shard's tree, for a ``Shards``; of a ``RowView``'s pieces)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    if isinstance(tree, Shards):
        return Shards([layer(t, i) for t in tree.pieces], None, tree.devices)
    return tree[i]


def apply_stack(body: Callable, carry, xs):
    """Run ``body(carry, layer_slice) -> carry`` over the leading axis of
    ``xs``: the Python loop that takes the place of ``jax.lax.scan``.  The
    slice's FSDP views with no stacked axis left are gathered for the body
    (``fsdp.at_use``), by the body itself where :func:`remat` wraps it."""
    n = next(iter(_leaves(xs))).shape[0]
    gathers = getattr(body, "gathers_at_use", False)
    for i in range(n):
        sl = layer(xs, i)
        carry = body(carry, sl if gathers else fsdp.at_use(sl))
    return carry


def remat(body: Callable, run) -> Callable:
    """``body`` under ``torch.utils.checkpoint`` when ``run.remat``, as the
    JAX package wraps a layer body in ``jax.checkpoint``: its forward keeps
    only its inputs, and the backward runs it again for the rest.  Where
    autograd records nothing (``torch.no_grad()``, decoding) it is ``body``
    itself."""
    if not run.remat:
        return body
    from torch.utils.checkpoint import checkpoint

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return body(*fsdp.at_use(args))
        # the recompute runs in the backward, after the forward's
        # activation rules (tensor parallelism's boundaries) are gone
        rules = sharding.active_rules()

        def again(*a):
            # FSDP's gathers inside the checkpoint: none is kept for the
            # backward, whose recompute gathers again
            with sharding.activation_sharding(rules):
                return body(*fsdp.at_use(a))
        return checkpoint(again, *args, use_reentrant=False)
    wrapped.gathers_at_use = True
    return wrapped


def _leaves(tree):
    if isinstance(tree, Shards):
        yield from _leaves(tree.pieces[0])
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# tensor parallelism of a model
# ---------------------------------------------------------------------------

def tp_rules(params, run):
    """The activation rules a tensor-parallel forward runs under: the
    caller's, or ``activation_rules(False, sp=run.sp)``; none on one
    device."""
    if not isinstance(params, Shards) or sharding.active_rules():
        return contextlib.nullcontext()
    return sharding.activation_sharding(
        sharding.activation_rules(False, sp=run.sp))


def refuse_sharded_decode(cfg, params) -> None:
    """Decoding from params split over a model axis needs sharded decode
    state: ``NotImplementedError`` naming the roadmap."""
    if isinstance(params, Shards):
        raise NotImplementedError(f"{cfg.arch}: decoding from params split "
                                  f"over a model axis needs sharded decode "
                                  f"state, which waits for its slice "
                                  f"(ROADMAP.md §1)")


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _nll(logits32: Tensor, labels: Tensor, vocab: int) -> tuple[Tensor, Tensor]:
    """(summed NLL, count) over the positions whose label is a real id;
    labels outside [0, vocab) (padding ids) are masked, as in the JAX
    package, and clamped only so that the gather stays in bounds.
    Vocab-split logits go through ``tensor.vocab_parallel_nll``."""
    if isinstance(logits32, Shards):
        return tp.vocab_parallel_nll(logits32, labels, vocab)
    logz = torch.logsumexp(logits32, dim=-1)
    idx = labels.long().clamp(0, logits32.shape[-1] - 1)
    gold = torch.gather(logits32, -1, idx[..., None])[..., 0]
    mask = (labels >= 0) & (labels < vocab)
    nll = torch.where(mask, logz - gold, torch.zeros_like(logz))
    return nll.sum(), mask.sum()


def cross_entropy_loss(logits: Tensor, labels: Tensor, vocab: int) -> Tensor:
    """Mean CE over all positions; labels >= vocab (padding ids) are masked."""
    nll, count = _nll(logits.to(torch.float32), labels, vocab)
    return nll / torch.clamp(count, min=1)


def chunked_ce_loss(x: Tensor, unembed_w: Tensor, labels: Tensor, vocab: int,
                    chunk: int, logit_mask_from: int = 0) -> Tensor:
    """Fused LM-head + CE, sequence-chunked.

    The head matmul, logsumexp and gold gather run per sequence chunk under
    ``torch.utils.checkpoint``, so the live logits are (B, chunk, V) and the
    full (B, S, V) tensor never exists: the backward recomputes each chunk's
    logits.  The same math as ``cross_entropy_loss`` over the full logits
    (exact, not an approximation).

    x: (B, S, D) final hidden states;  unembed_w: (D, V_padded);
    ``logit_mask_from``: columns >= this are padding (masked to -1e30).
    """
    from torch.utils.checkpoint import checkpoint

    s = x.shape[1]
    if s % chunk:
        raise ValueError(f"chunked_ce_loss: sequence {s} is not a multiple "
                         f"of the chunk {chunk}")
    x = tp.whole(x)
    w = unembed_w.to(x.dtype)

    def one(xi: Tensor, w: Tensor, li: Tensor):
        return _nll(tp.each(_mask_padding, _head(xi, w).to(torch.float32),
                            logit_mask_from, indexed=True), li, vocab)

    nll_total = count = 0
    for i in range(0, s, chunk):
        nll, cnt = checkpoint(one, x[:, i:i + chunk], w,
                              labels[:, i:i + chunk], use_reentrant=False)
        nll_total = nll_total + nll
        count = count + cnt
    return nll_total / torch.clamp(count, min=1)


def _head(x: Tensor, w: Tensor) -> Tensor:
    """``x @ w`` (``w``: (D, V_padded)), vocab-split from split ``w``: from
    its columns at once; from its rows (an untied ``unembed/w``, which the
    partition rules cut by D: ``embed/w$`` matches it first) each shard's
    part of the sum over D, reduce-scattered over the vocab."""
    if not isinstance(w, Shards):
        return x @ w.to(x.dtype)
    if w.pieces[0].shape[0] == x.shape[-1]:
        return tp.each(lambda xs, ws: xs @ ws.to(xs.dtype), x, w,
                       layout=x.ndim - 1)

    def rows(s, xs, ws):
        d = ws.shape[0]
        return xs[..., s * d:(s + 1) * d] @ ws.to(xs.dtype)
    return tp.each(rows, x, w, layout=tp.PARTIAL,
                   indexed=True).place(x.ndim - 1)


def _mask_padding(s: int, logits: Tensor, mask_from: int) -> Tensor:
    """Shard ``s``'s vocab-split logits (all of them on one device) with
    the padding columns (global index >= ``mask_from``, if set) at
    -1e30."""
    v = logits.shape[-1]
    if mask_from and mask_from < (s + 1) * v:
        mask = torch.where(torch.arange(s * v, (s + 1) * v,
                                        device=logits.device) < mask_from,
                           0.0, -1e30)
        logits = logits + mask.to(logits.dtype)
    return logits


def lm_head(x: Tensor, w: Tensor, vocab: int, padded: int) -> Tensor:
    """``x @ w`` (``w``: (D, V_padded)) with the padding columns at -1e30;
    from split ``w`` the vocab-split logits (``_head``), each shard masking
    the padding columns it holds."""
    return tp.each(_mask_padding, _head(tp.whole(x), w),
                   vocab if padded != vocab else 0, indexed=True)


def train_loss(forward: Callable, params: dict, cfg, run, batch: dict,
               head_w: Tensor) -> Tensor:
    """Mean next-token CE of ``batch`` ({"tokens", "labels"}, (B, S) ints,
    and for the VLM family "vision_embeds") through the model's ``forward``;
    with ``run.ce_chunk`` the LM head (``head_w``, (D, V_padded)) and the CE
    run chunked on the final hidden states."""
    extra = ({"vision_embeds": batch["vision_embeds"]}
             if "vision_embeds" in batch else {})
    if run.ce_chunk:
        x = forward(params, cfg, run, batch["tokens"], return_hidden=True,
                    **extra)
        pv = cfg.padded_vocab(run.tp)
        return chunked_ce_loss(x, head_w, batch["labels"], cfg.vocab,
                               run.ce_chunk,
                               logit_mask_from=cfg.vocab if pv != cfg.vocab
                               else 0)
    logits = forward(params, cfg, run, batch["tokens"], **extra)
    return cross_entropy_loss(logits, batch["labels"], cfg.vocab)
