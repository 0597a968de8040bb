"""Optimizers and LR schedules on the port's param trees.

The JAX package's ``train/optim.py`` in PyTorch, with its formulas: Adam is
``mhat / (sqrt(vhat) + eps)`` with ``bc1 = 1 - b1**step`` and
``bc2 = 1 - b2**step``, in that order of operations.  ``torch.optim.Adam``
rearranges the division and is not used.

A param tree is a nested dict (or list) of tensors, as the compressor's
modules build it.  Leaves that are not tensors (``AttnMeta``, ``HbaeMeta``)
are static: every tree function passes them through untouched.  Dict keys
are visited in sorted order, as ``jax.tree.leaves`` visits them, so sums over
leaves run in the JAX package's order.

``update`` writes the new params into the param tensors in place, under
``torch.no_grad()`` (the JAX step donates its buffers), and returns the same
tree.  The step count, the learning rate and the bias corrections are
0-dim tensors on the params' device, so an update never waits on the host;
the per-leaf arithmetic runs as one ``torch._foreach_*`` launch per
operation over a group of leaves (all of a compressor's leaves form one
group; an LM's are split, its largest leaves cut into flat views, so that
the temporaries stay small).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

Tensor = torch.Tensor
PyTree = Any


# ---------------------------------------------------------------------------
# pytree helpers
# ---------------------------------------------------------------------------

def tree_leaves(tree: PyTree) -> list[Tensor]:
    """The tensor leaves of ``tree`` in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree] if isinstance(tree, Tensor) else []


def tree_unflatten(tree: PyTree, leaves) -> PyTree:
    """``tree`` with its tensor leaves replaced, in ``tree_leaves`` order, by
    ``leaves``; static leaves are kept."""
    return _build(tree, iter(leaves))


def _build(node, it) -> PyTree:
    # a module-level recursion: a nested one would hold itself, and with it
    # ``leaves``, in a reference cycle until the cyclic collector ran
    if isinstance(node, dict):
        return {key: _build(node[key], it) for key in sorted(node)}
    if isinstance(node, (list, tuple)):
        return type(node)(_build(item, it) for item in node)
    return next(it) if isinstance(node, Tensor) else node


def tree_map(fn: Callable[[Tensor], Tensor], tree: PyTree) -> PyTree:
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])


def tree_zeros_like(tree: PyTree, dtype=None) -> PyTree:
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype or x.dtype), tree)


def global_norm(tree: PyTree) -> Tensor:
    """The l2 norm of every leaf together, its squares summed in float32.  A
    leaf in another dtype (bf16) of more than ``GROUP_BYTES // 4`` elements
    is summed in flat pieces of at most that many (``_cut``), so that its
    float32 copy never exists whole; a float32 leaf is summed whole."""
    leaves = [piece for x in tree_leaves(tree)
              for piece in ([x] if x.dtype == torch.float32
                            else _cut([x], read_only=True))]
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves))


def global_norm_of_groups(groups: list) -> Tensor:
    """The l2 norm of several groups of leaves together, each group's
    squares summed on its own device by ``global_norm`` and the groups'
    sums added on the first group's device: the norm of a tree held as
    pieces on several devices, each piece in one group once."""
    home = tree_leaves(groups[0])[0].device
    return torch.sqrt(sum(torch.square(global_norm(g)).to(home)
                          for g in groups))


def clip_by_global_norm(tree: PyTree, max_norm: float,
                        norm: Optional[Tensor] = None
                        ) -> tuple[PyTree, Tensor]:
    norm = global_norm(tree) if norm is None else norm
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), norm


# ---------------------------------------------------------------------------
# schedules: step (an int or a 0-dim tensor) -> float32 0-dim tensor
# ---------------------------------------------------------------------------

def _step_f32(step) -> Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant_schedule(lr: float) -> Callable[[Any], Tensor]:
    return lambda step: torch.full_like(_step_f32(step), lr)


def warmup_cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                           final_frac: float = 0.1) -> Callable[[Any], Tensor]:
    warmup_steps = max(warmup_steps, 1)

    def sched(step) -> Tensor:
        step = _step_f32(step)
        warm = peak_lr * step / warmup_steps
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)

    return sched


def linear_decay_schedule(peak_lr: float, total_steps: int
                          ) -> Callable[[Any], Tensor]:
    def sched(step) -> Tensor:
        t = torch.clamp(_step_f32(step) / max(total_steps, 1), 0.0, 1.0)
        return peak_lr * (1.0 - t)
    return sched


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

class AdamState(NamedTuple):
    step: Tensor
    mu: PyTree
    nu: PyTree


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """init(params) -> state;  update(grads, state, params, norm=None) ->
    (params, state, stats).  ``norm``, where the caller holds the gradients
    as pieces (tensor parallelism), is their global norm as it counted it
    (``global_norm_of_groups``), on the params' device; without it the
    update takes ``global_norm(grads)``."""
    init: Callable[[PyTree], Any]
    update: Callable[[PyTree, Any, PyTree], tuple[PyTree, Any, dict]]


def _device(params: PyTree) -> Optional[torch.device]:
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else None


# the leaves of one foreach pass hold at most this many bytes as float32 (a
# larger leaf is cut into flat views of at most that many fp32 elements'
# bytes): each of Adam's ~8 temporaries is that large, not the model's
# size, so an LM's update fits beside its params, moments and grads
GROUP_BYTES = 1 << 28


def _cut(leaves: list[Tensor], read_only: bool = False) -> list[Tensor]:
    """``leaves`` with each leaf of more than ``GROUP_BYTES // 4`` elements
    cut into flat views of at most that many (the same cut for a param, its
    moments and its gradient, whatever their dtypes); writing to a view
    writes to its leaf, and the update is elementwise.  A ``read_only``
    leaf that is not contiguous is copied flat."""
    step = GROUP_BYTES // 4
    out = []
    for x in leaves:
        if x.numel() <= step:
            out.append(x)
        else:
            out.extend((x.reshape(-1) if read_only else x.view(-1))
                       .split(step))
    return out


def _groups(leaves: list[Tensor]):
    """``(lo, hi)`` index ranges of consecutive leaves, each range at most
    ``GROUP_BYTES`` in float32 (the dtype of Adam's temporaries, whatever
    the params') unless it is one leaf."""
    lo, size = 0, 0
    for i, x in enumerate(leaves):
        n = x.numel() * 4
        if i > lo and size + n > GROUP_BYTES:
            yield lo, i
            lo, size = i, 0
        size += n
    if lo < len(leaves):
        yield lo, len(leaves)


def adamw(lr: float | Callable[[Any], Tensor] = 1e-3,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0, max_grad_norm: Optional[float] = None,
          mu_dtype=torch.float32) -> Optimizer:
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params: PyTree) -> AdamState:
        return AdamState(
            step=torch.zeros((), dtype=torch.int32, device=_device(params)),
            mu=tree_zeros_like(params, mu_dtype),
            nu=tree_zeros_like(params, torch.float32))

    @torch.no_grad()
    def update(grads: PyTree, state: AdamState, params: PyTree,
               norm: Optional[Tensor] = None):
        stats = {}
        scale = None
        if max_grad_norm is not None:
            # clip_by_global_norm's scale, applied group by group below, so
            # no clipped copy of the whole gradient tree is made
            gnorm = global_norm(grads) if norm is None else norm
            scale = torch.clamp(max_grad_norm / (gnorm + 1e-12), max=1.0)
            stats["grad_norm"] = gnorm
        step = state.step + 1
        lr_t = sched(step)
        stats["lr"] = lr_t
        bc1 = 1.0 - b1 ** step.to(torch.float32)
        bc2 = 1.0 - b2 ** step.to(torch.float32)

        f32 = torch.float32
        leaves = [_cut(tree_leaves(t)) for t in (params, state.mu, state.nu)]
        leaves.append(_cut(tree_leaves(grads), read_only=True))
        for lo, hi in _groups(leaves[0]):
            p, mu, nu, g = (x[lo:hi] for x in leaves)
            if scale is not None:
                g = [x * scale.to(x.dtype) for x in g]
            g = [x.to(f32) for x in g]
            m = torch._foreach_add(
                torch._foreach_mul([x.to(f32) for x in mu], b1),
                torch._foreach_mul(g, 1 - b1))
            v = torch._foreach_add(torch._foreach_mul(nu, b2),
                                   torch._foreach_mul(torch._foreach_mul(g, g),
                                                      1 - b2))
            mhat = torch._foreach_div(m, bc1)
            vhat = torch._foreach_div(v, bc2)
            delta = torch._foreach_div(
                mhat, torch._foreach_add(torch._foreach_sqrt(vhat), eps))
            p32 = [x.to(f32) for x in p]
            if weight_decay:
                delta = torch._foreach_add(
                    delta, torch._foreach_mul(p32, weight_decay))
            torch._foreach_copy_(p, torch._foreach_sub(
                p32, torch._foreach_mul(delta, lr_t)))
            torch._foreach_copy_(mu, m)
            torch._foreach_copy_(nu, v)
        return params, AdamState(step=step, mu=state.mu, nu=state.nu), stats

    return Optimizer(init=init, update=update)


def adam(lr=1e-3, **kw) -> Optimizer:
    """Paper setup: Adam, lr=1e-3 (Sec. III-C)."""
    return adamw(lr=lr, weight_decay=0.0, **kw)


class SgdState(NamedTuple):
    step: Tensor
    mu: PyTree


def sgd(lr: float | Callable = 1e-2, momentum: float = 0.0,
        max_grad_norm: Optional[float] = None) -> Optimizer:
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        return SgdState(torch.zeros((), dtype=torch.int32,
                                    device=_device(params)),
                        tree_zeros_like(params))

    @torch.no_grad()
    def update(grads, state, params, norm=None):
        stats = {}
        if max_grad_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm, norm)
            stats["grad_norm"] = gnorm
        step = state.step + 1
        lr_t = sched(step)
        p, mu = tree_leaves(params), tree_leaves(state.mu)
        m = torch._foreach_add(
            torch._foreach_mul(mu, momentum),
            [x.to(y.dtype) for x, y in zip(tree_leaves(grads), mu)])
        torch._foreach_copy_(p, torch._foreach_sub(
            [x.to(torch.float32) for x in p],
            torch._foreach_mul([x.to(torch.float32) for x in m], lr_t)))
        torch._foreach_copy_(mu, m)
        return params, SgdState(step, state.mu), stats

    return Optimizer(init=init, update=update)
