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
operation over all leaves.
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
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(item) for item in node)
        return next(it) if isinstance(node, Tensor) else node

    return build(tree)


def tree_map(fn: Callable[[Tensor], Tensor], tree: PyTree) -> PyTree:
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])


def tree_zeros_like(tree: PyTree, dtype=None) -> PyTree:
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype or x.dtype), tree)


def global_norm(tree: PyTree) -> Tensor:
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves))


def clip_by_global_norm(tree: PyTree, max_norm: float) -> tuple[PyTree, Tensor]:
    norm = global_norm(tree)
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
    """init(params) -> state;  update(grads, state, params) -> (params, state, stats)."""
    init: Callable[[PyTree], Any]
    update: Callable[[PyTree, Any, PyTree], tuple[PyTree, Any, dict]]


def _device(params: PyTree) -> Optional[torch.device]:
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else None


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
    def update(grads: PyTree, state: AdamState, params: PyTree):
        stats = {}
        if max_grad_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
            stats["grad_norm"] = gnorm
        step = state.step + 1
        lr_t = sched(step)
        stats["lr"] = lr_t
        bc1 = 1.0 - b1 ** step.to(torch.float32)
        bc2 = 1.0 - b2 ** step.to(torch.float32)

        f32 = torch.float32
        p, mu, nu = (tree_leaves(t) for t in (params, state.mu, state.nu))
        g = [x.to(f32) for x in tree_leaves(grads)]
        m = torch._foreach_add(torch._foreach_mul([x.to(f32) for x in mu], b1),
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
            delta = torch._foreach_add(delta,
                                       torch._foreach_mul(p32, weight_decay))
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
    def update(grads, state, params):
        stats = {}
        if max_grad_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
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
