"""LM training loop, in PyTorch: the train step with gradient-accumulation
microbatching and optional compressed gradients (the paper's technique on the
gradients).

``make_train_step`` builds the step for any ported arch (the dense family and
SSD).  On CUDA the forward runs through the flash_attention or ssd_scan
kernel (inside their ``torch.autograd.Function``s, whose backward is the
plain formula); on the CPU through their plain versions.

The step is functional, as the JAX step is without donation: it returns a
new ``TrainState`` and leaves the one it was given untouched, so a runner
that drops a step (``ResilientRunner``'s ``skip`` policy) keeps the old
state.  The optimizer updates copies of the params and moments in place.

The port runs one process: ``axis_name`` (the data-parallel all-reduce of
the compressed gradients) is refused until sharding is ported.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.exec import resolve_device
from repro_torch.models import registry
from repro_torch.runtime import grad_compress
from repro_torch.train import optim

PyTree = Any
Tensor = torch.Tensor

GRADIENT_COMPRESSION = ("none", "pca_ef", "gae")


class TrainState(NamedTuple):
    params: PyTree
    opt: Any                 # the optimizer's state (``optim.AdamState``)
    gc: Optional[grad_compress.GradCompressionState]
    step: Tensor             # 0-dim int32, on the params' device


def init_train_state(generator: torch.Generator, cfg: ModelConfig,
                     run: RunConfig, optimizer: optim.Optimizer,
                     device=None) -> TrainState:
    """Seeded params (``registry.init_params``) on ``device`` (the card by
    default), the optimizer's state and, for ``pca_ef``, the compression
    state."""
    device = resolve_device(device)
    params = registry.init_params(cfg, run, generator, device)
    gc = None
    if run.gradient_compression == "pca_ef":
        gc = grad_compress.init_state(params, rank=run.grad_comp_rank)
    return TrainState(params=params, opt=optimizer.init(params), gc=gc,
                      step=torch.zeros((), dtype=torch.int32, device=device))


def _clone(tree: PyTree) -> PyTree:
    """A copy of every tensor leaf, with the tree's containers
    (``NamedTuple``s included) rebuilt."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone(x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(x) for x in tree)
    return tree.detach().clone() if isinstance(tree, Tensor) else tree


def _on_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def value_and_grad(cfg: ModelConfig, run: RunConfig,
                   microbatches: int = 1) -> Callable:
    """``fn(params, batch) -> (loss, grads)`` of the arch's ``train_loss``;
    ``params`` is not changed (its leaves are detached before the forward),
    and ``batch`` ("tokens" and "labels", (B, S) ints, numpy or tensors)
    goes to the params' device.  ``microbatches`` > 1 splits the batch along axis 0 and accumulates the
    gradients in fp32 (sequential microbatching): the mean of the
    microbatches' losses and gradients."""
    api = registry.get_model(cfg)

    def one(params: PyTree, batch: dict) -> tuple[Tensor, PyTree]:
        leaves = [p.detach().requires_grad_() for p in
                  optim.tree_leaves(params)]
        loss = api.train_loss(optim.tree_unflatten(params, leaves), cfg, run,
                              _on_device(batch, leaves[0].device))
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), optim.tree_unflatten(params, list(grads))

    def accumulated(params: PyTree, batch: dict) -> tuple[Tensor, PyTree]:
        batch = _on_device(batch, optim.tree_leaves(params)[0].device)
        b = batch["tokens"].shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into {microbatches} "
                             f"microbatches")
        size = b // microbatches
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in optim.tree_leaves(params)]
        lsum = torch.zeros((), device=gsum[0].device)
        for i in range(microbatches):
            loss, g = one(params, {k: v[i * size:(i + 1) * size]
                                   for k, v in batch.items()})
            gsum = [a + x.to(torch.float32)
                    for a, x in zip(gsum, optim.tree_leaves(g))]
            lsum = lsum + loss
        inv = 1.0 / microbatches
        return lsum * inv, optim.tree_unflatten(params,
                                                [g * inv for g in gsum])

    return one if microbatches == 1 else accumulated


def make_train_step(cfg: ModelConfig, run: RunConfig,
                    optimizer: optim.Optimizer, *,
                    microbatches: int = 1,
                    axis_name: Optional[str] = None) -> Callable:
    """Returns step(state, batch) -> (new state, metrics).

    ``batch`` holds "tokens" and "labels" ((B, S) ints, numpy or tensors);
    they go to the params' device.  ``microbatches`` > 1 accumulates the
    gradients of that many slices of the batch (``value_and_grad``).  The
    metrics are 0-dim tensors, except the compression ratio of ``pca_ef``
    (a float, known from the shapes).
    """
    if axis_name is not None:
        raise NotImplementedError(
            f"axis_name={axis_name!r}: the port trains in one process; "
            f"data-parallel steps wait for sharding (ROADMAP.md)")
    if run.gradient_compression not in GRADIENT_COMPRESSION:
        raise ValueError(f"gradient_compression "
                         f"{run.gradient_compression!r} not in "
                         f"{GRADIENT_COMPRESSION}")
    compute_grads = value_and_grad(cfg, run, microbatches)

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        loss, grads = compute_grads(state.params, batch)
        metrics = {"loss": loss}
        gc_state = state.gc
        if run.gradient_compression == "pca_ef":
            grads, gc_state, gc_stats = grad_compress.compress_update(
                grads, gc_state)
            metrics["grad_compression"] = gc_stats["compression"]
        elif run.gradient_compression == "gae":
            grads, gc_stats = grad_compress.gae_compress_grads(
                grads, tau=run.grad_comp_tau or 1e-3)
            metrics["grad_keep_frac"] = gc_stats["keep_frac"]
        params, opt, stats = optimizer.update(grads, _clone(state.opt),
                                              _clone(state.params))
        metrics.update(stats)
        return TrainState(params=params, opt=opt, gc=gc_state,
                          step=state.step + 1), metrics

    return step


def make_eval_step(cfg: ModelConfig, run: RunConfig) -> Callable:
    """Returns step(params, batch) -> {"loss": 0-dim tensor}, without
    gradients."""
    api = registry.get_model(cfg)

    @torch.no_grad()
    def step(params, batch):
        device = optim.tree_leaves(params)[0].device
        return {"loss": api.train_loss(params, cfg, run,
                                       _on_device(batch, device))}

    return step
