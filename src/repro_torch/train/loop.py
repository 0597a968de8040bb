"""LM training loop, in PyTorch: the train step with gradient-accumulation
microbatching and optional compressed gradients (the paper's technique on the
gradients).

``make_train_step`` builds the step for any arch.  On CUDA the forward runs
through the flash_attention or ssd_scan kernel (inside their
``torch.autograd.Function``s, whose backward is the plain formula); on the
CPU through their plain versions.

The step is functional, as the JAX step is without donation: it returns a
new ``TrainState`` and leaves the one it was given untouched, so a runner
that drops a step (``ResilientRunner``'s ``skip`` policy) keeps the old
state.  The optimizer updates copies of the params and moments in place.

Data parallelism runs in one process over a mesh of devices
(``launch/mesh.py``), in the JAX package's two modes:

* **GSPMD** (``mesh`` with a ``"data"`` axis, no ``axis_name``), JAX's
  jitted step with the batch sharded by ``sharding.batch_spec``: each shard
  takes its rows of the batch on its device, the gradients are
  mean-all-reduced, and the compression and AdamW run as on one device on
  each distinct device's replica of the state.  The result is the
  one-device step on the whole batch.  The moe family, whose routing is
  over the batch, is refused over more than one shard.
* **``axis_name="data"``**, JAX's step under ``shard_map``: each shard keeps
  its own ``pca_ef`` error feedback, and only the compressed coefficients
  (and the covariance on refresh steps) are all-reduced
  (``grad_compress.compress_update``).  The step takes and returns one
  ``TrainState`` per shard.

With a ``"model"`` axis above 1 (``RunConfig.tp``) the GSPMD step is also
tensor-parallel, for every family: the params, Adam's moments
and the gradients are ``sharding.Sharded`` pieces cut by
``param_partition_specs`` (``shard_train_state``), each data shard's forward
is the tensor-parallel forward over its row of the mesh
(``parallel.tensor``), and AdamW runs on each piece, clipped by the global
norm of all of them (each slice once).  Gradient compression (``pca_ef``,
``gae``) runs on the gradient pieces after the data axis's mean, as JAX's
GSPMD step runs it on the whole gradient (``grad_compress``): the error
buffers are pieces cut as the params, the basis one per device.  A
one-device ``TrainState`` handed to it is placed first, by the step's
``shardings`` (a ``TrainState`` of specs, JAX's ``in_shardings``; by
default ``sharding.train_state_specs``'s tensor-parallel ones); a
checkpoint of its state holds the whole arrays.

FSDP (``shardings`` from ``train_state_specs(..., fsdp=True)``, the dry
run's placement) cuts the large leaves over the ``"data"`` axis too, at
any model axis, ``(2, 1)`` included: each data row gathers a cut leaf's
tensor-parallel piece at use and its gradient is reduce-scattered over the
data shards as the backward produces it (``parallel.fsdp``); the rest of
the step is the tensor-parallel one.  Gradient compression and the moe
family over more than one data shard are refused there (``check_fsdp``).
"""
from __future__ import annotations

import weakref
from fractions import Fraction
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.exec import resolve_device
from repro_torch.launch.mesh import (Mesh, bound_axis, check_device_type,
                                     data_devices, dp_size, shard_grid,
                                     tp_size)
from repro_torch.models import registry
from repro_torch.models.transformer import cast_params
from repro_torch.parallel import collectives, fsdp, sharding
from repro_torch.parallel.sharding import Sharded
from repro_torch.parallel.tensor import Shards
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
    default) in ``run.param_dtype``, the optimizer's state (Adam's moments
    in float32 whatever the params' dtype, as in JAX) and, for ``pca_ef``,
    the compression state."""
    device = resolve_device(device)
    params = registry.init_params(cfg, run, generator, device)
    if run.param_dtype != "float32":
        params = cast_params(params, run.param_dtype)
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
    microbatches' losses and gradients.

    With ``run.cast_params_early`` and a compute dtype other than the
    params', the params are cast to the compute dtype inside the loss (as
    JAX's ``loss_fn``): the gradients are taken through the cast, in the
    params' dtype."""
    api = registry.get_model(cfg)
    early = run.cast_params_early and run.compute_dtype != run.param_dtype

    def one(params: PyTree, batch: dict) -> tuple[Tensor, PyTree]:
        leaves = [p.detach().requires_grad_() for p in
                  optim.tree_leaves(params)]
        tree = optim.tree_unflatten(params, leaves)
        if early:
            tree = cast_params(tree, run.compute_dtype)
        loss = api.train_loss(tree, cfg, run,
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
                    axis_name: Optional[str] = None,
                    mesh: Optional[Mesh] = None,
                    shardings: Optional[TrainState] = None) -> Callable:
    """Returns step(state, batch) -> (new state, metrics).

    ``batch`` holds "tokens" and "labels" ((B, S) ints, numpy or tensors);
    they go to the params' device.  ``microbatches`` > 1 accumulates the
    gradients of that many slices of the batch (``value_and_grad``).  The
    metrics are 0-dim tensors, except the compression ratio of ``pca_ef``
    (a float, known from the shapes).

    With ``mesh`` the step is data-parallel (module docstring): without
    ``axis_name`` the GSPMD step, whose state lives on the mesh's first
    device; with ``axis_name`` the ``shard_map`` step over that axis,
    ``step(states, batch) -> (states, metrics)`` with one state and one
    metrics dict per shard (``per_shard_states`` makes them).  JAX's step
    reduces nothing under ``axis_name`` for ``none`` and ``gae``, so its
    replicas drift apart: those two are refused there (the GSPMD mode
    covers them).  ``axis_name`` without a mesh that has the axis is a
    ``NameError``, as in JAX.

    ``shardings`` (a ``TrainState`` of specs, JAX's ``in_shardings``) places
    the state over ``mesh``; by default the tensor-parallel specs of
    ``sharding.train_state_specs``.  With a model axis above 1, or
    specs that cut over the ``"data"`` axis (FSDP), the step is the
    sharded one: a whole state handed to it is placed by ``shardings``,
    and a sharded state of another placement is refused (``ValueError``).
    """
    if run.gradient_compression not in GRADIENT_COMPRESSION:
        raise ValueError(f"gradient_compression "
                         f"{run.gradient_compression!r} not in "
                         f"{GRADIENT_COMPRESSION}")
    if axis_name is not None:
        devices = bound_axis(mesh, axis_name)
        if tp_size(mesh) > 1:
            raise NotImplementedError(
                f"axis_name={axis_name!r} over a mesh with a model axis of "
                f"{tp_size(mesh)}: the JAX package has no shard_map step "
                f"over a model axis (ROADMAP.md §1); train tensor-parallel "
                f"in the GSPMD mode, make_train_step(mesh=...) without "
                f"axis_name")
        if run.gradient_compression != "pca_ef":
            raise ValueError(
                f"gradient_compression {run.gradient_compression!r} under "
                f"axis_name={axis_name!r} reduces nothing across the shards, "
                f"so their params drift apart (ROADMAP.md §3, divergence 9): "
                f"train it in the GSPMD mode, make_train_step(mesh=...) "
                f"without axis_name")
        return _shard_map_step(cfg, run, optimizer, microbatches, mesh,
                               axis_name, devices)
    if shardings is not None and mesh is None:
        raise ValueError("shardings place the state over a mesh: pass "
                         "mesh= too")
    cut = shardings is not None and fsdp.cuts_data(shardings, mesh)
    if mesh is not None and (tp_size(mesh) > 1 or cut):
        _check_tensor_parallel(cfg, run, mesh)
        if cut:
            check_fsdp(cfg, run, mesh)
        return _tensor_parallel_step(cfg, run, optimizer, microbatches, mesh,
                                     shardings)
    compute_grads = value_and_grad(cfg, run, microbatches)
    apply = _apply_grads(run, optimizer)
    if mesh is not None:
        return _gspmd_step(cfg, run, compute_grads, apply, microbatches, mesh)

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        return apply(state, *compute_grads(state.params, batch))

    return step


def _apply_grads(run: RunConfig, optimizer: optim.Optimizer) -> Callable:
    """``apply(state, loss, grads) -> (new state, metrics)``: the
    gradient compression, then ``_update``."""
    def apply(state: TrainState, loss: Tensor, grads: PyTree
              ) -> tuple[TrainState, dict]:
        metrics = {"loss": loss}
        grads, gc_state = _compress(run, state.gc, grads, metrics)
        return _update(optimizer, state, grads, gc_state, metrics)

    return apply


def _compress(run: RunConfig, gc_state, grads: PyTree, metrics: dict
              ) -> tuple[PyTree, Any]:
    """The step's gradient compression: (the gradients the optimizer
    takes, the new compression state), its stat added to ``metrics``.
    A tree of ``Sharded`` pieces is compressed on its pieces."""
    if run.gradient_compression == "pca_ef":
        grads, gc_state, gc_stats = grad_compress.compress_update(
            grads, gc_state)
        metrics["grad_compression"] = gc_stats["compression"]
    elif run.gradient_compression == "gae":
        grads, gc_stats = grad_compress.gae_compress_grads(
            grads, tau=run.grad_comp_tau or 1e-3)
        metrics["grad_keep_frac"] = gc_stats["keep_frac"]
    return grads, gc_state


def _update(optimizer: optim.Optimizer, state: TrainState, grads: PyTree,
            gc_state, metrics: dict) -> tuple[TrainState, dict]:
    """The optimizer with ``grads`` on copies of ``state``'s params and
    moments: the new state, whose compression state is ``gc_state``, and
    ``metrics`` with the optimizer's stats added."""
    params, opt, stats = optimizer.update(grads, _clone(state.opt),
                                          _clone(state.params))
    metrics.update(stats)
    return TrainState(params=params, opt=opt, gc=gc_state,
                      step=state.step + 1), metrics


def _rows(batch: dict, lo: int, hi: int) -> dict:
    return {k: v[lo:hi] for k, v in batch.items()}


def _label_counts(cfg: ModelConfig, labels, n: int) -> list:
    """The counted labels (ids in [0, vocab), the train loss's mask) of
    each of ``n`` equal row blocks of ``labels``."""
    lab = torch.as_tensor(labels).reshape(n, -1)
    return ((lab >= 0) & (lab < cfg.vocab)).sum(dim=1).tolist()


def _tree_to(tree: PyTree, device: torch.device) -> PyTree:
    """A copy of ``tree`` on ``device`` (containers rebuilt)."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_to(x, device) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(x, device) for x in tree)
    return tree.to(device, non_blocking=True) \
        if isinstance(tree, Tensor) else tree


def _shard_batches(cfg: ModelConfig, batch: dict, dp: int,
                   microbatches: int) -> list:
    """Data shard *s*'s ``[(rows, weight)]``, one a microbatch: global
    microbatch *i* (rows ``i*b/m ...``, as ``value_and_grad`` cuts them) is
    split over the ``dp`` shards, and shard *s* weighs its part by
    ``dp * c_is / (m * C_i)`` (``c_is`` its counted labels, ``C_i`` the
    microbatch's), so the mean over shards is the global loss and its
    gradient even where padding labels fall unevenly (the weight is 1 where
    they do not)."""
    b = len(batch["tokens"])
    if b % (dp * microbatches):
        raise ValueError(f"batch {b} does not split into {microbatches} "
                         f"microbatches over {dp} data shards")
    mb, part = b // microbatches, b // (microbatches * dp)
    counts = _label_counts(cfg, batch["labels"], microbatches * dp)
    out = []
    for s in range(dp):
        pieces = []
        for i in range(microbatches):
            c = counts[i * dp:(i + 1) * dp]
            w = float(Fraction(dp * c[s], microbatches * sum(c))) \
                if sum(c) else 0.0
            lo = i * mb + s * part
            pieces.append((_rows(batch, lo, lo + part), w))
        out.append(pieces)
    return out


def _weighted_sum(one: Callable, params, pieces: list,
                  weigh: Optional[Callable] = None) -> tuple:
    """``(w * loss, *w * grads)`` of ``one(params, batch) -> (loss, list
    of grads)`` summed over the (batch, w) ``pieces``; one piece of weight
    1 is ``one``'s result as it is.  ``weigh(w)`` is told each piece's
    weight before it runs (FSDP's cut gradients, which leave ``one`` by
    another road, take it there)."""
    loss, acc = None, None
    for batch, w in pieces:
        if weigh is not None:
            weigh(w)
        l, leaves = one(params, batch)
        if w != 1.0:
            l = l * w
            leaves = [x.to(torch.float32) * w for x in leaves]
        if acc is None:
            loss, acc = l, leaves
        else:
            loss = loss + l
            acc = [a + x.to(torch.float32) for a, x in zip(acc, leaves)]
        del leaves
    return (loss, *acc)


def _refuse_moe_over_data_shards(cfg: ModelConfig, dp: int) -> None:
    if dp > 1 and cfg.family == "moe":
        raise ValueError(
            f"{cfg.arch}: the moe family routes each data shard's tokens "
            f"apart, with expert capacities of the shard's batch, where "
            f"JAX's GSPMD step routes the whole batch (ROADMAP.md §3, "
            f"divergence 10): train it over one data shard")


def data_parallel_value_and_grad(cfg: ModelConfig, run: RunConfig,
                                 mesh: Mesh, microbatches: int = 1
                                 ) -> Callable:
    """``fn(params_on, batch) -> {device: (loss, grads)}``: the loss and
    gradient of the whole batch, computed data-parallel over ``mesh``'s
    ``("pod", "data")`` shards, on each distinct device of them.
    ``params_on`` maps each such device to its replica of the params (one
    tree will do where the shards share one device).

    The batch is split and weighed by ``_shard_batches``; one mean
    all-reduce carries the loss and every gradient leaf
    (``collectives.LOG`` records it).  A mesh with a model axis above 1
    takes ``tensor_parallel_value_and_grad``.

    The moe family is refused over more than one shard: its routing caps
    each expert's tokens by the batch it is given, so a shard's routing is
    not the whole batch's, which JAX's GSPMD step routes (ROADMAP.md §3,
    divergence 10)."""
    if tp_size(mesh) > 1:
        raise ValueError(f"a model axis of {tp_size(mesh)}: the gradient "
                         f"is tensor_parallel_value_and_grad's")
    devices = data_devices(mesh)
    dp = len(devices)
    _refuse_moe_over_data_shards(cfg, dp)
    vg = value_and_grad(cfg, run)

    def one(params, batch):
        loss, g = vg(params, batch)
        return loss, optim.tree_leaves(g)

    def fn(params_on, batch: dict) -> dict:
        if not isinstance(params_on, dict) or not all(
                isinstance(k, torch.device) for k in params_on):
            params_on = {dev: params_on for dev in devices}
        shards = [_weighted_sum(one, params_on[dev], pieces) for dev, pieces
                  in zip(devices, _shard_batches(cfg, batch, dp,
                                                 microbatches))]
        reduced = dict(zip(devices, collectives.all_reduce(shards, "mean",
                                                           devices)))
        del shards
        return {dev: (loss, optim.tree_unflatten(params_on[dev], leaves))
                for dev, (loss, *leaves) in reduced.items()}

    return fn


def _gspmd_step(cfg: ModelConfig, run: RunConfig, compute_grads: Callable,
                apply: Callable, microbatches: int, mesh: Mesh) -> Callable:
    """JAX's jitted step over ``mesh`` with the batch sharded over
    ``("pod", "data")``: the gradients of ``data_parallel_value_and_grad``,
    then ``apply`` on each distinct device's replica of the state.
    Replicas on devices other than the first are kept from one step to the
    next (and made again when the step is handed another state).  One data
    shard is the one-device step."""
    devices = data_devices(mesh)
    home = devices[0]
    grads_on = data_parallel_value_and_grad(cfg, run, mesh, microbatches)
    kept: dict = {}

    def replicas(state: TrainState) -> dict:
        leaf = optim.tree_leaves(state.params)[0]
        if kept.get("of") is not None and kept["of"]() is leaf:
            return {home: state, **kept["replicas"]}
        out = {home: state}
        for dev in devices:
            if dev not in out:
                out[dev] = _tree_to(state, dev)
        return out

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        check_device_type(mesh, optim.tree_leaves(state.params)[0].device)
        if len(devices) == 1:
            return apply(state, *compute_grads(state.params, batch))
        _check_home(state, home)
        reps = replicas(state)
        reduced = grads_on({dev: rep.params for dev, rep in reps.items()},
                           batch)
        new, metrics = {}, None
        for dev, rep in reps.items():
            new[dev], m = apply(rep, *reduced.pop(dev))
            metrics = m if metrics is None else metrics
        first = new.pop(home)
        kept.clear()
        if new:
            kept.update(of=weakref.ref(optim.tree_leaves(first.params)[0]),
                        replicas=new)
        return first, metrics

    return step


def _check_home(state: TrainState, home: torch.device) -> None:
    at = optim.tree_leaves(state.params)[0].device
    if at != home:
        raise ValueError(f"the state lies on {at}, not on the mesh's first "
                         f"data shard's device {home}")


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

def _check_tensor_parallel(cfg: ModelConfig, run: RunConfig,
                           mesh: Mesh) -> None:
    n = tp_size(mesh)
    if run.tp != n:
        raise ValueError(f"RunConfig.tp={run.tp} but the mesh's model axis "
                         f"has {n} shards: the params are padded for "
                         f"RunConfig.tp (heads, vocab), so the two must "
                         f"agree")
    check_tensor_parallel(cfg, run)


def check_tensor_parallel(cfg: ModelConfig, run: RunConfig) -> None:
    """Raise ``NotImplementedError`` for what ``run.tp`` > 1 does not
    train: a family without tensor parallelism
    (``registry.check_tensor_parallel``; every family has it)."""
    registry.check_tensor_parallel(cfg, run.tp)


def check_fsdp(cfg: ModelConfig, run: RunConfig, mesh: Mesh) -> None:
    """Raise for what a placement that cuts leaves over the ``"data"`` axis
    (FSDP) does not train: gradient compression (``NotImplementedError``:
    ``grad_compress._fill_rows`` takes every data row to hold the same
    pieces, which FSDP breaks) and the moe family over more than one data
    shard (``ValueError``, ROADMAP.md §3 divergence 10)."""
    if run.gradient_compression != "none":
        raise NotImplementedError(
            f"gradient_compression {run.gradient_compression!r} with params "
            f"cut over the 'data' axis (FSDP): grad_compress._fill_rows "
            f"takes every data row to hold the same pieces, which FSDP "
            f"breaks (ROADMAP.md §1)")
    _refuse_moe_over_data_shards(cfg, dp_size(mesh))


def is_sharded(tree) -> bool:
    """Whether ``tree`` holds ``Sharded`` pieces."""
    return bool(sharding.sharded_leaves(tree))


def shard_train_state(state: TrainState, mesh: Mesh,
                      specs: Optional[TrainState] = None) -> TrainState:
    """``state`` (one device's, as ``init_train_state`` or a checkpoint's
    ``restore`` gives it) placed over ``mesh`` by ``specs`` (a
    ``TrainState`` of specs; by default ``sharding.train_state_specs``'s
    tensor-parallel ones): its params, each of the optimizer's
    param-shaped trees and the compression's error buffers as ``Sharded``
    pieces, the compression's basis replicated (one per device), the step
    counters on the mesh's first device."""
    if specs is None:
        specs = sharding.train_state_specs(state, mesh)
    return sharding.place_tree(state, specs, mesh)


def model_shards(params, mesh: Mesh, row: int = 0) -> Shards:
    """The params of data shard ``row``'s model shards (a tree of
    ``Sharded`` pieces cut to each shard's tree; a leaf cut over
    ``"data"`` gathered at use, ``fsdp.row_trees``), as the model code
    takes them: ``models.transformer.forward(model_shards(...), ...)``."""
    grid = shard_grid(mesh)
    return Shards(fsdp.row_trees(params, mesh, row), None,
                  [mesh.devices[c] for c in grid[row]])


def unshard_train_state(state: TrainState) -> TrainState:
    """A sharded state's whole tensors, each on its first piece's
    device."""
    opt = state.opt
    gc = state.gc
    if gc is not None:
        gc = gc._replace(**{f: sharding.unshard_params(getattr(gc, f))
                            for f in ("basis", "error")})
    return state._replace(
        params=sharding.unshard_params(state.params),
        opt=type(opt)(*(sharding.unshard_params(f) for f in opt)), gc=gc)


def tensor_parallel_value_and_grad(cfg: ModelConfig, run: RunConfig,
                                   mesh: Mesh, microbatches: int = 1
                                   ) -> Callable:
    """``fn(params, batch) -> (loss, grads)`` over a mesh with a
    ``"model"`` axis: ``params`` and ``grads`` are trees of ``Sharded``
    pieces (``shard_train_state``), each gradient piece on its param
    piece's device; the loss lies on the mesh's first device.

    Data shard *r* (row *r* of ``mesh.shard_grid``) takes its rows of the
    batch, weighed as ``data_parallel_value_and_grad`` weighs them, and
    runs the tensor-parallel ``train_loss`` over its model shards.  A
    replicated leaf that the row's shards hold as one tensor gets the sum
    of every shard's part from autograd; where they hold distinct copies
    (distinct devices) those parts are summed over the model axis
    (``collectives.all_reduce``).  Then the mean over the data shards, one
    all-reduce for each model shard of the gradients it holds that no
    earlier model shard's reduction holds (a replicated leaf that the
    rows' shards share is reduced once).  A leaf cut over ``"data"``
    (FSDP) is gathered at use, and its gradient summed into each data
    shard's cut as each row's backward produces it, then averaged: the
    data axis's reduce-scatter (``fsdp.CutGrads``).  The moe family is
    refused over more than one data shard (ROADMAP.md §3, divergence
    10)."""
    _check_tensor_parallel(cfg, run, mesh)
    grid = shard_grid(mesh)
    dp, n = grid.shape
    _refuse_moe_over_data_shards(cfg, dp)
    api = registry.get_model(cfg)
    early = run.cast_params_early and run.compute_dtype != run.param_dtype

    def row_objects(leaves: list, r: int) -> list:
        """For each leaf, the tensor each model shard of row ``r`` holds."""
        return [[sh.pieces[grid[r, s]] for s in range(n)] for sh in leaves]

    def row_devices(r: int) -> list:
        return [mesh.devices[c] for c in grid[r]]

    def one_row(r: int, params, leaves: list, cuts: fsdp.CutGrads):
        held = row_objects(leaves, r)
        devs = row_devices(r)

        def one(_params, batch: dict) -> tuple[Tensor, list]:
            own: dict = {}
            for objs in held:
                for p in objs:
                    if id(p) not in own:
                        own[id(p)] = p.detach().requires_grad_()
            trees = fsdp.row_trees(params, mesh, r, own=own, grads=cuts)
            if early:
                trees = [cast_params(t, run.compute_dtype) for t in trees]
            loss = api.train_loss(Shards(trees, None, devs), cfg, run,
                                  _on_device(batch, devs[0]))
            keys = list(own)
            anchors = cuts.take_anchors()
            # a copy that its shard does not read (whisper's b_out beyond
            # shard 0) has a part of 0; the anchors' parts are 0 (the cut
            # leaves' gradients went to ``cuts``)
            got = {k: torch.zeros_like(own[k]) if g is None else g
                   for k, g in zip(keys, torch.autograd.grad(
                       loss, [own[k] for k in keys] + anchors,
                       allow_unused=True))}
            del own, trees, anchors
            out = []
            for sh, objs in zip(leaves, held):
                # distinct copies of one slice in the row: their parts
                # summed over the model axis
                by_slice: dict = {}
                for s, p in enumerate(objs):
                    by_slice.setdefault(sh.slice_key(grid[r, s]), {})[
                        id(p)] = s
                for ids in by_slice.values():
                    if len(ids) > 1:
                        summed = collectives.all_reduce(
                            [got[i] for i in ids], "sum",
                            [devs[s] for s in ids.values()])
                        got.update(zip(ids, summed))
                out.extend(got[id(p)] for p in objs)
            return loss.detach(), out
        return one

    def fn(params, batch: dict) -> tuple[Tensor, Any]:
        every = sharding.sharded_leaves(params)
        # the leaves cut over "data" go through ``cuts``; the others here
        leaves = [sh for sh in every if fsdp.cut_dim(sh) is None]
        batches = _shard_batches(cfg, batch, dp, microbatches)
        cuts = fsdp.CutGrads(every, float32=microbatches > 1 or any(
            w != 1.0 for pieces in batches for _, w in pieces))
        rows = [_weighted_sum(one_row(r, params, leaves, cuts), None, pieces,
                              weigh=cuts.weigh)
                for r, pieces in enumerate(batches)]
        # rows[r] = (loss, grad of leaf l at shard s for l, s): one mean
        # all-reduce over the data shards for each model shard, of the
        # leaves whose rows' gradients no earlier shard's holds (the same
        # objects lie on the same devices: one result serves both)
        nl = len(leaves)
        at: dict = {}                 # rows' gradient ids -> (shard, index)
        reduced = []
        for s in range(n):
            mine = []
            for l in range(nl):
                key = tuple(id(row[1 + l * n + s]) for row in rows)
                if key not in at:
                    at[key] = (s, len(mine))
                    mine.append(l)
            parts = [tuple(row[1 + l * n + s] for l in mine)
                     + ((row[0],) if s == 0 else ())
                     for row in rows]
            reduced.append(collectives.all_reduce(
                parts, "mean", [row_devices(r)[s] for r in range(dp)])
                if parts[0] else None)
        loss = reduced[0][0][-1]
        grads = {}
        for l, sh in enumerate(leaves):
            pieces = np.empty(sh.pieces.shape, dtype=object)
            for s in range(n):
                s0, j = at[tuple(id(row[1 + l * n + s]) for row in rows)]
                for r in range(dp):
                    pieces[grid[r, s]] = reduced[s0][r][j]
            grads[id(sh)] = Sharded(pieces, sh.spec, sh.mesh)
        del rows
        grads.update(cuts.mean())
        return loss, sharding.map_sharded(lambda sh: grads[id(sh)], params)

    return fn


def _tensor_parallel_step(cfg: ModelConfig, run: RunConfig,
                          optimizer: optim.Optimizer, microbatches: int,
                          mesh: Mesh,
                          shardings: Optional[TrainState] = None) -> Callable:
    """The GSPMD step over a mesh with a ``"model"`` axis or with leaves
    cut over ``"data"`` (module docstring): the state placed by
    ``shardings`` (a sharded state of another placement refused), the
    gradient pieces of ``tensor_parallel_value_and_grad``, compressed on
    their pieces (``_compress``), their global norm over each slice once (a
    sharded leaf's pieces, a replicated leaf once), then the optimizer on
    copies of each device's pieces, clipped by that norm."""
    grads_of = tensor_parallel_value_and_grad(cfg, run, mesh, microbatches)
    home = mesh.devices.flat[0]
    kept = {"specs": shardings}

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        if kept["specs"] is None:
            kept["specs"] = sharding.train_state_specs(state, mesh)
        if not is_sharded(state.params):
            state = shard_train_state(state, mesh, kept["specs"])
        else:
            _check_placement(state.params, kept["specs"].params, mesh)
        loss, grads = grads_of(state.params, batch)
        metrics = {"loss": loss}
        grads, gc_state = _compress(run, state.gc, grads, metrics)
        opt = state.opt
        # the params and the optimizer's trees, copied (the step is
        # functional) and updated in place
        trees = [sharding.map_sharded(lambda sh: sh.map(torch.clone), t)
                 for t in (state.params, *opt[1:])]
        groups: dict = {}         # device -> [pieces of each tree], grads
        first: dict = {}          # device -> the gradients it holds first
        seen: set = set()
        for leaf in zip(*(sharding.sharded_leaves(t) for t in trees),
                        sharding.sharded_leaves(grads)):
            for coord, _ in leaf[0].owners():
                dev = mesh.devices[coord]
                g = groups.setdefault(dev, [[] for _ in leaf])
                for lst, sh in zip(g, leaf):
                    lst.append(sh.pieces[coord])
                key = (id(leaf[0]), leaf[0].slice_key(coord))
                if key not in seen:
                    seen.add(key)
                    first.setdefault(dev, []).append(leaf[-1].pieces[coord])
        norm = optim.global_norm_of_groups(
            [first[d] for d in sorted(first, key=lambda d: d != home)])
        new_step = None
        for dev, lists in groups.items():
            _, st, stats = optimizer.update(
                lists[-1], type(opt)(opt.step.to(dev), *lists[1:-1]),
                lists[0], norm=norm.to(dev))
            if dev == home:
                new_step = st.step
                metrics.update(stats)
        return TrainState(params=trees[0],
                          opt=type(opt)(new_step, *trees[1:]), gc=gc_state,
                          step=state.step + 1), metrics

    return step


def _check_placement(params, specs, mesh: Mesh) -> None:
    """A ``ValueError`` naming both placements where a sharded ``params``
    tree is not cut by ``specs`` over ``mesh``."""
    def at(path: str):
        node = specs
        for k in path.split("/"):
            node = node[k]
        return sharding.P(*node)

    def same_mesh(m: Mesh) -> bool:
        return m is mesh or (m.axis_names == mesh.axis_names
                             and m.devices.shape == mesh.devices.shape
                             and bool(np.all(m.devices == mesh.devices)))

    def check(path: str, sh: Sharded) -> Sharded:
        want = at(path)
        if sh.spec != want or not same_mesh(sh.mesh):
            raise ValueError(
                f"the state is placed otherwise than the step's shardings: "
                f"{path} is cut {tuple(sh.spec)} over mesh {sh.mesh.shape}, "
                f"where the shardings cut it {tuple(want)} over mesh "
                f"{mesh.shape}; hand the step a whole state, or restore it "
                f"with CheckpointManager.restore(mesh=, shardings=)")
        return sh
    sharding.map_sharded(check, params, with_path=True)


def per_shard_states(state: TrainState, mesh: Mesh,
                     axis_name: str = "data") -> list:
    """One ``TrainState`` per shard along ``axis_name`` for the
    ``shard_map`` step, from a replicated ``state`` on the first shard's
    device: the params, moments and step once per distinct device (shards
    on one device share them), the compression state copied for every
    shard (each its own error feedback)."""
    devices = bound_axis(mesh, axis_name)
    _check_home(state, devices[0])
    on: dict = {}
    out = []
    for dev in devices:
        if dev not in on:
            on[dev] = state if not on else _tree_to(state, dev)
        out.append(on[dev]._replace(gc=_clone(on[dev].gc)))
    return out


def _shard_map_step(cfg: ModelConfig, run: RunConfig,
                    optimizer: optim.Optimizer, microbatches: int, mesh: Mesh,
                    axis_name: str, devices: list) -> Callable:
    """JAX's ``shard_map(make_train_step(..., axis_name))`` for ``pca_ef``:
    shard *s* takes rows ``s*b/n ...`` of the batch (its own microbatches
    within them), the compressed all-reduce runs in ``compress_update``,
    and each shard's optimizer update runs once for the shards that share
    its params and moments (the approx gradient is the same on every
    shard)."""
    compute_grads = value_and_grad(cfg, run, microbatches)
    n = len(devices)

    def step(states: Sequence[TrainState], batch: dict
             ) -> tuple[list, list]:
        if len(states) != n:
            raise ValueError(f"{len(states)} states for the {n} shards of "
                             f"axis {axis_name!r}")
        b = len(batch["tokens"])
        if b % n:
            raise ValueError(f"batch {b} does not split over {n} shards")
        part = b // n
        losses, grads = [], []
        for s, st in enumerate(states):
            check_device_type(mesh, optim.tree_leaves(st.params)[0].device)
            out = compute_grads(st.params,
                                _rows(batch, s * part, (s + 1) * part))
            losses.append(out[0])
            grads.append(out[1])
            del out            # the gradients live in ``grads`` alone
        ghat, gcs, gc_stats = grad_compress.compress_update(
            grads, [st.gc for st in states], axis_name=axis_name, mesh=mesh)
        del grads
        done: dict = {}
        new_states, metrics = [], []
        for s, st in enumerate(states):
            key = (id(st.params), id(st.opt))
            if key not in done:
                done[key] = _update(optimizer, st, ghat[s], gcs[s], {})
            new, stats = done[key]
            new_states.append(new._replace(gc=gcs[s]))
            metrics.append({"loss": losses[s],
                            "grad_compression": gc_stats["compression"],
                            **stats})
        return new_states, metrics

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
