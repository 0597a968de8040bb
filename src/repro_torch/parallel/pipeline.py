"""GPipe pipeline parallelism over a mesh axis.

The layer stack is split into P stages, one per device along the ``pipe``
axis; M microbatches stream through the stages, and each tick's activations
move to the next stage through ``collectives.permute``.  The schedule is the
JAX package's GPipe: M + P - 1 ticks, bubble fraction (P-1)/(M+P-1).  In
one process a tick runs each stage that holds a microbatch, in stage order
(launches are asynchronous, so stages on distinct cards overlap); a stage
with nothing to do runs nothing, where the JAX program computes the bubble
and masks it away.

``pipeline_apply`` is generic: ``stage_fn(stage_params, x)`` is one stage
(usually a loop over that stage's slice of the layers).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.launch.mesh import Mesh, check_device_type
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import P, shard_tensor
from repro_torch.train import optim

PyTree = Any
Tensor = torch.Tensor


def pipeline_apply(stage_fn: Callable, stage_params: PyTree, x: Tensor, *,
                   mesh: Mesh, axis: str = "pipe") -> Tensor:
    """Run ``x`` through P sequential stages with a GPipe schedule.

    ``stage_params``: a tree whose leaves have a leading axis P
    (stage-major), split over ``axis`` with ``shard_tensor`` (a view on a
    repeated device).  ``x``: (M, mb, ...) microbatches.  Returns the last
    stage's (M, mb, ...) outputs, on its device.
    """
    check_device_type(mesh, x.device)
    devices = mesh.axis_devices(axis)
    n_stages, n_micro = len(devices), x.shape[0]
    leaves = optim.tree_leaves(stage_params)
    if any(leaf.shape[0] != n_stages for leaf in leaves):
        raise ValueError(f"stage_params' leading axes "
                         f"{sorted({leaf.shape[0] for leaf in leaves})} are "
                         f"not the {n_stages} stages of mesh axis {axis!r}")
    # the piece of each leaf at stage i's coordinate (every other axis at 0)
    at = [0] * len(mesh.axis_names)
    split = [shard_tensor(leaf, P(axis), mesh) for leaf in leaves]
    params = []
    for i in range(n_stages):
        at[mesh.axis_names.index(axis)] = i
        params.append(optim.tree_unflatten(
            stage_params, [s[tuple(at)][0] for s in split]))

    buf: list = [None] * n_stages
    out = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        if t < n_micro:                                # stage-0 injection
            buf[0] = x[t].to(devices[0], non_blocking=True)
        ys: list = [None] * n_stages
        for i in range(n_stages):
            if 0 <= t - i < n_micro:
                ys[i] = stage_fn(params[i], buf[i])
        if ys[-1] is not None:                         # last-stage collection
            out[t - (n_stages - 1)] = ys[-1]
        pairs = [(i, i + 1) for i in range(n_stages - 1) if ys[i] is not None]
        buf = collectives.permute(ys, pairs, devices)
    return torch.stack(out)


def gpipe_bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
