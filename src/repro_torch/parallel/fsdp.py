"""FSDP in the one-process mesh: params, Adam's moments and gradients cut
over the mesh's ``"data"`` axis as well as its ``"model"`` axis, each data
row gathering at use the tensor-parallel piece that its model shards hold
without the cut.

The JAX package gets this from GSPMD: ``jax.jit`` of the train step with
the ``in_shardings`` of ``param_partition_specs(..., fsdp_axis="data")``
(``launch/dryrun.py``), where XLA all-gathers each weight at use and
reduce-scatters its gradient.  Here a leaf is *cut* when its spec names
``"data"`` over a data axis of more than one shard (``cut_dim``).  Data row
*r*'s model shard *s* sees a cut leaf (``row_trees``) as

* a :class:`RowView` while the leaf has a stacked-layer axis left: the data
  shards' pieces, not gathered.  ``models.common.layer`` slices it, and
  ``models.common.apply_stack`` gathers a layer's views once the slice has
  no stacked axis left (``at_use``): each dense, MoE, SSD or whisper layer,
  the hybrid's triple and tail layer, the VLM's self layer and, per group,
  its cross layer.  Under ``remat`` the gather runs inside the body that
  ``torch.utils.checkpoint`` wraps: no gathered weight is kept for the
  backward, whose recompute gathers again, as XLA's rematerialised FSDP
  does;
* a gathered tensor for a leaf outside the stacks, gathered once when the
  row's trees are made and freed with them.  The model code reads these at
  ``common.embed`` / ``tensor.embed`` and the tied head (``embed/w``:
  ``transformer._head_w``, whisper's ``_forward``; one gather serves
  both), ``transformer._head_w``, ``ssd._logits``, ``rglru._logits`` and
  the families' ``train_loss`` (an untied ``unembed/w``), whisper's
  ``_add_positions`` (``pos_embed/w``, row-split over the model axis) and
  ``transformer._vision`` (the VLM's ``vision_proj/w``).  The final norms
  are 1-D and never cut; whisper's frames come precomputed, as in the JAX
  package, so it has no conv frontend to gather.

Each gather is ``collectives.all_gather`` of the data shards' pieces onto
the row's shard's device (logged).  In a train step it is a
``torch.autograd.Function`` whose backward takes the gathered tensor's
gradient as autograd produces it and adds each data shard's cut into that
shard's running sum on its device (``collectives.scatter_add``, weighed as
the row's loss is): between rows the gradient of a cut leaf never exists
whole.  After the last row the sums are the data axis's mean, logged as
one reduce-scatter of one shard's slice for each leaf and model column
(``collectives.scattered``, :meth:`CutGrads.mean`); a cut leaf that the
model axis replicates on distinct devices then sums its copies' parts over
the model axis (one all-reduce), as the tensor-parallel step does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh, shard_grid
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import (Sharded, is_spec, map_sharded,
                                           spec_axes, stack_depth)
from repro_torch.parallel.tensor import Shards

Tensor = torch.Tensor

AXIS = "data"


def cut_dim(sh: Sharded) -> Optional[int]:
    """The dim of ``sh`` that the ``"data"`` axis cuts into more than one
    piece, or ``None``."""
    if sh.mesh.shape.get(AXIS, 1) == 1:
        return None
    dims = [d for d, e in enumerate(sh.spec) if AXIS in spec_axes((e,))]
    if not dims:
        return None
    if (len(dims) > 1 or spec_axes((sh.spec[dims[0]],)) != {AXIS}
            or sh.mesh.shape.get("pod", 1) > 1):
        raise NotImplementedError(
            f"spec {tuple(sh.spec)} over mesh {sh.mesh.shape}: FSDP cuts one "
            f"dim over the 'data' axis alone, on a mesh without a pod axis")
    return dims[0]


def cuts_data(specs, mesh: Mesh) -> bool:
    """Whether a tree of specs cuts any leaf over ``mesh``'s ``"data"``
    axis (of more than one shard)."""
    if mesh.shape.get(AXIS, 1) == 1:
        return False
    if is_spec(specs):
        return AXIS in spec_axes(getattr(specs, "spec", specs))
    if isinstance(specs, dict):
        specs = list(specs.values())
    if isinstance(specs, (list, tuple)):
        return any(cuts_data(s, mesh) for s in specs)
    return False


class RowView:
    """A data row's model shard's view of a cut leaf with ``depth``
    stacked-layer axes left: the data shards' pieces (each sliced at
    ``index`` along the stacked axes taken so far), the cut ``dim``, the
    shard's ``device``, and where the gradient goes (``grads``, a
    :class:`CutGrads`, and ``column``, the pieces' running sums; none
    outside a train step)."""

    __slots__ = ("pieces", "dim", "device", "depth", "index", "grads",
                 "column")

    def __init__(self, pieces: list, dim: int, device, depth: int,
                 index: tuple = (), grads=None, column=None):
        self.pieces, self.dim, self.device = pieces, dim, device
        self.depth, self.index = depth, index
        self.grads, self.column = grads, column

    @property
    def shape(self) -> tuple:
        """The gathered tensor's shape."""
        shape = list(self.pieces[0].shape)
        shape[self.dim] *= len(self.pieces)
        return tuple(shape)

    def __getitem__(self, i: int) -> "RowView":
        """Slice ``i`` of the leading stacked-layer axis."""
        if not self.depth:
            raise IndexError("a layer's view has no stacked axis left: "
                             "gather it (at_use)")
        return RowView([p[i] for p in self.pieces], self.dim - 1,
                       self.device, self.depth - 1, self.index + (i,),
                       self.grads, self.column)

    def gather(self) -> Tensor:
        """The tensor-parallel piece on the shard's device: one all-gather
        of the data shards' pieces, whose backward feeds ``grads``."""
        if self.grads is None or not torch.is_grad_enabled():
            return collectives.all_gather(self.pieces, self.dim,
                                          [self.device])[0]
        return _Gather.apply(self.grads.anchor(self.device), self)


class _Gather(torch.autograd.Function):
    """``RowView.gather`` in a train step.  Its input is the row's anchor on
    the shard's device (a 0-dim leaf that the step asks autograd for, so
    that this backward runs); its backward adds each data shard's cut of
    the gradient into that shard's running sum and gives the anchor 0."""

    @staticmethod
    def forward(ctx, anchor: Tensor, view: RowView) -> Tensor:
        ctx.view = view
        return collectives.all_gather(view.pieces, view.dim, [view.device])[0]

    @staticmethod
    def backward(ctx, grad: Tensor):
        view = ctx.view
        view.grads.add(view.column, view.index, grad, view.dim)
        return torch.zeros((), device=grad.device), None


def at_use(tree):
    """``tree`` (a layer slice, a ``Shards`` of them, or a tuple of a
    body's arguments) with every ``RowView`` that has no stacked axis left
    gathered; any other leaf as it is."""
    if isinstance(tree, RowView):
        return tree if tree.depth else tree.gather()
    if isinstance(tree, dict):
        return {k: at_use(v) for k, v in tree.items()}
    if isinstance(tree, Shards):
        return Shards([at_use(p) for p in tree.pieces], tree.layout,
                      tree.devices)
    if type(tree) in (list, tuple):
        return type(tree)(at_use(v) for v in tree)
    return tree


class CutGrads:
    """The gradients of a tree's cut leaves over one train step's data
    rows: a running sum for each distinct piece, on its device, in the
    piece's dtype or float32 (``float32``: where the rows are weighed or
    microbatched, as ``train.loop`` accumulates the other gradients).
    ``weight`` is the loss weight of the row running now; ``anchor`` gives
    that row a 0-dim leaf per device for its gathers."""

    def __init__(self, leaves: list, float32: bool = False):
        self.leaves = [sh for sh in leaves if cut_dim(sh) is not None]
        self.sums: dict = {}
        for sh in self.leaves:
            for _, p in sh.owners():
                self.sums[id(p)] = torch.zeros(
                    p.shape, dtype=torch.float32 if float32 else p.dtype,
                    device=p.device)
        self.weight = 1.0
        self.anchors: dict = {}

    def weigh(self, w: float) -> None:
        self.weight = w

    def anchor(self, device) -> Tensor:
        device = torch.device(device)
        if device not in self.anchors:
            self.anchors[device] = torch.zeros((), device=device,
                                               requires_grad=True)
        return self.anchors[device]

    def take_anchors(self) -> list:
        """The row's anchors, for autograd to differentiate; the next row
        makes its own."""
        out, self.anchors = list(self.anchors.values()), {}
        return out

    def column(self, sh: Sharded, s: int) -> list:
        """The running sums of model shard ``s``'s data pieces of ``sh``,
        in data order."""
        grid = shard_grid(sh.mesh)
        return [self.sums[id(sh.pieces[grid[d, s]])]
                for d in range(grid.shape[0])]

    def add(self, column: list, index: tuple, grad: Tensor, dim: int) -> None:
        if self.weight != 1.0:
            grad = grad.to(torch.float32) * self.weight
        collectives.scatter_add([acc[index] for acc in column], grad, dim)

    def mean(self) -> dict:
        """``id(leaf)`` -> the ``Sharded`` gradient of each cut leaf: the
        sums over the data rows divided by their number (one reduce-scatter
        logged per leaf and distinct model column), and the copies of one
        slice on distinct devices (a leaf the model axis replicates) summed
        over the model axis."""
        out = {}
        for sh in self.leaves:
            grid = shard_grid(sh.mesh)
            dp = grid.shape[0]
            done = set()
            for s in range(grid.shape[1]):
                key = tuple(id(sh.pieces[grid[d, s]]) for d in range(dp))
                if key not in done:
                    done.add(key)
                    collectives.scattered([self.sums[i] for i in key], dp,
                                          "mean")
            by_slice: dict = {}
            for coord, p in sh.owners():
                by_slice.setdefault(sh.slice_key(coord), []).append(
                    (coord, p))
            for group in by_slice.values():
                if len(group) > 1:
                    summed = collectives.all_reduce(
                        [self.sums[id(p)] for _, p in group], "sum",
                        [sh.mesh.devices[c] for c, _ in group])
                    for (_, p), g in zip(group, summed):
                        self.sums[id(p)] = g
            pieces = np.empty(sh.pieces.shape, dtype=object)
            for coord in np.ndindex(sh.pieces.shape):
                pieces[coord] = self.sums[id(sh.pieces[coord])]
            out[id(sh)] = Sharded(pieces, sh.spec, sh.mesh)
        return out


def row_trees(params, mesh: Mesh, row: int = 0, *, own: Optional[dict] = None,
              grads: Optional[CutGrads] = None) -> list:
    """Data row ``row``'s tree for each of its model shards, from a tree of
    ``Sharded`` leaves: an uncut leaf's piece at the shard's coordinate
    (``own[id(piece)]`` where ``own`` is given), a cut leaf as a
    ``RowView`` while it has a stacked axis, gathered onto the shard's
    device otherwise.  With ``grads`` the gathers feed their gradients into
    its sums.  (Under ``cast_params_early`` the caller casts the gathered
    tensors; a layer's views are cast by the model code at use, the same
    cast of a weight each layer reads once.)"""
    grid = shard_grid(mesh)

    def tree(s: int):
        def leaf(path: str, sh: Sharded):
            dim = cut_dim(sh)
            if dim is None:
                p = sh.pieces[grid[row, s]]
                return p if own is None else own[id(p)]
            view = RowView([sh.pieces[grid[d, s]]
                            for d in range(grid.shape[0])], dim,
                           mesh.devices[grid[row, s]], stack_depth(path),
                           grads=grads, column=None if grads is None
                           else grads.column(sh, s))
            return view if view.depth else view.gather()
        return map_sharded(leaf, params, with_path=True)

    return [tree(s) for s in range(grid.shape[1])]
