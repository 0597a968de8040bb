"""Gradient compression, in PyTorch: the paper's GAE insight applied to the
gradients of a training step.

The GAE mechanism (project onto a shared orthonormal basis, keep the leading
coefficients, quantize, and error-feed the tail) is *linear*, so coefficients
aggregate exactly across data-parallel workers:

    mean_i(U^T g_i) = U^T mean_i(g_i).

Without ``axis_name`` the arithmetic is the JAX package's single-worker
reference semantics.  With ``axis_name`` (an axis of a ``launch.mesh.Mesh``)
every shard along that axis is a worker with its own error feedback, and
only the rank-M coefficients (and, on refresh steps, one block x block
covariance) are mean-all-reduced (``parallel.collectives.all_reduce``): that
reduction IS the compressed all-reduce.  The mesh is one process, so the
function takes every shard's gradients and state at once.

Shapes: every leaf of the gradient tree (all float32, as the port's params
are) is flattened and blocked into ``block``-length vectors (zero-padded);
the coefficient tensor per leaf is (n_blocks, rank).  Compression payload
ratio ~ rank/block.

Two modes:
  * ``pca_ef``  — rank-M, optionally quantized, with per-leaf **error
    feedback** and the **adaptive basis refresh**: every ``refresh_every``
    steps the basis is recomputed as the top-``rank`` eigenvectors of the
    block covariance of (grad + error), so persistent gradient structure
    enters the span and the error buffer stays bounded.
  * ``gae``     — tau-driven per-block M through the one-shot GAE selection
    ``core.gae.gae_select`` (the gae_project and quantize kernels on CUDA);
    the realized per-block l2 distortion of the gradient is <= tau (checked
    per block; a block the fp32 selection misses is kept exact).

Leaves are visited in ``train.optim.tree_leaves`` order (sorted dict keys, as
``jax.tree.flatten`` visits them), so the covariance sums run in the JAX
package's order.  The basis of a fresh state comes from a seeded
``torch.Generator``, not from ``jax.random``: tests carry the JAX basis
across.

Under tensor parallelism the gradient is a tree of ``sharding.Sharded``
pieces over a mesh with a ``"model"`` axis, and both modes compute the
function of the whole gradient that JAX's GSPMD step computes, on each row
of model shards (``_pieces_of_row``).  A piece whose blocks are whole-leaf
blocks (``blocks_inside_pieces``) is compressed where it lies; a leaf no
dim splits once per device; any other leaf is all-gathered into the whole
leaf (``collectives.all_gather``, logged), compressed once per device,
and each shard keeps its cut.  The covariances of the split pieces are
summed over the model axis by one all-reduce (``pca_ef``: one (block,
block) on refresh steps; ``gae``: the stacked per-leaf covariances), and
each slice of every leaf enters a covariance and the stats once.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.gae import (basis_from_covariance, covariance,
                                  fit_pca_basis, gae_select)
from repro_torch.core.quantization import dequantize, quantize
from repro_torch.launch.mesh import bound_axis, shard_grid
from repro_torch.parallel import collectives, sharding
from repro_torch.parallel.sharding import Sharded
from repro_torch.train import optim

Tensor = torch.Tensor
PyTree = Any


class GradCompressionState(NamedTuple):
    basis: Tensor         # (block, rank) shared orthonormal basis
    error: PyTree         # per-leaf error-feedback buffers (leaf-shaped, f32)
    step: Tensor          # 0-dim int32


def make_basis(block: int, rank: int, seed: int = 17, device=None) -> Tensor:
    """Deterministic orthonormal (block, rank) basis from the seed alone: QR
    of a Gaussian drawn on the CPU, moved to ``device``."""
    gen = torch.Generator().manual_seed(seed)
    g = torch.randn(block, max(rank, 1), generator=gen)
    q, _ = torch.linalg.qr(g)
    return q[:, :rank].contiguous().to(device)


def init_state(params: PyTree, *, block: int = 256, rank: int = 32,
               seed: int = 17) -> GradCompressionState:
    leaves = optim.tree_leaves(params)
    device = leaves[0].device if leaves else None
    error = optim.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)
    return GradCompressionState(
        basis=make_basis(block, rank, seed, device), error=error,
        step=torch.zeros((), dtype=torch.int32, device=device))


def _blocked(x: Tensor, block: int) -> Tensor:
    flat = x.to(torch.float32).reshape(-1)
    pad = -flat.numel() % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, block)


def _unblocked(blocks: Tensor, shape, dtype) -> Tensor:
    n = math.prod(shape)
    return blocks.reshape(-1)[:n].reshape(shape).to(dtype)


def _covariance(hs, block: int, device) -> Tensor:
    """The block covariance of the tensors ``hs`` together: (grad + error)
    of every leaf, or of every piece a shard holds."""
    cov = torch.zeros((block, block), dtype=torch.float32, device=device)
    for h in hs:
        hb = _blocked(h, block)
        cov = cov + hb.T @ hb
    return cov


def _top_eigvecs(cov: Tensor, rank: int) -> Tensor:
    _, vecs = torch.linalg.eigh(cov)                      # ascending
    return torch.flip(vecs, dims=[1])[:, :rank].contiguous()


def _project(h: Tensor, basis: Tensor, bin_size: float
             ) -> tuple[Tensor, Tensor, Tensor]:
    """The (coefficients, local reconstruction, new error) of one leaf's
    (or one piece's) grad + error ``h``: the error feedback is taken
    against the local reconstruction, before any aggregation."""
    hb = _blocked(h, basis.shape[0])                      # (nb, block)
    c = hb @ basis                                         # (nb, rank)
    cq = dequantize(quantize(c, bin_size), bin_size) if bin_size > 0 else c
    recon = cq @ basis.T
    return cq, recon, _unblocked(hb - recon, h.shape, torch.float32)


def _stats(comm_elems, raw_elems, block: int, refresh_every: int) -> dict:
    if refresh_every:   # amortized covariance all-reduce of the refresh
        comm_elems = np.float32(comm_elems + np.float32(block * block
                                                        / refresh_every))
    return {"comm_elems": float(comm_elems), "raw_elems": float(raw_elems),
            "compression": float(raw_elems / max(comm_elems,
                                                 np.float32(1.0)))}


def compress_update(grads, state, *, bin_size: float = 0.0,
                    axis_name: Optional[str] = None, mesh=None,
                    refresh_every: int = 50):
    """Rank-M compressed gradients with error feedback and adaptive basis
    refresh (module docstring).

    Returns (approx gradient, new state, stats); ``state`` is not changed.
    The refresh step is read from ``state.step`` on the host: the covariance
    is only built on the steps that use it.

    With ``axis_name``, ``mesh`` must have that axis (else ``NameError``,
    as JAX's ``pmean`` outside ``shard_map``), and ``grads`` and ``state``
    are sequences with one entry per shard along it, each on its shard's
    device; the approx gradients and new states come back as lists.  The
    shards' covariances (refresh steps) and coefficients are mean-reduced
    through ``collectives.all_reduce`` (recorded in ``collectives.LOG``).
    Without ``axis_name`` the one worker is that function's one-shard case,
    which reduces nothing; a gradient of ``Sharded`` pieces (tensor
    parallelism, module docstring) is compressed on its pieces, with the
    state ``loop.shard_train_state`` gives it.
    """
    if sharding.sharded_leaves(grads):
        if axis_name is not None:
            raise ValueError(f"axis_name={axis_name!r} with a gradient of "
                             f"Sharded pieces: tensor parallelism is the "
                             f"GSPMD step's")
        return _compress_update_pieces(grads, state, bin_size=bin_size,
                                       refresh_every=refresh_every)
    if axis_name is not None:
        return _compress_update_shards(
            list(grads), list(state), bound_axis(mesh, axis_name),
            bin_size=bin_size, refresh_every=refresh_every)
    new_g, new_state, stats = _compress_update_shards(
        [grads], [state], [state.basis.device], bin_size=bin_size,
        refresh_every=refresh_every)
    return new_g[0], new_state[0], stats


def _compress_update_shards(grads: list, states: list, devices: list, *,
                            bin_size: float, refresh_every: int):
    """``compress_update`` over ``len(devices)`` shards: shard *i*'s
    gradients, error feedback and local reconstruction on ``devices[i]``;
    the covariance (refresh steps) and each leaf's coefficients
    mean-all-reduced.  Shards on one device share the reduced tensors, so
    the basis and the approx gradient are computed once a device.  One
    shard reduces nothing: its local reconstruction is the approx
    gradient."""
    n = len(devices)
    if len(grads) != n or len(states) != n:
        raise ValueError(f"{len(grads)} gradient trees and {len(states)} "
                         f"states for {n} shards")
    block, rank = states[0].basis.shape
    flat_g = [optim.tree_leaves(g) for g in grads]
    flat_e = [optim.tree_leaves(st.error) for st in states]

    def once_a_device(fn, reduced: list) -> list:
        """``fn(s, x)`` for the first shard ``s`` holding each reduced
        tensor ``x``, shared by the shards that hold it too."""
        done: dict = {}
        for s, x in enumerate(reduced):
            if id(x) not in done:
                done[id(x)] = fn(s, x)
        return [done[id(x)] for x in reduced]

    bases = [st.basis for st in states]
    if refresh_every and int(states[0].step) % refresh_every == 0:
        covs = [_covariance((g.to(torch.float32) + e for g, e in
                             zip(flat_g[s], flat_e[s])), block,
                            bases[s].device) for s in range(n)]
        covs = collectives.all_reduce(covs, "mean", devices)
        bases = once_a_device(lambda s, c: _top_eigvecs(c, rank), covs)

    # the element counts in float32, as the JAX package accumulates them
    comm_elems = np.float32(0.0)
    raw_elems = np.float32(0.0)
    new_g: list = [[] for _ in range(n)]
    new_e: list = [[] for _ in range(n)]
    for j, g0 in enumerate(flat_g[0]):
        local = []
        for s in range(n):
            cq, recon, e_new = _project(
                flat_g[s][j].to(torch.float32) + flat_e[s][j], bases[s],
                bin_size)
            new_e[s].append(e_new)
            local.append(cq)
            if n > 1:
                recon = None       # made again from the reduced coefficients
        cqs = collectives.all_reduce(local, "mean", devices)
        approx = once_a_device(
            lambda s, cq: _unblocked(cq @ bases[s].T if recon is None
                                     else recon, g0.shape, g0.dtype), cqs)
        for s in range(n):
            new_g[s].append(approx[s])
        comm_elems = np.float32(comm_elems + np.float32(cqs[0].numel()))
        raw_elems = np.float32(raw_elems + np.float32(g0.numel()))
    new_states = [GradCompressionState(
        basis=bases[s], error=optim.tree_unflatten(states[s].error, new_e[s]),
        step=states[s].step + 1) for s in range(n)]
    return ([optim.tree_unflatten(grads[s], new_g[s]) for s in range(n)],
            new_states, _stats(comm_elems, raw_elems, block, refresh_every))


# ---------------------------------------------------------------------------
# tau-driven GAE mode (bounded per-block distortion)
# ---------------------------------------------------------------------------

def gae_compress_grads(grads: PyTree, *, tau: float, bin_size: float = 1e-4,
                       block: int = 256) -> tuple[PyTree, dict]:
    """Per-block guaranteed ||g - g^G||_2 <= tau using the paper's one-shot
    selection (Algorithm 1, batched form), with each leaf's own PCA basis.
    Returns (bounded grads, stats).

    The selection picks M from err^2(M) = ||c||^2 - sum_{k<=M} c_k^2 + ...
    in fp32, which cancels where a block's norm is far above tau (an
    embedding row's gradient against tau 1e-3): there the realized error
    can pass tau, in the JAX package too (ROADMAP.md §3, divergence 7).  So
    the realized error ``sel.err`` is checked on the device, and a block
    past tau is kept exact (counted as ``block`` coefficients), as
    ``save_compressed`` keeps an incompressible tensor raw: the bound holds
    for every block."""
    if sharding.sharded_leaves(grads):
        return _gae_compress_pieces(grads, tau=tau, bin_size=bin_size,
                                    block=block)
    kept = None            # float32 sum of every block's M, on the device
    exact = None           # blocks kept exact
    total = np.float32(0.0)

    def leaf(g: Tensor) -> Tensor:
        nonlocal kept, exact, total
        gb = _blocked(g, block).contiguous()
        out, m, n_bad = _bounded_blocks(gb, fit_pca_basis(gb), tau, bin_size)
        kept = m if kept is None else kept + m
        exact = n_bad if exact is None else exact + n_bad
        total = np.float32(total + np.float32(gb.numel()))
        return _unblocked(out, g.shape, g.dtype)

    out = optim.tree_map(leaf, grads)
    return out, _gae_stats(kept, exact, total)


def _bounded_blocks(gb: Tensor, basis: Tensor, tau: float, bin_size: float
                    ) -> tuple[Tensor, Tensor, Tensor]:
    """The blocks ``gb`` (nb, block) after the GAE selection on ``basis``,
    a block whose realized error passes ``tau`` kept exact; the float32
    sum of the blocks' M (``block`` for one kept exact) and the number
    kept exact, both on the device."""
    sel = gae_select(gb, basis.contiguous(), tau, bin_size)
    bad = sel.err > tau
    out = torch.where(bad[:, None], gb, sel.corrected)
    m = torch.where(bad, gb.shape[1], sel.m).sum().to(torch.float32)
    return out, m, bad.sum()


def _gae_stats(kept, exact, total) -> dict:
    if kept is None:
        kept = exact = torch.zeros(())
    return {"kept_coeffs": kept, "exact_blocks": exact,
            "total_elems": float(total),
            "keep_frac": kept / float(max(total, np.float32(1.0)))}


# ---------------------------------------------------------------------------
# tensor parallelism: both modes on the pieces of a model-split gradient
# ---------------------------------------------------------------------------

def piece_run(leaf: Sharded) -> Optional[int]:
    """The length of the contiguous runs of the whole leaf's row-major
    flattening that each piece of ``leaf`` holds: the product of a
    piece's extents from its (last) split dim on; ``None`` where no dim
    is split (each piece is the whole leaf)."""
    dims = leaf.split_dims()
    if not dims:
        return None
    return math.prod(leaf.pieces.flat[0].shape[dims[-1]:])


def blocks_inside_pieces(leaf: Sharded, block: int = 256) -> bool:
    """Whether every ``block``-long block of the whole leaf (``_blocked``'s
    row-major cut, the last one zero-padded) lies inside one piece of
    ``leaf``, as cut by its spec.  It does where ``block`` divides the
    piece's run (``piece_run``): each run then starts at a multiple of it,
    so a piece's own ``reshape(-1, block)`` is a subset of the whole
    leaf's blocks, with no padding.  True for a leaf no dim splits."""
    run = piece_run(leaf)
    return run is None or run % block == 0


def _leaf_kind(leaf: Sharded, block: int) -> str:
    """"whole" (no dim split), "piece" (``blocks_inside_pieces``) or
    "gather" (the blocks straddle the pieces)."""
    dims = leaf.split_dims()
    if not dims:
        return "whole"
    if blocks_inside_pieces(leaf, block):
        return "piece"
    if len(dims) > 1:
        raise NotImplementedError(f"a leaf split over dims {dims} whose "
                                  f"blocks straddle its pieces")
    return "gather"


def _rows_to_run(leaves: list) -> list:
    """The rows of model shards (``shard_grid``) whose pieces the
    compression has to run on: a row whose every piece an earlier row
    holds (the same objects: rows on the same devices) takes that row's
    results (``_fill_rows``)."""
    grid = shard_grid(leaves[0].mesh)
    rows, seen = [], set()
    for r in range(grid.shape[0]):
        row = [tuple(c) for c in grid[r]]
        ids = {id(sh.pieces[c]) for sh in leaves for c in row}
        if not ids <= seen:
            rows.append(row)
            seen |= ids
    return rows


def _pieces_of_row(kind: str, g: Sharded, e: Optional[Sharded], row: list,
                   devs: list) -> list:
    """Leaf ``g``'s work on one row of model shards: ``[(h, shards)]``,
    each distinct tensor to compress (grad + error ``e``, in float32) and
    the shards that take its result.  A "whole" leaf gives one per
    distinct piece, a "piece" leaf one per shard, a "gather" leaf the
    whole leaf once per distinct device (one all-gather; each shard then
    takes its cut).  Every entry of a "piece" leaf enters the row's
    covariance and the stats, only the first of any other leaf."""
    def h_at(s):
        x = g.pieces[row[s]].to(torch.float32)
        return x if e is None else x + e.pieces[row[s]]

    by: dict = {}
    if kind == "gather":
        wholes = collectives.all_gather([h_at(s) for s in range(len(row))],
                                        g.split_dims()[0], devs)
        for s, x in enumerate(wholes):
            by.setdefault(id(x), (x, []))[1].append(s)
    else:
        for s, c in enumerate(row):
            p = g.pieces[c]
            if id(p) not in by:
                by[id(p)] = (h_at(s), [])
            by[id(p)][1].append(s)
    return list(by.values())


def _scatter(kind: str, leaf: Sharded, x: Tensor, shards: list, row: list,
             out: np.ndarray, done: dict, tag: int) -> None:
    """Give each of ``shards`` its result from the unit's result ``x``:
    ``x`` itself, or its cut of the whole leaf (a tensor of its own) for
    a "gather" leaf; an input piece already done keeps its first
    result."""
    for s in shards:
        c = row[s]
        if kind == "gather":
            dim = leaf.split_dims()[0]
            n = leaf.pieces[c].shape[dim]
            piece = x.narrow(dim, s * n, n).clone()
        else:
            piece = x
        out[c] = done.setdefault((tag, id(leaf.pieces[c])), piece)


def _fill_rows(leaf: Sharded, out: np.ndarray, done: dict, tag: int) -> None:
    """The results at the coordinates of rows that were not run, from
    the row that holds the same pieces."""
    for c in np.ndindex(out.shape):
        if out[c] is None:
            out[c] = done[(tag, id(leaf.pieces[c]))]


def _whole_blocks(leaf: Sharded, block: int) -> int:
    return -(-math.prod(leaf.shape) // block)


def _compress_update_pieces(grads, state: GradCompressionState, *,
                            bin_size: float, refresh_every: int):
    """``compress_update`` of a gradient of ``Sharded`` pieces (module
    docstring): the one-device function of the whole gradient.  On a
    refresh step the shards' covariances (each slice once) are summed by
    one all-reduce over each row's model shards and the basis comes from
    ``eigh`` once a device; the projection runs on each unit of
    ``_pieces_of_row``.  The new error buffers are pieces cut as the
    gradient's, the basis a ``Sharded`` replicated over the mesh.  The
    stats count whole leaves, as one device's."""
    g_leaves = sharding.sharded_leaves(grads)
    e_leaves = sharding.sharded_leaves(state.error)
    mesh = g_leaves[0].mesh
    bases = state.basis
    block, rank = bases.pieces.flat[0].shape
    kinds = [_leaf_kind(sh, block) for sh in g_leaves]
    refresh = bool(refresh_every) and int(state.step) % refresh_every == 0
    shape = mesh.devices.shape
    new_g = [np.empty(shape, dtype=object) for _ in g_leaves]
    new_e = [np.empty(shape, dtype=object) for _ in g_leaves]
    new_basis = np.empty(shape, dtype=object)
    done: dict = {}
    for row in _rows_to_run(g_leaves):
        devs = [mesh.devices[c] for c in row]
        basis = [bases.pieces[c] for c in row]
        gathered: dict = {}
        if refresh:
            partial = [torch.zeros((block, block), dtype=torch.float32,
                                   device=d) for d in devs]
            for j, (kind, g, e) in enumerate(zip(kinds, g_leaves, e_leaves)):
                units = _pieces_of_row(kind, g, e, row, devs)
                if kind == "gather":
                    gathered[j] = units
                for i, (h, shards) in enumerate(units):
                    if kind == "piece" or i == 0:
                        s = shards[0]
                        partial[s] = partial[s] + _covariance([h], block,
                                                              devs[s])
                del units
            covs = collectives.all_reduce(partial, "sum", devs)
            del partial
            eig: dict = {}
            for c in covs:
                if id(c) not in eig:
                    eig[id(c)] = _top_eigvecs(c, rank)
            basis = [eig[id(c)] for c in covs]
            del covs, eig
        for c, dev, b in zip(row, devs, basis):
            new_basis[c] = done.setdefault(("basis", dev), b)
        for j, (kind, g, e) in enumerate(zip(kinds, g_leaves, e_leaves)):
            units = gathered.pop(j, None) or _pieces_of_row(kind, g, e, row,
                                                            devs)
            for h, shards in units:
                _, recon, e_new = _project(h, basis[shards[0]], bin_size)
                approx = _unblocked(recon, h.shape, g.pieces[row[0]].dtype)
                del recon
                _scatter(kind, g, approx, shards, row, new_g[j], done, 0)
                _scatter(kind, g, e_new, shards, row, new_e[j], done, 1)
            del units
    for j, g in enumerate(g_leaves):
        _fill_rows(g, new_g[j], done, 0)
        _fill_rows(g, new_e[j], done, 1)
    for c in np.ndindex(shape):
        if new_basis[c] is None:
            new_basis[c] = done[("basis", mesh.devices[c])]

    # the element counts in float32 over whole leaves, as one device's
    comm_elems = np.float32(0.0)
    raw_elems = np.float32(0.0)
    for g in g_leaves:
        comm_elems = np.float32(comm_elems
                                + np.float32(_whole_blocks(g, block) * rank))
        raw_elems = np.float32(raw_elems + np.float32(math.prod(g.shape)))
    by_id = {id(g): Sharded(x, g.spec, mesh) for g, x in zip(g_leaves, new_g)}
    e_by_id = {id(e): Sharded(x, e.spec, mesh)
               for e, x in zip(e_leaves, new_e)}
    return (sharding.map_sharded(lambda sh: by_id[id(sh)], grads),
            GradCompressionState(
                basis=Sharded(new_basis, bases.spec, mesh),
                error=sharding.map_sharded(lambda sh: e_by_id[id(sh)],
                                           state.error),
                step=state.step + 1),
            _stats(comm_elems, raw_elems, block, refresh_every))


def _gae_compress_pieces(grads, *, tau: float, bin_size: float, block: int):
    """``gae_compress_grads`` of a gradient of ``Sharded`` pieces (module
    docstring): each leaf's PCA basis from the covariance of the whole
    leaf's blocks — for the "piece" leaves one all-reduce over each row's
    model shards of their stacked partial covariances, ``eigh`` once a
    device and leaf — then the selection on each unit of
    ``_pieces_of_row`` (gae_project and quantize on CUDA), every block
    within ``tau``.  The stats sum each slice once."""
    leaves = sharding.sharded_leaves(grads)
    mesh = leaves[0].mesh
    home = mesh.devices.flat[0]
    kinds = [_leaf_kind(sh, block) for sh in leaves]
    split = [j for j, k in enumerate(kinds) if k == "piece"]
    shape = mesh.devices.shape
    new = [np.empty(shape, dtype=object) for _ in leaves]
    kept = exact = None
    done: dict = {}
    for r, row in enumerate(_rows_to_run(leaves)):
        devs = [mesh.devices[c] for c in row]
        covs = collectives.all_reduce(
            [torch.stack([covariance(_blocked(leaves[j].pieces[c], block))
                          for j in split]) for c in row], "sum", devs) \
            if split else None
        eig: dict = {}
        for j, (kind, g) in enumerate(zip(kinds, leaves)):
            for i, (h, shards) in enumerate(_pieces_of_row(kind, g, None, row,
                                                           devs)):
                gb = _blocked(h, block).contiguous()
                if kind == "piece":
                    cov = covs[shards[0]]
                    basis = eig.get((id(cov), j))
                    if basis is None:
                        basis = eig[(id(cov), j)] = basis_from_covariance(
                            cov[split.index(j)])
                else:
                    basis = fit_pca_basis(gb)
                out, m, n_bad = _bounded_blocks(gb, basis, tau, bin_size)
                if r == 0 and (kind == "piece" or i == 0):
                    m, n_bad = m.to(home), n_bad.to(home)
                    kept = m if kept is None else kept + m
                    exact = n_bad if exact is None else exact + n_bad
                _scatter(kind, g, _unblocked(out, h.shape,
                                             g.pieces[row[0]].dtype),
                         shards, row, new[j], done, 0)
                del out, gb
        del covs, eig
    total = np.float32(0.0)
    for j, g in enumerate(leaves):
        _fill_rows(g, new[j], done, 0)
        total = np.float32(total + np.float32(_whole_blocks(g, block)
                                              * block))
    by_id = {id(g): Sharded(x, g.spec, mesh) for g, x in zip(leaves, new)}
    return (sharding.map_sharded(lambda sh: by_id[id(sh)], grads),
            _gae_stats(kept, exact, total))
