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
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.gae import fit_pca_basis, gae_select
from repro_torch.core.quantization import dequantize, quantize
from repro_torch.launch.mesh import bound_axis
from repro_torch.parallel import collectives
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


def _covariance(flat_g: list, flat_e: list, block: int, device) -> Tensor:
    """The block covariance of (grad + error) over every leaf."""
    cov = torch.zeros((block, block), dtype=torch.float32, device=device)
    for g, e in zip(flat_g, flat_e):
        hb = _blocked(g.to(torch.float32) + e, block)
        cov = cov + hb.T @ hb
    return cov


def _top_eigvecs(cov: Tensor, rank: int) -> Tensor:
    _, vecs = torch.linalg.eigh(cov)                      # ascending
    return torch.flip(vecs, dims=[1])[:, :rank].contiguous()


def _project(g: Tensor, e: Tensor, basis: Tensor, bin_size: float
             ) -> tuple[Tensor, Tensor, Tensor]:
    """One leaf's (coefficients, local reconstruction, new error): the
    error feedback is taken against the local reconstruction, before any
    aggregation."""
    h = g.to(torch.float32) + e
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
    which reduces nothing.
    """
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
        covs = [_covariance(flat_g[s], flat_e[s], block, bases[s].device)
                for s in range(n)]
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
            cq, recon, e_new = _project(flat_g[s][j], flat_e[s][j], bases[s],
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
    kept = None            # float32 sum of every block's M, on the device
    exact = None           # blocks kept exact
    total = np.float32(0.0)

    def leaf(g: Tensor) -> Tensor:
        nonlocal kept, exact, total
        gb = _blocked(g, block).contiguous()
        sel = gae_select(gb, fit_pca_basis(gb).contiguous(), tau, bin_size)
        bad = sel.err > tau
        out = torch.where(bad[:, None], gb, sel.corrected)
        m = torch.where(bad, block, sel.m).sum().to(torch.float32)
        n_bad = bad.sum()
        kept = m if kept is None else kept + m
        exact = n_bad if exact is None else exact + n_bad
        total = np.float32(total + np.float32(gb.numel()))
        return _unblocked(out, g.shape, g.dtype)

    out = optim.tree_map(leaf, grads)
    if kept is None:
        kept = exact = torch.zeros(())
    return out, {"kept_coeffs": kept, "exact_blocks": exact,
                 "total_elems": float(total),
                 "keep_frac": kept / float(max(total, np.float32(1.0)))}
