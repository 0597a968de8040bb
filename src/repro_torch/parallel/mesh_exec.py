"""Mesh construction and stripe-to-shard span alignment for the sharded
compress path.

The paper's hyper-block design makes archive chunks independently codable,
so the hyper-block axis is a pure data axis and the stage functions of
``core/exec.py`` scale past one device by giving each device its own
stripes.  As in the JAX package, the mesh is ONE process over a mesh of
devices; this module owns its three concerns:

* **Mesh construction** (``make_compress_mesh`` / ``resolve_mesh``): a 1-D
  ``launch.mesh.Mesh`` over the hyper-block data axis ``MESH_AXIS``
  (``"hb"``).  It carries ``axis_names`` and ``shape`` as a
  ``jax.sharding.Mesh`` does, so ``CompressOptions`` validates either the
  same way.
* **Stripe-to-shard span alignment** (``plan_shard_groups``): the stripe IS
  the archive chunk, so alignment is a span-planning problem, not a format
  change.  Consecutive equal-width stripes are grouped ``n_shards`` at a
  time; shard *i* of a group runs exactly one stripe on ``devices[i]``.
  Per-shard shapes therefore equal the single-device per-stripe shapes, so
  the kernels, their launches and their bits are the unsharded path's and
  the sharded archive is byte-identical to the single-device one.  Ragged
  tails (the last short stripe, or a final group of fewer than ``n_shards``
  stripes) take the per-stripe single-device path.
* **Host-local entropy fan-out**: shard boundaries coincide with stripe
  boundaries, so every chunk's GAE and entropy coding consumes only rows
  its own shard produced.

The PCA basis fit scales over the same axis: ``fit_pca_basis_sharded`` has
each shard compute its local D x D covariance on its device and sums the
partials in shard order, the counterpart of the JAX package's ``psum``
(zero-padded rows add exactly nothing to ``r^T r``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import exec as exec_mod
from repro_torch.core import gae
from repro_torch.core.errors import ConfigError
from repro_torch.core.options import MESH_AXIS
from repro_torch.launch.mesh import Mesh, check_device_type, make_mesh
from repro_torch.parallel import collectives

Span = tuple  # (hb_start, n_hyperblocks)

# ---------------------------------------------------------------------------
# mesh construction
# ---------------------------------------------------------------------------

def available_devices() -> list:
    """The distinct devices present: ``cuda:0 ... cuda:{n-1}`` when a card
    is present, else the one CPU."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_compress_mesh(n_shards: Optional[int] = None,
                       devices: Optional[Sequence] = None) -> Mesh:
    """The compressor's mesh: a 1-D ``launch.mesh.Mesh`` over the
    hyper-block data axis ``MESH_AXIS``; shard *i* runs on
    ``mesh.devices[i]``.

    Without ``devices`` it takes the first ``n_shards`` distinct devices of
    ``available_devices()`` (``None``: all of them); fewer than 1 shard, or
    more shards than devices, is a :class:`ConfigError`.

    With ``devices`` the mesh is built over exactly that sequence, which
    may name one device several times: ``["cuda:0"] * 4`` runs four shards
    on one card, and ``["cpu"] * 4`` four on the CPU.  That is the port's
    counterpart of the virtual devices the JAX package forces with
    ``XLA_FLAGS=--xla_force_host_platform_device_count=N``: the only way to
    run several shards on one card.  ``n_shards``, if given too, must equal
    ``len(devices)``.
    """
    if devices is not None:
        devices = list(devices)
        if n_shards is not None and int(n_shards) != len(devices):
            raise ConfigError(f"compress mesh wants {n_shards} shards but "
                              f"names {len(devices)} device(s)")
        want = len(devices)
    else:
        have = available_devices()
        want = len(have) if n_shards is None else int(n_shards)
        if want > len(have):
            raise ConfigError(
                f"compress mesh wants {want} shards but only {len(have)} "
                f"device(s) are present (make_compress_mesh(devices=[...]) "
                f"naming one device several times runs several shards on "
                f"it)")
        devices = have[:want]
    if want < 1:
        raise ConfigError(f"compress mesh needs >= 1 shard, got {want}")
    return make_mesh((want,), (MESH_AXIS,), devices)


def resolve_mesh(spec, device=None) -> Optional[Mesh]:
    """Resolve a ``CompressOptions.mesh`` field to the compressor's mesh.

    ``None``, ``1`` and one-shard meshes resolve to ``None`` (one device:
    the unsharded path is the byte-identity reference).  A ``Mesh`` must be
    1-D over ``MESH_AXIS``.  With ``device`` (the compressor's), a mesh of
    another device type is a :class:`ConfigError`.
    """
    if spec is None:
        return None
    if isinstance(spec, int) and not isinstance(spec, bool):
        mesh = None if spec <= 1 else make_compress_mesh(spec)
    elif isinstance(spec, Mesh) and spec.axis_names == (MESH_AXIS,):
        mesh = spec if spec.devices.size > 1 else None
    else:
        raise ConfigError(f"cannot resolve a {type(spec).__name__} into a "
                          f"compress mesh")
    if mesh is not None and device is not None:
        check_device_type(mesh, device)
    return mesh


def mesh_shards(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.devices.size


# ---------------------------------------------------------------------------
# stripe-to-shard span alignment
# ---------------------------------------------------------------------------

def plan_shard_groups(spans: Sequence[Span], n_shards: int
                      ) -> tuple[list[list[Span]], list[Span]]:
    """Align the stripe tiling to shard boundaries.

    Returns ``(groups, tail)``: ``groups`` is a list of span groups, each
    exactly ``n_shards`` consecutive spans of EQUAL width (one stripe per
    shard — the alignment invariant the byte-identity guarantee rests on);
    ``tail`` is every remaining span (ragged width or an incomplete final
    group), to be run through the per-stripe single-device path.

    The function is a pure reindexing of the pipeline's ``stripe_spans``
    tiling: it never changes chunk boundaries, so archives produced with
    and without a mesh have identical section tables.
    """
    if n_shards < 1:
        raise ConfigError(f"plan_shard_groups needs n_shards >= 1, "
                          f"got {n_shards}")
    spans = list(spans)
    if n_shards == 1:
        return [], spans
    groups: list[list[Span]] = []
    i = 0
    while i + n_shards <= len(spans):
        cand = spans[i:i + n_shards]
        if len({int(w) for _, w in cand}) != 1:
            break
        groups.append(cand)
        i += n_shards
    return groups, spans[i:]


def group_slice(group: Sequence[Span]) -> tuple[int, int]:
    """A shard group covers one CONTIGUOUS hyper-block range (spans are
    consecutive by construction): returns ``(start, stop)``."""
    start = int(group[0][0])
    stop = int(group[-1][0] + group[-1][1])
    return start, stop


# ---------------------------------------------------------------------------
# sharded PCA basis fit (the psum of the covariance)
# ---------------------------------------------------------------------------

def fit_pca_basis_sharded(residuals: np.ndarray,
                          mesh: Mesh) -> np.ndarray:
    """PCA basis of ``(N, D)`` residuals over the mesh.

    Rows are zero-padded to an even split (zero rows add nothing to
    ``r^T r``); shard *i* computes its rows' fp32 covariance on
    ``mesh.devices[i]``, every shard is dispatched before any partial is
    read, and the D x D partials are summed in shard order on
    ``mesh.devices[0]`` by ``collectives.distributed_covariance`` — O(D^2)
    traffic whatever N.  The basis comes from
    the same ``gae.basis_from_covariance`` the single-device fit runs.  The
    sum's order differs from one ``r^T r``, so the basis agrees with the
    single-device one up to column sign and rounding, not bit for bit.
    """
    n_shards = mesh_shards(mesh)
    r = np.asarray(residuals, np.float32)
    n, d = r.shape
    pad = (-n) % n_shards
    if pad:
        r = np.concatenate([r, np.zeros((pad, d), np.float32)], axis=0)
    rows = r.shape[0] // n_shards
    with exec_mod.stage("fit_basis_sharded", r.size), torch.inference_mode():
        cov = collectives.distributed_covariance(
            exec_mod.upload(r[i * rows:(i + 1) * rows], dev)
            for i, dev in enumerate(mesh.devices))
        return gae.basis_from_covariance(cov).cpu().numpy()
