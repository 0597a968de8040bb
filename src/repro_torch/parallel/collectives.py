"""Collectives of the one-process mesh, their accounting, and the
distributed-PCA covariance reduction.

The mesh is one process over a grid of devices (``launch/mesh.py``), so a
collective is a function of every shard's piece at once: ``pieces[i]`` is
shard *i*'s tensor, on its device.  Between distinct devices the
collectives copy (``non_blocking``); for a device that repeats they copy
nothing, and shards on one device share the result.  Sums run in shard
order on the first shard's device.

Every call is recorded in the module's :class:`CollectiveLog` ``LOG``,
whose ``summary()`` is the dict
``collective_bytes`` returns for an HLO module, by the JAX package's
convention: each op's RESULT bytes on one device, all-reduce in = out,
all-gather the gathered view, reduce-scatter one shard's piece.  A
``permute`` counts the bytes it sends (each source's piece once per pair),
so the bubble of a pipeline costs nothing.  A collective over one shard is
no collective and is not recorded.

The collectives are differentiable: their sums, copies, slices and
concatenations are autograd's ops, so a backward through them runs the
transposed transfers (a copy back, a sum of the uses of a shared result).
Those backward transfers are autograd's and are not recorded.

``collective_bytes`` is the JAX package's HLO parser, copied.
"""
from __future__ import annotations

import re
import threading
from collections import defaultdict
from typing import Optional, Sequence

import torch

Tensor = torch.Tensor

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
}

# e.g.  f32[256,1024]{1,0} or bf16[8,128] (layout braces optional)
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
# an HLO instruction line:  %name = <shape-or-tuple> op-name(...)
_INSTR_RE = re.compile(
    r"=\s*(\([^)]*\)|[a-z0-9]+\[[0-9,]*\][^\s]*)\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(-start|-done)?\(")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collective_bytes(hlo_text: str) -> dict:
    """Sum output-shape bytes per collective kind across an HLO module.

    Uses each op's RESULT shape (for all-reduce in == out; for all-gather the
    result is the global view).  ``-done`` ops are skipped so async pairs are
    not double-counted.
    """
    out: dict[str, int] = defaultdict(int)
    counts: dict[str, int] = defaultdict(int)
    for m in _INSTR_RE.finditer(hlo_text):
        shape_str, kind, phase = m.group(1), m.group(2), m.group(3)
        if phase == "-done":
            continue
        out[kind] += _shape_bytes(shape_str)
        counts[kind] += 1
    return {"bytes": dict(out), "counts": dict(counts),
            "total_bytes": sum(out.values())}


# ---------------------------------------------------------------------------
# the log
# ---------------------------------------------------------------------------

class CollectiveLog:
    """Bytes and counts of the collectives run, per kind; thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._bytes: dict = defaultdict(int)
        self._counts: dict = defaultdict(int)

    def record(self, kind: str, n_bytes: int) -> None:
        with self._lock:
            self._bytes[kind] += int(n_bytes)
            self._counts[kind] += 1

    def reset(self) -> None:
        with self._lock:
            self._bytes.clear()
            self._counts.clear()

    def summary(self) -> dict:
        """As ``collective_bytes`` returns it."""
        with self._lock:
            return {"bytes": dict(self._bytes), "counts": dict(self._counts),
                    "total_bytes": sum(self._bytes.values())}


LOG = CollectiveLog()


def _nbytes(t: Tensor) -> int:
    return t.numel() * t.element_size()


def _parts(piece) -> list:
    """A piece is a tensor or a list/tuple of tensors (one op over a
    tuple, as XLA combines them)."""
    return list(piece) if isinstance(piece, (list, tuple)) else [piece]


def _like(piece, parts: list):
    return type(piece)(parts) if isinstance(piece, (list, tuple)) else parts[0]


def _device(piece) -> torch.device:
    return _parts(piece)[0].device


def _to(t: Tensor, device: torch.device) -> Tensor:
    return t if t.device == device else t.to(device, non_blocking=True)


def all_reduce(pieces: Sequence, op: str = "sum",
               devices: Optional[Sequence] = None) -> list:
    """Shard *i*'s result of the sum (or mean, or elementwise max) of every
    shard's piece.

    ``devices`` (the mesh's devices of the shards; default: each piece's
    own) say where each result goes; a repeated device gets one result,
    shared by its shards.  The sum runs in shard order on the first
    shard's device; the mean divides it by the number of shards.
    """
    if op not in ("sum", "mean", "max"):
        raise ValueError(f"all_reduce op {op!r} not in ('sum', 'mean', "
                         f"'max')")
    n = len(pieces)
    if devices is None:
        devices = [_device(p) for p in pieces]
    if n == 1:
        return list(pieces)
    home = devices[0]
    parts = [_parts(p) for p in pieces]
    total = []
    for j in range(len(parts[0])):       # leaf by leaf: one sum alive
        if op == "max":
            acc = _to(parts[0][j], home)
            for other in parts[1:]:
                acc = torch.maximum(acc, _to(other[j], home))
        else:
            acc = _to(parts[0][j], home) + _to(parts[1][j], home)
            for other in parts[2:]:
                acc.add_(_to(other[j], home))
            if op == "mean":
                acc.div_(n)
        total.append(acc)
    LOG.record("all-reduce", sum(_nbytes(a) for a in total))
    out: dict = {}
    for dev in devices:
        if dev not in out:
            out[dev] = _like(pieces[0], [_to(a, dev) for a in total])
    return [out[dev] for dev in devices]


def all_gather(pieces: Sequence[Tensor], dim: int = 0,
               devices: Optional[Sequence] = None) -> list:
    """Every shard's piece concatenated along ``dim`` in shard order, for
    each shard on its device (one result per distinct device)."""
    if devices is None:
        devices = [p.device for p in pieces]
    if len(pieces) == 1:
        return list(pieces)
    out: dict = {}
    for dev in devices:
        if dev not in out:
            out[dev] = torch.cat([_to(p, dev) for p in pieces], dim=dim)
    LOG.record("all-gather", _nbytes(out[devices[0]]))
    return [out[dev] for dev in devices]


def reduce_scatter(pieces: Sequence[Tensor], dim: int,
                   devices: Optional[Sequence] = None) -> list:
    """Shard *i*'s slice *i* along ``dim`` of the sum of every shard's
    piece, on its device: the sum runs in shard order on the first shard's
    device, and ``dim`` must split into as many slices as there are
    shards.  Logged as one shard's slice, the result bytes of JAX's
    per-device reduce-scatter."""
    n = len(pieces)
    if devices is None:
        devices = [p.device for p in pieces]
    if n == 1:
        return list(pieces)
    size = pieces[0].shape[dim]
    if size % n:
        raise ValueError(f"reduce_scatter: dim {dim} of "
                         f"{tuple(pieces[0].shape)} does not split into "
                         f"{n} shards")
    home = devices[0]
    acc = _to(pieces[0], home) + _to(pieces[1], home)
    for other in pieces[2:]:
        acc.add_(_to(other, home))
    c = size // n
    # copies, not views: a view would keep the whole sum alive
    out = [acc.narrow(dim, i * c, c).to(dev, non_blocking=True, copy=True)
           for i, dev in enumerate(devices)]
    LOG.record("reduce-scatter", _nbytes(out[0]))
    return out


def scatter_add(sums: Sequence[Tensor], part: Tensor, dim: int) -> None:
    """One input of a reduce-scatter whose inputs arrive one at a time (an
    FSDP-cut leaf's gradient from each data row's backward, as autograd
    produces it): slice *i* of ``part`` along ``dim`` added into
    ``sums[i]`` on its device.  Nothing is logged; ``scattered`` logs the
    op once its inputs are in."""
    c = part.shape[dim] // len(sums)
    for i, acc in enumerate(sums):
        acc.add_(_to(part.narrow(dim, i * c, c), acc.device))


def scattered(sums: Sequence[Tensor], n: int, op: str = "sum") -> list:
    """The end of a reduce-scatter of ``n`` inputs that ``scatter_add``
    summed into ``sums`` (each shard's slice, on its device): the sums, or
    for ``"mean"`` the sums divided by ``n`` in place, logged as one
    reduce-scatter of one shard's slice, as ``reduce_scatter`` logs it."""
    if op not in ("sum", "mean"):
        raise ValueError(f"scattered op {op!r} not in ('sum', 'mean')")
    if op == "mean":
        for acc in sums:
            acc.div_(n)
    if n > 1:
        LOG.record("reduce-scatter", _nbytes(sums[0]))
    return list(sums)


def permute(pieces: Sequence, pairs: Sequence[tuple],
            devices: Sequence) -> list:
    """``out[dst]`` = shard ``src``'s piece on ``devices[dst]``, for each
    ``(src, dst)`` of ``pairs``; ``None`` where no pair sends.  A piece
    that stays on its device is not copied."""
    out: list = [None] * len(devices)
    sent = 0
    for src, dst in pairs:
        out[dst] = _to(pieces[src], devices[dst])
        sent += _nbytes(pieces[src])
    if pairs:
        LOG.record("collective-permute", sent)
    return out


# ---------------------------------------------------------------------------
# distributed PCA covariance (GAE at scale)
# ---------------------------------------------------------------------------

def distributed_covariance(local_residuals: Sequence[Tensor]) -> Tensor:
    """C = sum_i r_i^T r_i over the shards' residuals (each on its device):
    each shard's fp32 ``r^T r`` on its device, every one dispatched before
    any is read, summed in shard order on the first shard's device — O(D^2)
    communication, independent of the number of residual rows."""
    partials = []
    for r in local_residuals:
        r = r.to(torch.float32)
        partials.append(r.T @ r)
    cov = partials[0]
    for part in partials[1:]:
        cov = cov + _to(part, cov.device)
    if len(partials) > 1:
        LOG.record("all-reduce", _nbytes(cov))
    return cov
