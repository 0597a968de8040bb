"""Device meshes for the LM side: a named-axis grid of devices.

As in the JAX package, a mesh is ONE process over a grid of devices (JAX's
GSPMD is one controller), with axes ``("data", "model")`` on one pod and
``("pod", "data", "model")`` across pods.  A mesh may name one device several
times: that is the counterpart of the virtual CPU devices the JAX package
forces with ``XLA_FLAGS=--xla_force_host_platform_device_count=N``, and the
only way to run several shards on one card (NCCL refuses two ranks on one
card, and gloo would take the tensors off it).  The compressor's mesh is a
1-D one over ``MESH_AXIS`` (``parallel.mesh_exec.make_compress_mesh``).

Nothing here runs at import: meshes are made by functions, which take the
visible cards unless the caller names the devices; a mesh over the CPU is
built only from devices the caller names (``["cpu"] * 4``, as the tests do).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.errors import ConfigError


def normalize_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without an index is
    the current one, as the tensors placed there report it."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        d = torch.device("cuda", torch.cuda.current_device())
    return d


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A frozen grid of devices with named axes: ``devices`` is an object
    ndarray of ``torch.device``s, one per mesh coordinate.  ``axis_names``
    and ``shape`` read as a ``jax.sharding.Mesh``'s do."""
    devices: np.ndarray
    axis_names: tuple

    def __post_init__(self):
        devs = np.asarray(self.devices, dtype=object)
        names = tuple(self.axis_names)
        if devs.ndim != len(names) or len(set(names)) != len(names):
            raise ConfigError(f"mesh axes {names} do not name the "
                              f"{devs.ndim} dims of its devices once each")
        out = np.empty(devs.shape, dtype=object)
        for idx in np.ndindex(devs.shape):
            out[idx] = normalize_device(devs[idx])
        if len({d.type for d in out.flat}) > 1:
            raise ConfigError(f"mesh mixes device types: "
                              f"{[str(d) for d in out.flat]}")
        out.flags.writeable = False
        object.__setattr__(self, "devices", out)
        object.__setattr__(self, "axis_names", names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis``, every other coordinate at 0: shard
        *i* of that axis runs on the *i*-th."""
        idx = [0] * self.devices.ndim
        idx[self.axis_names.index(axis)] = slice(None)
        return list(self.devices[tuple(idx)])


def visible_cards() -> list:
    """``cuda:0 ... cuda:{n-1}``; none without a card."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape: tuple, axes: tuple,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` over ``axes``.  Without ``devices`` it takes the
    first ``prod(shape)`` distinct visible cards (a :class:`ConfigError`
    naming both counts when there are too few); with ``devices`` it takes
    exactly that list, repeats included."""
    shape = tuple(int(n) for n in shape)
    want = math.prod(shape)
    if devices is None:
        have = visible_cards()
        if want > len(have):
            raise ConfigError(
                f"mesh {shape} wants {want} device(s) but only {len(have)} "
                f"card(s) are visible (make_mesh(devices=[...]) naming one "
                f"device several times runs several shards on it)")
        devices = have[:want]
    devices = list(devices)
    if len(devices) != want:
        raise ConfigError(f"mesh {shape} wants {want} device(s) but was "
                          f"given {len(devices)}")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), tuple(axes))


def make_host_mesh(model: int = 1,
                   devices: Optional[Sequence] = None) -> Mesh:
    """Every visible card (or ``devices``) as ``(n // model, model)`` over
    ``("data", "model")``."""
    devices = visible_cards() if devices is None else list(devices)
    n = len(devices)
    if n == 0 or model < 1 or n % model:
        raise ConfigError(f"host mesh: {n} device(s) do not split into a "
                          f"model axis of {model}")
    return make_mesh((n // model, model), ("data", "model"), devices)


def make_production_mesh(multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """(16, 16) ``("data", "model")`` = 256 devices, or (2, 16, 16)
    ``("pod", "data", "model")`` = 512 across two pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def dp_size(mesh: Mesh) -> int:
    return mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)


def tp_size(mesh: Mesh) -> int:
    return mesh.shape.get("model", 1)


def check_device_type(mesh: Mesh, device) -> None:
    """Raise :class:`ConfigError` unless every device of ``mesh`` is of
    ``device``'s type: nothing moves between the card and the CPU."""
    want = torch.device(device).type
    other = sorted({str(d) for d in mesh.devices.flat if d.type != want})
    if other:
        raise ConfigError(f"mesh devices {other} are not of the tensors' "
                          f"device type {want!r}")


def bound_axis(mesh: Optional[Mesh], axis_name: str) -> list:
    """The devices of the shards along ``axis_name``; a ``NameError``
    without a mesh that has that axis, as JAX raises for an axis name used
    outside ``shard_map``."""
    if mesh is None or axis_name not in mesh.axis_names:
        raise NameError(f"unbound axis name: {axis_name}")
    return mesh.axis_devices(axis_name)


def shard_grid(mesh: Mesh) -> np.ndarray:
    """The mesh's coordinates as a (data shards, model shards) grid: row
    *r* is the *r*-th data shard over ``("pod", "data")`` in that order
    (the batch's split, ``sharding.batch_spec``), column *s* its *s*-th
    ``"model"`` shard; each entry is a coordinate of ``mesh.devices``.
    The mesh's other axes must have one device."""
    other = {a: n for a, n in mesh.shape.items()
             if a not in ("pod", "data", "model") and n != 1}
    if other:
        raise NotImplementedError(
            f"mesh axes {other}: LM steps take a mesh whose only axes of "
            f"more than one device are 'pod', 'data' and 'model'")
    names = mesh.axis_names
    order = ([names.index(a) for a in ("pod", "data", "model")
              if a in names]
             + [i for i, a in enumerate(names)
                if a not in ("pod", "data", "model")])
    coords = np.empty(mesh.devices.shape, dtype=object)
    for c in np.ndindex(mesh.devices.shape):
        coords[c] = c
    return coords.transpose(order).reshape(dp_size(mesh), tp_size(mesh))


def data_devices(mesh: Mesh) -> list:
    """The devices of the data-parallel shards: each row of
    ``shard_grid``'s first device (with one model shard, its only one)."""
    return [mesh.devices[c] for c in shard_grid(mesh)[:, 0]]


def model_devices(mesh: Mesh, row: int = 0) -> list:
    """The devices of data shard ``row``'s model shards, in model order."""
    return [mesh.devices[c] for c in shard_grid(mesh)[row]]
