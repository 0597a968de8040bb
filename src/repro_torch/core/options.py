"""Compress configuration: ``CompressOptions``.

The fields and their validation follow the JAX package's ``core/options.py``,
so one options object means the same run in both packages.  The batch
``HierarchicalCompressor.compress`` reads ``tau`` and ``chunk_hyperblocks``
and ignores the streaming and fault-tolerance fields, as the JAX one does;
``repro_torch.stream.stream_compress`` and the launcher route on them.

The ``mesh`` field takes, as in the JAX package:

* ``None``  — one device (the default),
* ``int``   — shard over that many devices of a 1-D ``("hb",)`` mesh built
  by ``repro_torch.parallel.mesh_exec.resolve_mesh`` at run time,
* a mesh object — used as-is (``repro_torch.launch.mesh.Mesh``, made by
  ``parallel.mesh_exec.make_compress_mesh``); it must carry the hyper-block data axis ``MESH_AXIS``
  (``"hb"``) and may not shard any other axis.

Validation happens at CONSTRUCTION time and raises a typed
:class:`~repro_torch.core.errors.ConfigError`, so a zero-width chunk fails
here, in one obvious place, instead of deep inside a run.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.errors import ConfigError

#: Name of the hyper-block data axis every compress mesh must carry.  Lives
#: here (not in ``parallel.mesh_exec``) so option validation imports no
#: device code; ``mesh_exec`` re-exports it.
MESH_AXIS = "hb"


@dataclasses.dataclass(frozen=True)
class CompressOptions:
    """One frozen configuration object for a compress run.

    * ``tau`` — per-GAE-block l2 error bound; ``None`` disables the GAE
      guarantee stage entirely.
    * ``chunk_hyperblocks`` — requested stripe width (hyper-blocks per
      independently-decodable archive chunk).  The pipeline may round it UP
      for GAE block alignment; a non-positive width is a
      :class:`ConfigError` here.
    * ``stream`` — run the pipelined path (the launcher's ``--stream``).
    * ``queue_depth`` — bound of the streaming scheduler's inter-stage
      queues (backpressure).
    * ``retries``, ``stage_deadline_s``, ``chaos_seed`` — any one set arms
      the streaming retry → deadline → quarantine ladder
      (``fault_tolerant``); ``chaos_seed`` also injects seeded faults.
    * ``mesh`` — device mesh for the sharded stage path (see the module
      docstring for the accepted forms).
    """
    tau: Optional[float] = None
    chunk_hyperblocks: int = 64
    stream: bool = False
    queue_depth: int = 2
    retries: Optional[int] = None
    stage_deadline_s: Optional[float] = None
    chaos_seed: Optional[int] = None
    mesh: Optional[object] = None     # None | int | Mesh over "hb"

    def __post_init__(self):
        if not isinstance(self.chunk_hyperblocks, int) \
                or isinstance(self.chunk_hyperblocks, bool):
            raise ConfigError(
                f"chunk_hyperblocks must be an int, got "
                f"{type(self.chunk_hyperblocks).__name__}")
        if self.chunk_hyperblocks < 1:
            raise ConfigError(
                f"chunk_hyperblocks must be >= 1, got "
                f"{self.chunk_hyperblocks} (a zero-width stripe can never "
                f"tile the hyper-block axis)")
        if self.tau is not None and not self.tau > 0:
            raise ConfigError(f"tau must be > 0 (or None to disable the "
                              f"guarantee stage), got {self.tau}")
        if self.queue_depth < 1:
            raise ConfigError(f"queue_depth must be >= 1, got "
                              f"{self.queue_depth}")
        if self.retries is not None and self.retries < 0:
            raise ConfigError(f"retries must be >= 0, got {self.retries}")
        if self.stage_deadline_s is not None and not self.stage_deadline_s > 0:
            raise ConfigError(f"stage_deadline_s must be > 0, got "
                              f"{self.stage_deadline_s}")
        self._validate_mesh()

    def _validate_mesh(self) -> None:
        mesh = self.mesh
        if mesh is None:
            return
        if isinstance(mesh, bool):
            raise ConfigError("mesh must be None, an int shard count, or a "
                              "compress mesh — got a bool")
        if isinstance(mesh, int):
            if mesh < 1:
                raise ConfigError(f"mesh shard count must be >= 1, got {mesh}")
            return
        # duck-typed (axis_names/shape), as the JAX package checks its Mesh
        axis_names = getattr(mesh, "axis_names", None)
        shape = getattr(mesh, "shape", None)
        if axis_names is None or shape is None:
            raise ConfigError(
                f"mesh must be None, an int shard count, or a compress mesh, "
                f"got {type(mesh).__name__}")
        if MESH_AXIS not in axis_names:
            raise ConfigError(
                f"compress mesh is missing the hyper-block data axis "
                f"{MESH_AXIS!r} (axes: {tuple(axis_names)}) — the stage "
                f"pipeline shards over {MESH_AXIS!r} only")
        for name in axis_names:
            if name != MESH_AXIS and shape[name] != 1:
                raise ConfigError(
                    f"compress mesh axis {name!r} has size {shape[name]}; "
                    f"only the {MESH_AXIS!r} data axis may be sharded "
                    f"(size-1 auxiliary axes are fine)")

    def fault_tolerant(self) -> bool:
        """True when any fault-tolerance knob is set (retries / deadline /
        chaos) — the streaming path then arms the retry→quarantine ladder."""
        return (self.retries is not None or self.stage_deadline_s is not None
                or self.chaos_seed is not None)

    def mesh_shards(self) -> int:
        """Requested shard count WITHOUT resolving devices (0 = unsharded);
        a mesh object reports its ``hb``-axis size."""
        if self.mesh is None:
            return 0
        if isinstance(self.mesh, int):
            return self.mesh
        return int(self.mesh.shape[MESH_AXIS])

    def replace(self, **changes) -> "CompressOptions":
        """Functional update (re-validates)."""
        return dataclasses.replace(self, **changes)
