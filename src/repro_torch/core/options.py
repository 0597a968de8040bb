"""Compress configuration: ``CompressOptions``.

The fields and their validation follow the JAX package's ``core/options.py``,
so one options object means the same run in both packages.  The PyTorch
compressor runs the batch path only, configured by ``tau`` and
``chunk_hyperblocks``; ``HierarchicalCompressor.compress`` raises
``ConfigError`` for ``stream``, ``queue_depth``, ``mesh``, ``retries``,
``stage_deadline_s`` and ``chaos_seed`` away from their defaults, which
belong to paths not ported yet.

Validation happens at CONSTRUCTION time and raises a typed
:class:`~repro_torch.core.errors.ConfigError`, so a zero-width chunk fails
here, in one obvious place, instead of deep inside a run.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.errors import ConfigError


@dataclasses.dataclass(frozen=True)
class CompressOptions:
    """One frozen configuration object for a compress run.

    * ``tau`` — per-GAE-block l2 error bound; ``None`` disables the GAE
      guarantee stage entirely.
    * ``chunk_hyperblocks`` — requested stripe width (hyper-blocks per
      independently-decodable archive chunk).  The pipeline may round it UP
      for GAE block alignment; a non-positive width is a
      :class:`ConfigError` here.
    * ``stream``, ``queue_depth``, ``retries``, ``stage_deadline_s``,
      ``chaos_seed``, ``mesh`` — the JAX package's streaming,
      fault-tolerance and sharding knobs; validated, but rejected by
      ``compress`` unless left at their defaults.
    """
    tau: Optional[float] = None
    chunk_hyperblocks: int = 64
    stream: bool = False
    queue_depth: int = 2
    retries: Optional[int] = None
    stage_deadline_s: Optional[float] = None
    chaos_seed: Optional[int] = None
    mesh: Optional[int] = None

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
        if self.mesh is not None and (not isinstance(self.mesh, int)
                                      or isinstance(self.mesh, bool)
                                      or self.mesh < 1):
            raise ConfigError(f"mesh must be None or a shard count >= 1, "
                              f"got {self.mesh!r}")

    def replace(self, **changes) -> "CompressOptions":
        """Functional update (re-validates)."""
        return dataclasses.replace(self, **changes)
