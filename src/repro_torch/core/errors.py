"""Typed failure taxonomy + damage reporting for the archive read path.

Every failure on the untrusted decode path (on-disk container, Huffman
bitstreams, index bitmasks, model manifests) is raised as a subclass of
``ArchiveError`` — never a raw ``struct.error`` / ``zlib.error`` /
``IndexError``.  Callers can therefore distinguish "this archive is damaged"
from programming errors, and ``decompress(strict=False)`` can degrade
gracefully per chunk instead of crashing.
"""
from __future__ import annotations

import dataclasses


class ArchiveError(Exception):
    """Base class for all archive/bitstream decode failures."""


class TruncatedArchive(ArchiveError):
    """The container or a stream ended before its declared length."""


class ChecksumMismatch(ArchiveError):
    """A section's CRC32/sha256 digest does not match its contents."""


class MalformedStream(ArchiveError):
    """A stream is structurally invalid (bad magic, impossible code lengths,
    out-of-range indices, count mismatches, undecodable prefix, ...)."""


class ConfigError(ValueError):
    """A compression run was configured with values that can never execute
    (zero-width chunks, an empty device mesh, a mesh without the hyper-block
    data axis, more shards than devices, ...).

    Raised at ``CompressOptions`` CONSTRUCTION / mesh-resolution time — before
    any model program is built — so a bad ``--mesh``/``--chunk-hyperblocks``
    combination surfaces as one typed error instead of a mid-run XLA shape
    crash deep inside a sharded trace.
    """


class TransientStageError(Exception):
    """A pipeline-stage failure presumed recoverable by retrying the SAME
    item on the SAME stage (worker-pool hiccup, transient ``OSError`` from
    the sink, injected chaos).  The streaming scheduler's ``RetryPolicy``
    retries these with seeded exponential backoff; anything else is a
    permanent failure and goes straight to failover/quarantine.

    Wrap the underlying cause with ``raise TransientStageError(...) from e``
    so diagnostics keep the original traceback.
    """


class StageDeadlineExceeded(TransientStageError):
    """A stage worker blew past its per-item deadline (hung device call,
    stuck host coder).  The watchdog abandons the attempt — the hung call
    keeps running on a discarded thread, its result is ignored — and the
    scheduler treats the item as transiently failed: retry, then quarantine.
    Subclasses ``TransientStageError`` because hangs are usually stragglers,
    not poison.
    """

    def __init__(self, stage: str, item: int, deadline_s: float):
        self.stage = str(stage)
        self.item = int(item)
        self.deadline_s = float(deadline_s)
        super().__init__(
            f"stage {stage!r} item {item}: no result within the "
            f"{deadline_s:g}s deadline — attempt abandoned by the watchdog")


class GuaranteeUnsatisfiable(Exception):
    """The GAE encoder could not bring a block's l2 error under ``tau``.

    Raised on the ENCODE side (not an ``ArchiveError``): it means the
    verify-and-repair loop exhausted its refinement budget with ``err > tau``
    — e.g. a rank-deficient basis that cannot span the residual, or a
    ``max_refine`` cap too small for the requested bound.  Before this error
    existed the encoder silently emitted a guarantee-violating block.
    """

    def __init__(self, block: int, err: float, tau: float, max_refine: int):
        self.block = int(block)
        self.err = float(err)
        self.tau = float(tau)
        self.max_refine = int(max_refine)
        super().__init__(
            f"GAE block {block}: residual l2 {err:.6g} > tau {tau:.6g} after "
            f"exhausting max_refine={max_refine} bin refinements — the "
            f"guarantee cannot be honored for this block")


@dataclasses.dataclass
class ChunkDamage:
    """One damaged hyper-block stripe of an archive."""
    chunk: int              # chunk index in the container
    hb_start: int           # first hyper-block covered by the chunk
    n_hyperblocks: int      # hyper-blocks covered by the chunk
    section: str            # which part failed ("chunk", "hb_stream", "gae", ...)
    error: str              # repr of the underlying ArchiveError


@dataclasses.dataclass
class DamageReport:
    """Per-chunk damage accounting from a tolerant (``strict=False``) decode.

    Hyper-blocks listed here carry NO guarantee; every hyper-block not listed
    decoded from digest-verified, cross-checked streams and still satisfies the
    per-block l2 <= tau bound.
    """
    n_hyperblocks: int
    n_chunks: int
    damaged: list[ChunkDamage] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.damaged

    def damaged_hyperblocks(self) -> set[int]:
        out: set[int] = set()
        for d in self.damaged:
            out.update(range(d.hb_start, d.hb_start + d.n_hyperblocks))
        return out

    def intact_fraction(self) -> float:
        if self.n_hyperblocks == 0:
            return 1.0
        return 1.0 - len(self.damaged_hyperblocks()) / self.n_hyperblocks

    def summary(self) -> str:
        if self.ok:
            return f"intact: {self.n_chunks} chunks, {self.n_hyperblocks} hyper-blocks"
        lines = [f"damaged: {len(self.damaged_hyperblocks())}/"
                 f"{self.n_hyperblocks} hyper-blocks in "
                 f"{len({d.chunk for d in self.damaged})}/{self.n_chunks} chunks"]
        for d in self.damaged:
            lines.append(f"  chunk {d.chunk} [hb {d.hb_start}:"
                         f"{d.hb_start + d.n_hyperblocks}] {d.section}: {d.error}")
        return "\n".join(lines)
