"""Appendable streaming writer for the ``.rba`` archive container.

``archive_io.write_archive`` serializes the whole ``Archive`` in memory and
writes it atomically — fine for batch, useless for streaming, where chunk i
should hit disk while chunk i+1 is still on the device.  This module writes
the SAME byte layout incrementally:

* The stripe tiling (``spans``) is known before any chunk is encoded, so the
  section count, section names, and therefore the exact header length
  (``archive_io.head_size``) are fixed up front.  The header region is
  reserved at offset 0 from the first write.
* Pending chunks get PLACEHOLDER table entries (offset=0, length=0,
  crc=0xFFFFFFFF, sha=zeros).  A placeholder can never verify — crc32 of the
  empty slice is 0 — so a tolerant ``read_archive(strict=False)`` of a
  partial file reports every not-yet-appended chunk as damaged and salvages
  every completed one.  That is the two-phase section table: phase one is
  the placeholder layout, phase two patches real offsets/digests in.
* ``append(i, chunk)`` may arrive out of order (the host codec pool finishes
  stripes in whatever order the scheduler drains them); a reorder buffer
  writes sections strictly in index order so payload offsets stay identical
  to ``serialize_archive``'s concatenation order.  After each in-order write
  the header is re-patched in place (a single small ``pwrite`` at offset 0)
  and re-digested, so the on-disk partial is salvageable after every append.
* ``finalize()`` re-patches the fully-populated header, fsyncs, and
  atomically renames ``<path>.partial`` → ``<path>``.  The final file is
  byte-identical to ``archive_io.serialize_archive`` of the same chunks.

Crash window: only the header patch itself is non-atomic (the payload region
is append-only).  The patch is one small contiguous write, and a partial that
dies mid-patch loses the whole table — everything else loses at most the
chunks that had not been appended yet.
"""
from __future__ import annotations

import hashlib
import os
import zlib
from typing import Optional

from repro_torch.core import exec as exec_mod
from repro_torch.core.errors import ArchiveError
from repro_torch.core.pipeline import ArchiveChunk
from repro_torch.runtime import archive_io

_PLACEHOLDER_CRC = 0xFFFFFFFF
_PLACEHOLDER_SHA = b"\x00" * 32


class WriterStateError(ArchiveError):
    """StreamingArchiveWriter used out of protocol (double append, append
    after finalize, finalize with missing chunks, ...)."""


class StreamingArchiveWriter:
    """Incremental ``.rba`` writer with a two-phase section table.

    Parameters mirror the ``Archive`` geometry fields; ``spans`` is the
    ``[(hb_start, n_hyperblocks), ...]`` stripe tiling from
    ``HierarchicalCompressor.stripe_spans`` and fixes the number of chunk
    sections up front.
    """

    def __init__(self, path: str, *, n_hyperblocks: int, n_values: int,
                 chunk_hyperblocks: int, gae_dim: int, spans: list,
                 fsync_every: bool = False):
        if not spans:
            raise WriterStateError("cannot stream an archive with no chunks")
        self.path = path
        self.partial_path = f"{path}.partial"
        self.spans = [(int(s), int(n)) for s, n in spans]
        self._fsync_every = fsync_every
        self._meta_blob = archive_io.build_meta_blob(
            n_hyperblocks=n_hyperblocks, n_values=n_values,
            chunk_hyperblocks=chunk_hyperblocks, gae_dim=gae_dim, spans=spans)
        names = ([archive_io._META_NAME]
                 + [archive_io.chunk_section_name(i)
                    for i in range(len(spans))])
        self._head_len = archive_io.head_size(names)
        # entry i+1 covers chunk i; entry 0 is meta (known immediately).
        self._entries: list = [
            (archive_io._META_NAME, 0, len(self._meta_blob),
             zlib.crc32(self._meta_blob),
             hashlib.sha256(self._meta_blob).digest())]
        self._entries += [(name, 0, 0, _PLACEHOLDER_CRC, _PLACEHOLDER_SHA)
                          for name in names[1:]]
        self._tail = len(self._meta_blob)   # payload-relative next offset
        self._next = 0                      # next chunk index to hit disk
        self._pending: dict[int, bytes] = {}
        self._seen: set[int] = set()
        self._finalized = False
        self._f = open(self.partial_path, "w+b")
        try:
            self._patch_head()
            self._f.seek(self._head_len)
            self._f.write(self._meta_blob)
            self._sync()
        except BaseException:
            self._f.close()
            raise

    # -- protocol ----------------------------------------------------------

    def append(self, index: int, chunk: ArchiveChunk) -> None:
        """Record chunk ``index``; sections reach disk strictly in index
        order (out-of-order arrivals wait in the reorder buffer).

        IDEMPOTENT under retry: re-appending an index with a byte-identical
        section is a no-op (it re-attempts the drain, so a sink stage retry
        after a transient disk error makes progress instead of tripping the
        double-append guard).  Re-appending an index with DIFFERENT bytes is
        still a protocol error.
        """
        self._check_open()
        if not 0 <= index < len(self.spans):
            raise WriterStateError(
                f"chunk index {index} outside [0, {len(self.spans)})")
        start, n_hb = self.spans[index]
        if chunk.hb_start != start or chunk.n_hyperblocks != n_hb:
            raise WriterStateError(
                f"chunk {index} covers [{chunk.hb_start}, "
                f"+{chunk.n_hyperblocks}], span table says [{start}, +{n_hb}]")
        blob = archive_io.pack_chunk_section(chunk)
        if index in self._seen:
            if index in self._pending:
                if self._pending[index] != blob:
                    raise WriterStateError(
                        f"chunk {index} appended twice with different bytes")
            else:   # already durable: identical re-append is a no-op
                ent = self._entries[1 + index]
                if ent[3] != zlib.crc32(blob) or \
                        ent[4] != hashlib.sha256(blob).digest():
                    raise WriterStateError(
                        f"chunk {index} appended twice with different bytes")
                return
        else:
            self._seen.add(index)
            self._pending[index] = blob
        exec_mod.counter_max("stream.writer_reorder_depth",
                             len(self._pending))
        self._drain()

    def _drain(self) -> None:
        """Flush the in-order prefix of the reorder buffer to disk.
        Resumable: each section is committed (entry patched, tail advanced,
        buffer popped) only after its bytes are fully written, so an
        ``OSError`` mid-write leaves the writer state consistent and a
        retried ``append`` re-attempts the same section at the same offset."""
        drained = 0
        while self._next in self._pending:
            blob = self._pending[self._next]
            self._f.seek(self._head_len + self._tail)
            self._f.write(blob)
            self._entries[1 + self._next] = (
                archive_io.chunk_section_name(self._next), self._tail,
                len(blob), zlib.crc32(blob), hashlib.sha256(blob).digest())
            self._pending.pop(self._next)
            self._tail += len(blob)
            self._next += 1
            drained += 1
        if drained:
            self._patch_head()
            self._sync()
            exec_mod.counter_add("stream.chunks_on_disk", drained)

    def appended(self) -> int:
        """Chunks accepted so far (on disk or in the reorder buffer)."""
        return len(self._seen)

    def finalize(self) -> int:
        """Patch the final header, fsync, atomically rename the partial to
        ``self.path``; returns total bytes written."""
        self._check_open()
        if self._next != len(self.spans):
            missing = sorted(set(range(len(self.spans))) - self._seen)
            raise WriterStateError(
                f"finalize with {len(self.spans) - self._next} chunks not on "
                f"disk (missing appends: {missing[:8]}...)" if missing else
                f"finalize while {len(self._pending)} chunks wait in the "
                f"reorder buffer")
        self._patch_head()
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        self._finalized = True
        os.replace(self.partial_path, self.path)
        dirname = os.path.dirname(os.path.abspath(self.path))
        try:
            dfd = os.open(dirname, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass
        return self._head_len + self._tail

    def abort(self) -> None:
        """Stop writing, KEEPING ``<path>.partial`` on disk — the partial is
        the crash artifact tolerant readers salvage from."""
        if not self._finalized and not self._f.closed:
            try:
                self._f.flush()
            except OSError:
                pass
            self._f.close()

    def __enter__(self) -> "StreamingArchiveWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None and not self._finalized:
            self.finalize()
        else:
            self.abort()

    # -- internals ---------------------------------------------------------

    def _check_open(self) -> None:
        if self._finalized:
            raise WriterStateError("writer already finalized")
        if self._f.closed:
            raise WriterStateError("writer already aborted")

    def _patch_head(self) -> None:
        head = archive_io.pack_head(self._entries)
        if len(head) != self._head_len:
            raise WriterStateError(
                f"header drifted: packed {len(head)} bytes, reserved "
                f"{self._head_len}")
        self._f.seek(0)
        self._f.write(head)

    def _sync(self) -> None:
        self._f.flush()
        if self._fsync_every:
            os.fsync(self._f.fileno())
