"""Durable, self-validating on-disk archive container (.rba).

The in-memory ``Archive`` (repro_torch.core.pipeline) is striped into hyper-block
chunks; this module owns the byte-level container: a magic + versioned header,
a digest-protected section table, and one self-framed section per chunk, so
that

* any flipped bit, torn write, or truncation is DETECTED (CRC32 fast path,
  sha256 strong path, per section), and
* a corrupted chunk section degrades to losing only its own hyper-blocks —
  every other chunk still decodes with the paper's per-block l2 <= tau
  guarantee intact (``decompress(strict=False)``).

No pickle is used anywhere on the read path: every structure is parsed from
explicit little-endian framing with bounds checks, and all failures raise the
typed ``ArchiveError`` taxonomy from ``repro_torch.core.errors``.

Layout (all integers little-endian; see docs/ARCHIVE_FORMAT.md)::

    magic(8) version(u32) n_sections(u32) table_len(u64)
    [ name_len(u16) name(utf-8) offset(u64) length(u64) crc32(u32) sha256(32) ]*
    table_crc(u32)                       # CRC32 of everything above
    <section payloads, concatenated>

Sections: ``meta`` (JSON) then ``chunk/<i>`` blobs.  Writes are atomic:
tmp file + fsync + rename, with bounded retry/backoff.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
import time
import zlib
from typing import Optional

import numpy as np

from repro_torch.core import entropy
from repro_torch.core.errors import (ArchiveError, ChecksumMismatch, MalformedStream,
                               TruncatedArchive)
from repro_torch.core.pipeline import Archive, ArchiveChunk

MAGIC = b"\x89RBA\r\n\x1a\n"
VERSION = 1
_PROLOGUE = struct.Struct("<8sIIQ")
_SECTION_FIXED = struct.Struct("<QQI32s")
_META_NAME = "meta"

# Caps applied while parsing untrusted framing, far above anything the encoder
# emits but small enough that a fuzzed length field cannot balloon memory.
MAX_SECTIONS = 1 << 20
MAX_SYMBOLS = 1 << 24
MAX_COUNT = 1 << 40


# ---------------------------------------------------------------------------
# atomic writes
# ---------------------------------------------------------------------------

def atomic_write_bytes(path: str, data: bytes, *, retries: int = 3,
                       backoff: float = 0.05) -> None:
    """Write ``data`` to ``path`` atomically (tmp + fsync + rename), retrying
    transient OS failures with exponential backoff."""
    tmp = f"{path}.tmp.{os.getpid()}"
    last: Optional[OSError] = None
    for attempt in range(retries + 1):
        try:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            dirname = os.path.dirname(os.path.abspath(path))
            try:    # persist the rename itself; best-effort on odd filesystems
                dfd = os.open(dirname, os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
            except OSError:
                pass
            return
        except OSError as e:
            last = e
            if os.path.exists(tmp):
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            if attempt < retries:
                time.sleep(backoff * (2 ** attempt))
    raise OSError(f"failed to write {path!r} after {retries + 1} attempts") from last


# ---------------------------------------------------------------------------
# bounded little-endian readers
# ---------------------------------------------------------------------------

class _Reader:
    """Cursor over untrusted bytes; every read is bounds-checked."""

    def __init__(self, buf: bytes, what: str):
        self.buf = buf
        self.off = 0
        self.what = what

    def take(self, n: int) -> bytes:
        if n < 0 or self.off + n > len(self.buf):
            raise TruncatedArchive(
                f"{self.what}: need {n} bytes at offset {self.off}, "
                f"have {len(self.buf) - self.off}")
        out = self.buf[self.off:self.off + n]
        self.off += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self.take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def done(self) -> bool:
        return self.off == len(self.buf)


# ---------------------------------------------------------------------------
# Huffman stream framing
# ---------------------------------------------------------------------------

def _pack_stream(s: Optional[entropy.HuffmanStream]) -> bytes:
    if s is None:
        return struct.pack("<QI", 0, 0) + struct.pack("<Q", 0)
    syms = np.asarray(s.book.symbols, "<i8").tobytes()
    lens = np.asarray(s.book.lengths, np.uint8).tobytes()
    return (struct.pack("<QI", s.count, s.book.symbols.size) + syms + lens
            + struct.pack("<Q", len(s.payload)) + s.payload)


def _unpack_stream(r: _Reader) -> Optional[entropy.HuffmanStream]:
    count = r.u64()
    n_sym = r.u32()
    if count > MAX_COUNT:
        raise MalformedStream(f"{r.what}: absurd symbol count {count}")
    if n_sym > MAX_SYMBOLS:
        raise MalformedStream(f"{r.what}: absurd codebook size {n_sym}")
    if count > 0 and n_sym == 0:
        raise MalformedStream(f"{r.what}: {count} symbols with empty book")
    symbols = np.frombuffer(r.take(8 * n_sym), "<i8").astype(np.int64)
    lengths = np.frombuffer(r.take(n_sym), np.uint8)
    payload_len = r.u64()
    payload = r.take(payload_len)
    if count == 0 and n_sym == 0:
        return None
    book = entropy.rebuild_book(symbols, lengths)
    return entropy.HuffmanStream(payload=payload, book=book, count=int(count))


# ---------------------------------------------------------------------------
# chunk framing
# ---------------------------------------------------------------------------

_FLAG_GAE = 1
_FLAG_GAE_COEFFS = 2
_FLAG_VERBATIM = 4   # quarantine fallback: deflate-packed raw float32 stripe


def _pack_chunk(c: ArchiveChunk) -> bytes:
    if c.verbatim_blob:
        # quarantined stripe: the payload is the stripe itself (lossless),
        # no latent/GAE streams exist
        return b"".join([
            struct.pack("<IIBB", c.hb_start, c.n_hyperblocks, 0,
                        _FLAG_VERBATIM),
            struct.pack("<Q", len(c.verbatim_blob)), c.verbatim_blob])
    flags = 0
    if c.gae_index_blob:
        flags |= _FLAG_GAE
    if c.gae_coeff_stream is not None:
        flags |= _FLAG_GAE_COEFFS
    parts = [struct.pack("<IIBB", c.hb_start, c.n_hyperblocks,
                         len(c.bae_streams), flags),
             _pack_stream(c.hb_stream)]
    parts += [_pack_stream(s) for s in c.bae_streams]
    if flags & _FLAG_GAE:
        if flags & _FLAG_GAE_COEFFS:
            parts.append(_pack_stream(c.gae_coeff_stream))
        parts.append(struct.pack("<I", len(c.gae_index_blob)))
        parts.append(c.gae_index_blob)
        parts.append(struct.pack("<I", len(c.gae_binexp_blob)))
        parts.append(c.gae_binexp_blob)
    return b"".join(parts)


def _unpack_chunk(blob: bytes, name: str) -> ArchiveChunk:
    r = _Reader(blob, name)
    hb_start = r.u32()
    n_hb = r.u32()
    n_bae = r.u8()
    flags = r.u8()
    if n_hb == 0:
        raise MalformedStream(f"{name}: empty chunk")
    if flags & _FLAG_VERBATIM:
        if flags != _FLAG_VERBATIM or n_bae != 0:
            raise MalformedStream(
                f"{name}: verbatim chunk with conflicting flags={flags} "
                f"n_bae={n_bae}")
        verbatim = r.take(r.u64())
        if not verbatim:
            raise MalformedStream(f"{name}: empty verbatim payload")
        if not r.done():
            raise MalformedStream(
                f"{name}: {len(blob) - r.off} trailing bytes")
        return ArchiveChunk(hb_start=hb_start, n_hyperblocks=n_hb,
                            hb_stream=None, bae_streams=[],
                            gae_coeff_stream=None, gae_index_blob=b"",
                            gae_binexp_blob=b"", verbatim_blob=verbatim)
    hb_stream = _unpack_stream(r)
    if hb_stream is None:
        raise MalformedStream(f"{name}: missing hyper-block latent stream")
    bae_streams = []
    for _ in range(n_bae):
        s = _unpack_stream(r)
        if s is None:
            raise MalformedStream(f"{name}: missing BAE stream")
        bae_streams.append(s)
    coeff_stream = None
    index_blob = binexp_blob = b""
    if flags & _FLAG_GAE:
        if flags & _FLAG_GAE_COEFFS:
            coeff_stream = _unpack_stream(r)
            if coeff_stream is None:
                raise MalformedStream(f"{name}: missing GAE coefficient stream")
        index_blob = r.take(r.u32())
        binexp_blob = r.take(r.u32())
    if not r.done():
        raise MalformedStream(f"{name}: {len(blob) - r.off} trailing bytes")
    return ArchiveChunk(hb_start=hb_start, n_hyperblocks=n_hb,
                        hb_stream=hb_stream, bae_streams=bae_streams,
                        gae_coeff_stream=coeff_stream,
                        gae_index_blob=index_blob, gae_binexp_blob=binexp_blob)


# ---------------------------------------------------------------------------
# container serialize / deserialize
# ---------------------------------------------------------------------------

def _chunk_name(i: int) -> str:
    return f"chunk/{i:06d}"


def chunk_section_name(i: int) -> str:
    """Public alias for the per-chunk section naming scheme."""
    return _chunk_name(i)


def build_meta_blob(*, n_hyperblocks: int, n_values: int,
                    chunk_hyperblocks: int, gae_dim: int,
                    spans: list) -> bytes:
    """The ``meta`` section bytes for a given stripe tiling.  Shared between
    ``serialize_archive`` and the streaming writer so both produce identical
    meta sections for the same geometry — ``spans`` is known BEFORE any chunk
    is encoded, which is what lets the streaming writer lay out the whole
    section table up front."""
    meta = {
        "format": VERSION,
        "n_hyperblocks": int(n_hyperblocks),
        "n_values": int(n_values),
        "chunk_hyperblocks": int(chunk_hyperblocks),
        "gae_dim": int(gae_dim),
        "n_chunks": len(spans),
        "chunks": [[int(s), int(n)] for s, n in spans],
    }
    return json.dumps(meta, sort_keys=True).encode()


def pack_head(entries: list) -> bytes:
    """Prologue + section table + table CRC for ``entries`` =
    ``[(name, offset, length, crc32, sha256_digest), ...]``."""
    table = bytearray()
    for name, offset, length, crc, sha in entries:
        nb = name.encode()
        table += struct.pack("<H", len(nb)) + nb
        table += _SECTION_FIXED.pack(offset, length, crc, sha)
    head = _PROLOGUE.pack(MAGIC, VERSION, len(entries), len(table)) + table
    return head + struct.pack("<I", zlib.crc32(head))


def head_size(section_names: list) -> int:
    """Byte length of ``pack_head`` output for the given section names —
    fixed as soon as the stripe tiling is known, so the streaming writer can
    reserve the header region before any payload exists."""
    table_len = sum(2 + len(n.encode()) + _SECTION_FIXED.size
                    for n in section_names)
    return _PROLOGUE.size + table_len + 4


def pack_chunk_section(c: ArchiveChunk) -> bytes:
    """Public alias of the chunk section framing encoder."""
    return _pack_chunk(c)


def unpack_chunk_section(blob: bytes, name: str = "chunk") -> ArchiveChunk:
    """Public alias of the chunk section framing decoder (typed errors)."""
    return _unpack_chunk(blob, name)


def chunk_section_size(c: ArchiveChunk) -> int:
    """Exact ``len(pack_chunk_section(c))`` from framing arithmetic (no bytes
    built) — the streaming writer's span precomputation."""
    return _chunk_size(c)


def serialize_archive(archive: Archive) -> bytes:
    """Serialize to the container byte layout (deterministic)."""
    if any(c is None for c in archive.chunks):
        raise ValueError("cannot serialize an archive with damaged chunks")
    meta_blob = build_meta_blob(
        n_hyperblocks=archive.n_hyperblocks, n_values=archive.n_values,
        chunk_hyperblocks=archive.chunk_hyperblocks, gae_dim=archive.gae_dim,
        spans=[(c.hb_start, c.n_hyperblocks) for c in archive.chunks])
    sections = [(_META_NAME, meta_blob)]
    sections += [(_chunk_name(i), _pack_chunk(c))
                 for i, c in enumerate(archive.chunks)]

    entries = []
    offset = 0
    for name, blob in sections:
        entries.append((name, offset, len(blob), zlib.crc32(blob),
                        hashlib.sha256(blob).digest()))
        offset += len(blob)
    return pack_head(entries) + b"".join(blob for _, blob in sections)


def _stream_size(s: Optional[entropy.HuffmanStream]) -> int:
    """len(_pack_stream(s)) from framing arithmetic, no bytes built."""
    if s is None:
        return 12 + 8
    return 12 + 9 * s.book.symbols.size + 8 + len(s.payload)


def _chunk_size(c: ArchiveChunk) -> int:
    """len(_pack_chunk(c)) from framing arithmetic, no bytes built."""
    if c.verbatim_blob:
        return 10 + 8 + len(c.verbatim_blob)
    size = 10 + _stream_size(c.hb_stream)
    size += sum(_stream_size(s) for s in c.bae_streams)
    if c.gae_index_blob:
        if c.gae_coeff_stream is not None:
            size += _stream_size(c.gae_coeff_stream)
        size += 4 + len(c.gae_index_blob) + 4 + len(c.gae_binexp_blob)
    return size


def serialized_size(archive: Archive) -> int:
    """Exact ``len(serialize_archive(archive))`` WITHOUT building the payload
    bytes: O(sections) arithmetic over the framing layout (the meta JSON is
    the only section actually rendered).  Keeps ``Archive.compressed_bytes``
    / ``compression_ratio`` cheap enough to query inside benchmark sweeps."""
    if any(c is None for c in archive.chunks):
        raise ValueError("cannot size an archive with damaged chunks")
    meta_blob = build_meta_blob(
        n_hyperblocks=archive.n_hyperblocks, n_values=archive.n_values,
        chunk_hyperblocks=archive.chunk_hyperblocks, gae_dim=archive.gae_dim,
        spans=[(c.hb_start, c.n_hyperblocks) for c in archive.chunks])
    names = [_META_NAME] + [_chunk_name(i)
                            for i in range(len(archive.chunks))]
    return (head_size(names) + len(meta_blob)
            + sum(_chunk_size(c) for c in archive.chunks))


def deserialize_archive(data: bytes, *, strict: bool = True) -> Archive:
    """Parse + verify a container.  ``strict=True`` raises on ANY damage;
    ``strict=False`` tolerates damaged chunk sections (they become ``None``
    entries with reasons in ``Archive.chunk_errors``) but still raises if the
    header, section table, or meta section are unusable."""
    if len(data) < _PROLOGUE.size + 4:
        raise TruncatedArchive(
            f"file of {len(data)} bytes is shorter than the header")
    magic, version, n_sections, table_len = _PROLOGUE.unpack_from(data)
    if magic != MAGIC:
        raise MalformedStream(f"bad magic {magic!r}")
    if version != VERSION:
        raise MalformedStream(f"unsupported container version {version}")
    if n_sections > MAX_SECTIONS:
        raise MalformedStream(f"absurd section count {n_sections}")
    head_len = _PROLOGUE.size + table_len
    if head_len + 4 > len(data):
        raise TruncatedArchive("section table extends past end of file")
    declared = struct.unpack_from("<I", data, head_len)[0]
    if zlib.crc32(data[:head_len]) != declared:
        raise ChecksumMismatch("section table CRC mismatch (header damage)")

    r = _Reader(data[_PROLOGUE.size:head_len], "section table")
    payload_base = head_len + 4
    table: dict[str, tuple[int, int, int, bytes]] = {}
    for _ in range(n_sections):
        try:
            name = r.take(r.u16()).decode()
        except UnicodeDecodeError as e:
            raise MalformedStream(f"undecodable section name: {e}") from e
        off, length, crc, sha = _SECTION_FIXED.unpack(
            r.take(_SECTION_FIXED.size))
        if name in table:
            raise MalformedStream(f"duplicate section {name!r}")
        table[name] = (off, length, crc, sha)
    if not r.done():
        raise MalformedStream("trailing bytes in section table")

    def read_section(name: str) -> bytes:
        off, length, crc, sha = table[name]
        lo, hi = payload_base + off, payload_base + off + length
        if hi > len(data):
            raise TruncatedArchive(
                f"section {name!r} extends past end of file")
        blob = data[lo:hi]
        if zlib.crc32(blob) != crc:
            raise ChecksumMismatch(f"section {name!r} CRC32 mismatch")
        if hashlib.sha256(blob).digest() != sha:
            raise ChecksumMismatch(f"section {name!r} sha256 mismatch")
        return blob

    if _META_NAME not in table:
        raise MalformedStream("container has no meta section")
    try:
        meta = json.loads(read_section(_META_NAME).decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise MalformedStream(f"corrupt meta section: {e}") from e
    meta = _validate_meta(meta)

    chunks: list[Optional[ArchiveChunk]] = []
    chunk_errors: dict[int, str] = {}
    for i, (start, n_hb) in enumerate(meta["chunks"]):
        name = _chunk_name(i)
        try:
            if name not in table:
                raise TruncatedArchive(f"section {name!r} missing")
            chunk = _unpack_chunk(read_section(name), name)
            if chunk.hb_start != start or chunk.n_hyperblocks != n_hb:
                raise MalformedStream(
                    f"{name}: header range [{chunk.hb_start}, "
                    f"+{chunk.n_hyperblocks}] != meta range [{start}, +{n_hb}]")
        except ArchiveError as e:
            if strict:
                raise
            chunks.append(None)
            chunk_errors[i] = repr(e)
            continue
        chunks.append(chunk)
    return Archive(n_hyperblocks=meta["n_hyperblocks"],
                   n_values=meta["n_values"],
                   chunk_hyperblocks=meta["chunk_hyperblocks"],
                   gae_dim=meta["gae_dim"], chunks=chunks,
                   chunk_errors=chunk_errors)


def _validate_meta(meta) -> dict:
    if not isinstance(meta, dict):
        raise MalformedStream("meta section is not a JSON object")
    for key in ("n_hyperblocks", "n_values", "chunk_hyperblocks", "gae_dim",
                "n_chunks"):
        v = meta.get(key)
        if not isinstance(v, int) or v < 0:
            raise MalformedStream(f"meta field {key!r} invalid: {v!r}")
    chunks = meta.get("chunks")
    if (not isinstance(chunks, list) or len(chunks) != meta["n_chunks"]
            or not all(isinstance(c, list) and len(c) == 2
                       and all(isinstance(x, int) and x >= 0 for x in c)
                       for c in chunks)):
        raise MalformedStream("meta chunk table invalid")
    covered = 0
    for start, n_hb in chunks:
        if start != covered or n_hb == 0:
            raise MalformedStream("meta chunk table does not tile the "
                                  "hyper-block range")
        covered += n_hb
    if covered != meta["n_hyperblocks"]:
        raise MalformedStream(
            f"meta chunk table covers {covered} hyper-blocks, "
            f"declares {meta['n_hyperblocks']}")
    return meta


# ---------------------------------------------------------------------------
# file-level API
# ---------------------------------------------------------------------------

def write_archive(archive: Archive, path: str, *, retries: int = 3) -> int:
    """Serialize and atomically write ``archive``; returns bytes written."""
    blob = serialize_archive(archive)
    atomic_write_bytes(path, blob, retries=retries)
    return len(blob)


def read_archive(path: str, *, strict: bool = True) -> Archive:
    """Read + verify a container from disk (see ``deserialize_archive``)."""
    with open(path, "rb") as f:
        data = f.read()
    return deserialize_archive(data, strict=strict)
