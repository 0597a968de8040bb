"""Entropy coding (paper Sec. II-E): Huffman for quantized coefficients,
prefix-bitmask + lossless backend for PCA index sets.

The paper uses ZSTD for the concatenated index bitmasks; ``zstandard`` is not
available offline, so we use stdlib zlib (DEFLATE) behind the same interface —
mechanism identical, ratios differ by a few percent (noted in DESIGN.md §4).

All of this is host-side (numpy + bytes): on a real deployment the TPU emits
quantized integer tensors and the host feeders run this lossless pass, exactly
mirroring the paper's factorization (quantization in-graph, Huffman post-hoc).
"""
from __future__ import annotations

import heapq
import struct
import zlib
from typing import NamedTuple, Optional

import numpy as np

from repro_torch.core.errors import MalformedStream, TruncatedArchive

MAX_CODE_LEN = 16

# DEFLATE effort for the index/bin-exp blobs.  Level 9 spent ~40% of chunk
# encode time for <1% ratio over level 6 on the bitmask payloads (measured in
# BENCH_pipeline.json); 6 is the hot-path sweet spot.
_ZLIB_LEVEL = 6


# ---------------------------------------------------------------------------
# canonical Huffman
# ---------------------------------------------------------------------------

class HuffmanBook(NamedTuple):
    symbols: np.ndarray   # (S,) int64, sorted by (length, symbol)
    lengths: np.ndarray   # (S,) uint8
    codes: np.ndarray     # (S,) uint32 canonical codes

    def nbytes(self) -> int:
        """Serialized codebook cost: symbol values + code lengths."""
        return self.symbols.size * 8 + self.lengths.size


def _code_lengths(freqs: np.ndarray) -> np.ndarray:
    """Huffman code lengths via heap; freqs > 0."""
    n = freqs.size
    if n == 1:
        return np.array([1], np.uint8)
    heap: list[tuple[float, int, object]] = [(float(f), i, i) for i, f in enumerate(freqs)]
    heapq.heapify(heap)
    lengths = np.zeros(n, np.int64)
    counter = n
    while len(heap) > 1:
        fa, _, a = heapq.heappop(heap)
        fb, _, b = heapq.heappop(heap)
        heapq.heappush(heap, (fa + fb, counter, (a, b)))
        counter += 1
    stack = [(heap[0][2], 0)]
    while stack:
        node, depth = stack.pop()
        if isinstance(node, tuple):
            stack.append((node[0], depth + 1))
            stack.append((node[1], depth + 1))
        else:
            lengths[node] = max(depth, 1)
    return lengths


def build_huffman(values: np.ndarray) -> HuffmanBook:
    """Canonical Huffman book over observed symbols, code length capped at 16."""
    syms, freqs = np.unique(np.asarray(values).ravel(), return_counts=True)
    f = freqs.astype(np.float64)
    lengths = _code_lengths(f)
    while lengths.max() > MAX_CODE_LEN:
        f = np.ceil(np.power(f, 0.9))            # flatten distribution, retry
        lengths = _code_lengths(f)
    # canonical ordering: (length, symbol)
    order = np.lexsort((syms, lengths))
    syms, lengths = syms[order], lengths[order]
    codes = np.zeros(syms.size, np.uint32)
    code = 0
    prev_len = int(lengths[0])
    for i in range(syms.size):
        code <<= int(lengths[i]) - prev_len
        codes[i] = code
        prev_len = int(lengths[i])
        code += 1
    return HuffmanBook(symbols=syms.astype(np.int64),
                       lengths=lengths.astype(np.uint8), codes=codes)


def huffman_encode(values: np.ndarray, book: HuffmanBook) -> bytes:
    """Vectorized bit-packing of values through the codebook."""
    v = np.asarray(values).ravel().astype(np.int64)
    # book is in canonical (length, symbol) order — not value-sorted; map
    # through a value-sorted view for the searchsorted lookup.
    order = np.argsort(book.symbols, kind="stable")
    sorted_syms = book.symbols[order]
    idx = order[np.searchsorted(sorted_syms, v)]
    assert np.all(book.symbols[idx] == v), "symbol not in codebook"
    lens = book.lengths[idx].astype(np.int64)
    codes = book.codes[idx].astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        return b""
    pos = np.concatenate([[0], np.cumsum(lens)[:-1]])
    block = np.repeat(np.arange(v.size), lens)
    within = np.arange(total) - np.repeat(pos, lens)
    bits = (codes[block] >> (lens[block] - 1 - within)) & 1
    return np.packbits(bits.astype(np.uint8)).tobytes()


def rebuild_canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Reconstruct canonical codes from (length,symbol)-sorted code lengths.

    This is the untrusted inverse of ``build_huffman``'s assignment loop: the
    on-disk book stores only symbols + lengths, and this validates that the
    lengths describe a realizable prefix code (in-range, sorted, Kraft-
    feasible) before any decode table is built from them.
    """
    lengths = np.asarray(lengths)
    if lengths.size == 0:
        return np.zeros(0, np.uint32)
    if lengths.min() < 1 or lengths.max() > MAX_CODE_LEN:
        raise MalformedStream(
            f"Huffman code length out of range [1, {MAX_CODE_LEN}]")
    if np.any(np.diff(lengths.astype(np.int64)) < 0):
        raise MalformedStream("Huffman code lengths not in canonical order")
    codes = np.zeros(lengths.size, np.uint32)
    code = 0
    prev_len = int(lengths[0])
    for i in range(lengths.size):
        li = int(lengths[i])
        code <<= li - prev_len
        if code >= (1 << li):
            raise MalformedStream("Huffman code space overflow (Kraft violation)")
        codes[i] = code
        prev_len = li
        code += 1
    return codes


def rebuild_book(symbols: np.ndarray, lengths: np.ndarray) -> HuffmanBook:
    """Validated ``HuffmanBook`` from untrusted serialized (symbols, lengths)."""
    symbols = np.asarray(symbols, np.int64)
    lengths = np.asarray(lengths, np.uint8)
    if symbols.size != lengths.size:
        raise MalformedStream("Huffman book symbol/length count mismatch")
    return HuffmanBook(symbols=symbols, lengths=lengths,
                       codes=rebuild_canonical_codes(lengths))


# Below this symbol count the fully-vectorized decode's setup cost exceeds
# the scalar loop; measured crossover is a few hundred symbols.
_VECTOR_DECODE_MIN = 256


def _decode_table(book: HuffmanBook) -> tuple[np.ndarray, np.ndarray]:
    """(table_sym, table_len) 2^16 lookup tables; table_len 0 = invalid."""
    table_sym = np.zeros(1 << MAX_CODE_LEN, np.int64)
    table_len = np.zeros(1 << MAX_CODE_LEN, np.uint8)
    for s, l, c in zip(book.symbols, book.lengths, book.codes):
        l = int(l)
        if not 1 <= l <= MAX_CODE_LEN:
            raise MalformedStream(f"Huffman code length {l} out of range")
        base = int(c) << (MAX_CODE_LEN - l)
        span = 1 << (MAX_CODE_LEN - l)
        if base + span > (1 << MAX_CODE_LEN):
            raise MalformedStream("Huffman code outside table range")
        table_sym[base:base + span] = s
        table_len[base:base + span] = l
    return table_sym, table_len


def _decode_prologue(data: bytes, book: HuffmanBook, count: int):
    if count < 0:
        raise MalformedStream(f"negative symbol count {count}")
    if book.symbols.size == 0:
        raise MalformedStream("empty Huffman book with nonzero symbol count")
    table_sym, table_len = _decode_table(book)
    bits = np.unpackbits(np.frombuffer(data, np.uint8))
    bits = np.concatenate([bits, np.zeros(MAX_CODE_LEN, np.uint8)])  # tail pad
    return table_sym, table_len, bits, len(data) * 8


def huffman_decode_scalar(data: bytes, book: HuffmanBook, count: int) -> np.ndarray:
    """Reference table-driven decode: one Python iteration per symbol.  Kept
    as the oracle for the vectorized path (and for small streams, where it is
    faster); identical output and error behavior."""
    if count == 0:
        return np.zeros(0, np.int64)
    table_sym, table_len, bits, total_bits = _decode_prologue(data, book, count)
    out = np.empty(count, np.int64)
    pos = 0
    weights = (1 << np.arange(MAX_CODE_LEN - 1, -1, -1)).astype(np.int64)
    for i in range(count):
        w = int(bits[pos:pos + MAX_CODE_LEN] @ weights)
        step = int(table_len[w])
        if step == 0:
            raise MalformedStream(f"undecodable Huffman prefix at bit {pos}")
        if pos + step > total_bits:
            raise TruncatedArchive(
                f"Huffman payload exhausted at symbol {i}/{count}")
        out[i] = table_sym[w]
        pos += step
    return out


def huffman_decode(data: bytes, book: HuffmanBook, count: int) -> np.ndarray:
    """Table-driven decode (2^16 lookup), bounds-checked against corrupt input:
    an undecodable prefix raises ``MalformedStream`` and running out of payload
    bits before ``count`` symbols raises ``TruncatedArchive``.

    Large streams take a vectorized path: every bit position's (symbol, step)
    is computed in one numpy pass, then the decode chain pos -> pos + step is
    enumerated by pointer doubling — O(total_bits * log(count)) numpy work
    with no per-symbol Python iteration, and GIL-releasing so independent
    chunks decode in parallel (see ``core.exec.map_parallel``).  Output and
    typed-error behavior are identical to ``huffman_decode_scalar`` (the
    chain is deterministic up to the first damaged position, which is
    reported exactly as the scalar loop would).
    """
    if count == 0:
        return np.zeros(0, np.int64)
    if count < _VECTOR_DECODE_MIN:
        return huffman_decode_scalar(data, book, count)
    if book.symbols.size == 0:
        raise MalformedStream("empty Huffman book with nonzero symbol count")
    table_sym, table_len = _decode_table(book)
    total_bits = len(data) * 8

    # The 16-bit window at EVERY bit position 0..total_bits, read straight
    # out of zero-padded byte triples: window(p) spans bytes p>>3 .. p>>3+2,
    # so one gather + two shifts beats both unpackbits and a 16-pass build.
    buf = np.frombuffer(data, np.uint8).astype(np.uint32)
    ext = np.concatenate([buf, np.zeros(3, np.uint32)])
    b3 = (ext[:-2] << 16) | (ext[1:-1] << 8) | ext[2:]
    n_pos = total_bits + 1
    pos_all = np.arange(n_pos, dtype=np.int64)
    windows = ((b3[pos_all >> 3] << (pos_all & 7)) >> 8) & 0xFFFF
    step = table_len[windows]                          # uint8; 0 = invalid

    # Successor of each position; invalid prefixes (step 0) self-loop and
    # overruns clamp in-range so the doubling below stays well-defined — the
    # post-scan reports the first error in chain order.
    idx = np.arange(n_pos, dtype=np.int32)
    nxt = np.minimum(np.where(step == 0, idx, idx + step),
                     np.int32(n_pos - 1))

    # Pointer doubling: after k rounds ``pos`` holds the bit positions of the
    # first 2^k symbols in order and ``jump`` advances 2^k symbols at once.
    pos = np.zeros(1, np.int32)
    jump = nxt
    while pos.size < count:
        pos = np.concatenate([pos, jump[pos]])
        if pos.size < count:
            jump = jump[jump]
    pos = pos[:count]

    step_v = step[pos]
    bad = step_v == 0
    trunc = pos.astype(np.int64) + step_v > total_bits
    if bad.any() or trunc.any():
        first = int(np.argmax(bad | trunc))
        if bad[first]:
            raise MalformedStream(
                f"undecodable Huffman prefix at bit {int(pos[first])}")
        raise TruncatedArchive(
            f"Huffman payload exhausted at symbol {first}/{count}")
    return table_sym[windows[pos]]


class HuffmanStream(NamedTuple):
    payload: bytes
    book: HuffmanBook
    count: int

    def nbytes(self) -> int:
        return len(self.payload) + self.book.nbytes() + 8


def huffman_compress(values: np.ndarray) -> HuffmanStream:
    book = build_huffman(values)
    return HuffmanStream(huffman_encode(values, book), book, int(np.asarray(values).size))


def huffman_decompress(stream: HuffmanStream) -> np.ndarray:
    return huffman_decode(stream.payload, stream.book, stream.count)


def huffman_size_bits(values: np.ndarray) -> int:
    """Exact coded size in bits without materializing the stream (for ratio math)."""
    book = build_huffman(values)
    v = np.asarray(values).ravel().astype(np.int64)
    order = np.argsort(book.symbols, kind="stable")
    idx = order[np.searchsorted(book.symbols[order], v)]
    return int(book.lengths[idx].astype(np.int64).sum()) + book.nbytes() * 8


# ---------------------------------------------------------------------------
# index bitmask coding (paper Fig. 3)
# ---------------------------------------------------------------------------

def encode_index_sets(index_sets: list[np.ndarray], dim: int) -> bytes:
    """'1' marks a selected basis vector; store only the shortest prefix that
    contains all 1s, plus its length; concatenate and DEFLATE.

    Whole-batch implementation (one scatter into an (n, dim) mask matrix, one
    boolean prefix-select) — the per-set Python loop this replaces dominated
    chunk encode time at production block counts.
    """
    n = len(index_sets)
    sizes = np.fromiter((np.asarray(s).size for s in index_sets), np.int64, n)
    total = int(sizes.sum())
    plen = np.zeros(n, np.int64)
    if total:
        rows = np.repeat(np.arange(n), sizes)
        cols = np.concatenate([np.asarray(s, np.int64).ravel()
                               for s in index_sets])
        masks = np.zeros((n, dim), np.uint8)
        masks[rows, cols] = 1
        # per-set max index + 1; consecutive nonempty starts bound exactly
        # the nonempty segments (empty segments collapse to zero width)
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        nz = sizes > 0
        plen[nz] = np.maximum.reduceat(cols, starts[nz]) + 1
        bits = masks[np.arange(dim)[None, :] < plen[:, None]]
    else:
        bits = np.zeros(0, np.uint8)
    header = struct.pack("<II", n, dim)
    lens_b = plen.astype(np.uint32).tobytes()
    payload = np.packbits(bits).tobytes() if bits.size else b""
    return zlib.compress(header + lens_b + payload, level=_ZLIB_LEVEL)


def decode_index_sets(blob: bytes, expect_dim: Optional[int] = None,
                      expect_sets: Optional[int] = None) -> list[np.ndarray]:
    """Decode (and validate) the index bitmask blob.

    ``expect_dim`` / ``expect_sets`` cross-check the self-declared header
    against what the caller knows (basis dimension, GAE block count) so a
    corrupt-but-decompressible blob cannot smuggle out-of-range indices into
    the basis gather downstream.
    """
    try:
        raw = zlib.decompress(blob)
    except zlib.error as e:
        raise MalformedStream(f"index blob DEFLATE error: {e}") from e
    if len(raw) < 8:
        raise TruncatedArchive("index blob shorter than its header")
    n, dim = struct.unpack("<II", raw[:8])
    if expect_dim is not None and dim != expect_dim:
        raise MalformedStream(
            f"index blob dimension {dim} != basis dimension {expect_dim}")
    if expect_sets is not None and n != expect_sets:
        raise MalformedStream(f"index blob has {n} sets, expected {expect_sets}")
    if len(raw) < 8 + 4 * n:
        raise TruncatedArchive("index blob length table truncated")
    lens = np.frombuffer(raw[8:8 + 4 * n], np.uint32).astype(np.int64)
    if lens.size and lens.max() > dim:
        raise MalformedStream(
            f"index prefix length {int(lens.max())} exceeds dimension {dim}")
    bits = np.unpackbits(np.frombuffer(raw[8 + 4 * n:], np.uint8))
    if int(lens.sum()) > bits.size:
        raise TruncatedArchive("index bitmask payload truncated")
    # one flatnonzero over the concatenated prefixes, then per-set views via
    # searchsorted cuts — no per-set Python nonzero on the hot decode path
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    nzpos = np.flatnonzero(bits[:offs[-1]])
    seg = np.searchsorted(offs, nzpos, side="right") - 1
    local = (nzpos - offs[seg]).astype(np.int32)
    cuts = np.searchsorted(nzpos, offs)
    return [local[cuts[i]:cuts[i + 1]] for i in range(n)]


def zlib_pack(data: bytes) -> bytes:
    return zlib.compress(data, level=_ZLIB_LEVEL)


def zlib_unpack(data: bytes) -> bytes:
    try:
        return zlib.decompress(data)
    except zlib.error as e:
        raise MalformedStream(f"DEFLATE error: {e}") from e
