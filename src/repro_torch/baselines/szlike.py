"""SZ3-mechanism reference compressor ("sz-like").

The port's copy of the JAX package's ``repro.baselines.szlike``, on the
port's own ``core/entropy.py``, ``core/errors.py`` and ``runtime/archive_io.py``
(numpy throughout), so its payloads are the JAX package's byte for byte.

Implements the interpolation-based predictor that powers SZ3 (Zhao et al.;
[4] in the paper): a multi-level scheme where each level predicts midpoints by
linear interpolation of already-*decoded* coarser points, quantizes the
prediction error with bins of width 2*eb (guaranteeing pointwise |err| <= eb),
Huffman-codes the quantization integers and DEFLATEs the seed.  The classic
pointwise Lorenzo loop is inherently serial; the interpolation form is
level-sequential but fully vectorized within a level, so it runs at numpy
speed while keeping the same error-control mechanism.

``SZLikeCodec`` speaks the unified :mod:`repro_torch.baselines.codec` protocol: the
payload is a real decodable bitstream (header + DEFLATE seed + Huffman
quants) and ``decompress`` replays the interpolation schedule from decoded
points only — the decoder touches nothing the encoder didn't ship.

This is a faithful *mechanism* reimplementation for comparison curves, not the
tuned C++ SZ3 codebase (see DESIGN.md §1); EXPERIMENTS.md labels it "sz-like".
"""
from __future__ import annotations

import struct

import numpy as np

from repro_torch.baselines import codec as codec_mod
from repro_torch.core import entropy
from repro_torch.core.errors import MalformedStream

_MAGIC = b"SZL1"
_MAX_DIMS = 8


def _max_stride(shape: tuple) -> int:
    ms = 1
    for n in shape:
        while ms * 2 < n:
            ms *= 2
    return ms


def _schedule(shape: tuple, dec: np.ndarray, consume):
    """Run the level-sequential interpolation schedule over ``dec``.

    ``consume(pred, a, targets, grid_axis_view)`` is called once per
    (stride, axis) pass with the midpoint predictions; it must return the
    quantization integers for that pass (the encoder computes them from the
    original data, the decoder reads them off the entropy stream).  ``dec``
    is refined in place — both sides therefore predict from IDENTICAL
    decoded values, which is what makes the scheme error-bounded and the
    decode bit-exact.
    """
    nd = len(shape)
    stride = _max_stride(shape)
    while stride >= 2:
        half = stride // 2
        for a in range(nd):
            n = shape[a]
            targets = np.arange(half, n, stride)
            if targets.size == 0:
                continue
            # grid of already-decoded points: axes before `a` refined to
            # `half` by earlier passes of this level, axes after still
            # `stride`
            grid = tuple(slice(None, None, half) if i < a else
                         (slice(None) if i == a else slice(None, None, stride))
                         for i in range(nd))
            sub_dec = dec[grid]          # strided view — writes propagate
            left = targets - half
            last = ((n - 1) // stride) * stride
            right = np.minimum(targets + half, last)
            dl = np.take(sub_dec, left, axis=a)
            dr = np.take(sub_dec, right, axis=a)
            pred = 0.5 * (dl + dr)
            q = consume(pred, a, targets, grid)
            vals = pred + q.astype(np.float32) * _2EB
            idx = tuple(slice(None) if i != a else targets for i in range(nd))
            sub_dec[idx] = vals
        stride = half


class SZLikeCodec:
    """Error-bounded interpolation codec (unified ``Codec`` protocol)."""

    name = "sz-like"

    def compress(self, data: np.ndarray, bound: float) -> codec_mod.Encoded:
        dec, quants, seed = _encode(np.asarray(data, np.float32),
                                    float(bound))
        return codec_mod.Encoded(codec=self.name,
                                 payload=_pack(data.shape, float(bound),
                                               seed, quants))

    def decompress(self, enc: codec_mod.Encoded) -> np.ndarray:
        shape, eb, seed, allq = _unpack(enc.payload)
        return _decode(shape, eb, seed, allq)


# _schedule closes over the bin width via this module-level slot so encoder
# and decoder run the exact same `pred + q * _2EB` expression (bit-equal).
_2EB = 0.0


def _encode(x: np.ndarray, eb: float
            ) -> tuple[np.ndarray, list[np.ndarray], np.ndarray]:
    global _2EB
    dec = np.zeros_like(x)
    ms = _max_stride(x.shape)
    seed_slices = tuple(slice(None, None, ms) for _ in range(x.ndim))
    seed = x[seed_slices].copy()
    dec[seed_slices] = seed
    quants: list[np.ndarray] = []
    _2EB = 2.0 * eb

    def consume(pred, a, targets, grid):
        err = np.take(x[grid], targets, axis=a) - pred
        q = np.round(err / (2.0 * eb)).astype(np.int64)
        quants.append(q.ravel())
        return q

    _schedule(x.shape, dec, consume)
    return dec, quants, seed


def _decode(shape: tuple, eb: float, seed: np.ndarray,
            allq: np.ndarray) -> np.ndarray:
    global _2EB
    dec = np.zeros(shape, np.float32)
    ms = _max_stride(shape)
    dec[tuple(slice(None, None, ms) for _ in range(len(shape)))] = seed
    _2EB = 2.0 * eb
    pos = [0]

    def consume(pred, a, targets, grid):
        n = int(np.prod(pred.shape))
        if pos[0] + n > allq.size:
            raise MalformedStream(
                f"sz-like stream exhausted: need {n} quants at {pos[0]}, "
                f"have {allq.size}")
        q = allq[pos[0]:pos[0] + n].reshape(pred.shape)
        pos[0] += n
        return q

    _schedule(shape, dec, consume)
    if pos[0] != allq.size:
        raise MalformedStream(
            f"sz-like stream has {allq.size} quants, schedule consumed "
            f"{pos[0]}")
    return dec


def _pack(shape: tuple, eb: float, seed: np.ndarray,
          quants: list[np.ndarray]) -> bytes:
    from repro_torch.runtime import archive_io
    allq = (np.concatenate(quants) if quants else np.zeros(0, np.int64))
    stream = entropy.huffman_compress(allq) if allq.size else None
    seed_blob = entropy.zlib_pack(np.ascontiguousarray(seed, "<f4").tobytes())
    head = _MAGIC + struct.pack("<B", len(shape))
    head += struct.pack(f"<{len(shape)}I", *shape)
    head += struct.pack("<dQ", eb, len(seed_blob))
    return head + seed_blob + archive_io._pack_stream(stream)


def _unpack(payload: bytes) -> tuple[tuple, float, np.ndarray, np.ndarray]:
    from repro_torch.runtime import archive_io
    r = archive_io._Reader(payload, "sz-like payload")
    if r.take(4) != _MAGIC:
        raise MalformedStream("sz-like payload: bad magic")
    nd = r.u8()
    if not 1 <= nd <= _MAX_DIMS:
        raise MalformedStream(f"sz-like payload: absurd rank {nd}")
    shape = struct.unpack(f"<{nd}I", r.take(4 * nd))
    eb, seed_len = struct.unpack("<dQ", r.take(16))
    if not eb > 0:
        raise MalformedStream(f"sz-like payload: bad error bound {eb}")
    seed_raw = entropy.zlib_unpack(r.take(seed_len))
    ms = _max_stride(shape)
    seed_shape = tuple((n + ms - 1) // ms for n in shape)
    want = int(np.prod(seed_shape)) * 4
    if len(seed_raw) != want:
        raise MalformedStream(
            f"sz-like seed holds {len(seed_raw)} bytes, expected {want}")
    seed = np.frombuffer(seed_raw, "<f4").reshape(seed_shape)
    stream = archive_io._unpack_stream(r)
    allq = (entropy.huffman_decompress(stream) if stream is not None
            else np.zeros(0, np.int64))
    return shape, eb, seed, allq


# -- legacy module-level surface --------------------------------------------

def compress(data: np.ndarray, eb: float) -> tuple[np.ndarray, int]:
    """Error-bounded compression. Returns (decoded, compressed_bytes).

    Pointwise guarantee: |data - decoded| <= eb (quantized-midpoint residuals;
    the coarsest seed grid is stored exactly).  ``compressed_bytes`` is the
    length of the REAL decodable payload (``SZLikeCodec``), not an estimate.
    """
    x = np.asarray(data, np.float32)
    dec, quants, seed = _encode(x, float(eb))
    return dec, len(_pack(x.shape, float(eb), seed, quants))


def compression_curve(data: np.ndarray, ebs: list[float]) -> list[dict]:
    """CR / NRMSE points for a sweep of error bounds."""
    return codec_mod.compression_curve(SZLikeCodec(), data, ebs,
                                       bound_key="eb")
