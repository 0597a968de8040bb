"""ZFP-mechanism reference compressor ("zfp-like").

The port's copy of the JAX package's ``repro.baselines.zfplike``, on the
port's own ``core/entropy.py``, ``core/errors.py`` and ``runtime/archive_io.py``
(numpy throughout), so its payloads are the JAX package's byte for byte.

Implements the ZFP pipeline ([15][17] in the paper) on 4^d blocks:
block-floating-point exponent alignment -> ZFP's near-orthogonal separable
decorrelating transform -> uniform coefficient quantization (precision derived
from the requested tolerance) -> Huffman + DEFLATE.  Embedded bit-plane group
testing is replaced by entropy coding of quantized coefficients — same
transform-coding mechanism, simpler bitstream (see DESIGN.md §1);
EXPERIMENTS.md labels it "zfp-like".

``ZFPLikeCodec`` speaks the unified :mod:`repro_torch.baselines.codec` protocol:
the payload (header + DEFLATE per-block scale exponents + Huffman coefficient
stream) is fully self-describing, and ``decompress`` rebuilds ``deq = q *
(step / scale)`` from shipped integers exactly as the encoder computed it —
decode is bit-identical to the encoder-side reconstruction.
"""
from __future__ import annotations

import struct

import numpy as np

from repro_torch.baselines import codec as codec_mod
from repro_torch.core import entropy
from repro_torch.core.errors import MalformedStream

_MAGIC = b"ZFL1"
_MAX_DIMS = 8

# ZFP's forward decorrelating transform (Lindstrom 2014), rows = basis
_T = np.array([[4, 4, 4, 4],
               [5, 1, -1, -5],
               [-4, 4, 4, -4],
               [-2, 6, -6, 2]], np.float32) / 16.0
_TI = np.linalg.inv(_T)


def _blockify(x: np.ndarray) -> tuple[np.ndarray, tuple, tuple]:
    """Pad each dim to a multiple of 4 and split into (n_blocks, 4, 4, ...)."""
    nd = x.ndim
    pads = [(0, (-s) % 4) for s in x.shape]
    xp = np.pad(x, pads, mode="edge")
    grid = tuple(s // 4 for s in xp.shape)
    inter = []
    for g in grid:
        inter.extend([g, 4])
    y = xp.reshape(inter).transpose(*range(0, 2 * nd, 2), *range(1, 2 * nd, 2))
    return y.reshape(int(np.prod(grid)), *([4] * nd)), xp.shape, grid


def _unblockify(blocks: np.ndarray, padded_shape: tuple, grid: tuple,
                orig_shape: tuple) -> np.ndarray:
    nd = len(grid)
    y = blocks.reshape(*grid, *([4] * nd))
    perm = []
    for i in range(nd):
        perm.extend([i, nd + i])
    xp = y.transpose(*perm).reshape(padded_shape)
    return xp[tuple(slice(0, s) for s in orig_shape)]


def _transform(blocks: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """Separable transform along every block axis (axes 1..nd)."""
    out = blocks
    nd = blocks.ndim - 1
    for a in range(1, nd + 1):
        out = np.moveaxis(np.tensordot(mat, np.moveaxis(out, a, 0), axes=(1, 0)), 0, a)
    return out


def _reconstruct(q: np.ndarray, log2_scale: np.ndarray, tol: float,
                 shape: tuple) -> np.ndarray:
    """Shared decoder core: quant integers + scale exponents -> array.

    Encoder and decoder both call this, so the encoder's returned ``decoded``
    IS the decode of the payload, bit for bit.
    """
    nd = len(shape)
    grid = tuple((s + 3) // 4 for s in shape)
    padded_shape = tuple(g * 4 for g in grid)
    nb = int(np.prod(grid))
    block_shape = (nb, *([4] * nd))
    scale = np.exp2(log2_scale.astype(np.float32))[:, None]
    step = tol * 2.0
    deq = q.astype(np.float32) * (step / scale)
    rec = _transform(deq.reshape(block_shape), _TI)
    rec_blocks = rec.reshape(nb, -1) * scale
    return _unblockify(rec_blocks.reshape(block_shape), padded_shape, grid,
                       shape).astype(np.float32)


class ZFPLikeCodec:
    """Transform-coding codec (unified ``Codec`` protocol)."""

    name = "zfp-like"

    def compress(self, data: np.ndarray, bound: float) -> codec_mod.Encoded:
        x = np.asarray(data, np.float32)
        tol = float(bound)
        blocks, _padded, _grid = _blockify(x)
        nb = blocks.shape[0]
        flatb = blocks.reshape(nb, -1)

        # block-floating-point: per-block power-of-two scale
        emax = np.maximum(np.abs(flatb).max(axis=1), 1e-30)
        log2_scale = np.ceil(np.log2(emax)).astype(np.int8)
        scale = np.exp2(log2_scale.astype(np.float32))[:, None]
        normed = (flatb / scale).reshape(blocks.shape)

        coeffs = _transform(normed, _T)
        # uniform quantization of transform coefficients; step tuned so the
        # per-point reconstruction error lands near `tol` (transform gain ~1)
        step = tol * 2.0
        q = np.round(coeffs.reshape(nb, -1) / (step / scale)).astype(np.int64)
        return codec_mod.Encoded(codec=self.name,
                                 payload=_pack(x.shape, tol, log2_scale, q))

    def decompress(self, enc: codec_mod.Encoded) -> np.ndarray:
        shape, tol, log2_scale, q = _unpack(enc.payload)
        return _reconstruct(q, log2_scale, tol, shape)


def _pack(shape: tuple, tol: float, log2_scale: np.ndarray,
          q: np.ndarray) -> bytes:
    from repro_torch.runtime import archive_io
    stream = entropy.huffman_compress(q.ravel()) if q.size else None
    scale_blob = entropy.zlib_pack(log2_scale.tobytes())
    head = _MAGIC + struct.pack("<B", len(shape))
    head += struct.pack(f"<{len(shape)}I", *shape)
    head += struct.pack("<dQ", tol, len(scale_blob))
    return head + scale_blob + archive_io._pack_stream(stream)


def _unpack(payload: bytes) -> tuple[tuple, float, np.ndarray, np.ndarray]:
    from repro_torch.runtime import archive_io
    r = archive_io._Reader(payload, "zfp-like payload")
    if r.take(4) != _MAGIC:
        raise MalformedStream("zfp-like payload: bad magic")
    nd = r.u8()
    if not 1 <= nd <= _MAX_DIMS:
        raise MalformedStream(f"zfp-like payload: absurd rank {nd}")
    shape = struct.unpack(f"<{nd}I", r.take(4 * nd))
    tol, scale_len = struct.unpack("<dQ", r.take(16))
    if not tol > 0:
        raise MalformedStream(f"zfp-like payload: bad tolerance {tol}")
    grid = tuple((s + 3) // 4 for s in shape)
    nb = int(np.prod(grid))
    scale_raw = entropy.zlib_unpack(r.take(scale_len))
    if len(scale_raw) != nb:
        raise MalformedStream(
            f"zfp-like scale table holds {len(scale_raw)} exponents, "
            f"expected {nb}")
    log2_scale = np.frombuffer(scale_raw, np.int8)
    stream = archive_io._unpack_stream(r)
    q = (entropy.huffman_decompress(stream) if stream is not None
         else np.zeros(0, np.int64))
    want = nb * 4 ** nd
    if q.size != want:
        raise MalformedStream(
            f"zfp-like stream has {q.size} coefficients, expected {want}")
    return shape, tol, log2_scale, q.reshape(nb, 4 ** nd)


# -- legacy module-level surface --------------------------------------------

def compress(data: np.ndarray, tol: float) -> tuple[np.ndarray, int]:
    """Tolerance-targeted compression. Returns (decoded, compressed_bytes).

    ``compressed_bytes`` is the length of the REAL decodable payload
    (``ZFPLikeCodec``), not an estimate.
    """
    c = ZFPLikeCodec()
    enc = c.compress(data, tol)
    return c.decompress(enc), enc.nbytes


def compression_curve(data: np.ndarray, tols: list[float]) -> list[dict]:
    """CR / NRMSE points for a sweep of tolerances."""
    return codec_mod.compression_curve(ZFPLikeCodec(), data, tols,
                                       bound_key="tol")
