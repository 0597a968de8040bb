"""Unified baseline codec surface.

The port's copy of the JAX package's ``repro.baselines.codec`` (numpy).
Every baseline speaks the :class:`Codec` protocol:

* ``compress(data, bound) -> Encoded`` — a self-contained opaque payload;
  ``Encoded.nbytes`` is ``len(payload)``, the honest storage cost of
  something that can genuinely be decoded, not an accounting guess.
* ``decompress(enc) -> np.ndarray`` — decodes the payload alone (plus
  whatever model state the codec object itself carries, e.g. the block-AE
  weights — mirroring how the main pipeline ships model cost separately).

``compression_curve`` is the one CR/NRMSE sweep implementation; it
round-trips through ``decompress`` so a curve can never quote a ratio for
bytes that don't decode.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, Sequence, runtime_checkable

import numpy as np


@dataclasses.dataclass(frozen=True)
class Encoded:
    """One baseline compression result: an opaque, self-describing payload.

    ``payload`` contains everything the producing codec needs to decode
    (header, shapes, bounds, entropy streams) — pass it back to the SAME
    codec's ``decompress``.
    """
    codec: str          # name of the codec that produced it
    payload: bytes

    @property
    def nbytes(self) -> int:
        return len(self.payload)


@runtime_checkable
class Codec(Protocol):
    """The one surface every baseline compressor speaks."""
    name: str

    def compress(self, data: np.ndarray, bound: float) -> Encoded:
        """Encode ``data`` under the codec's error/size knob ``bound``."""
        ...

    def decompress(self, enc: Encoded) -> np.ndarray:
        """Decode a payload this codec produced back to an array."""
        ...


def roundtrip(codec: Codec, data: np.ndarray, bound: float
              ) -> tuple[np.ndarray, Encoded]:
    """Compress + decompress in one call: ``(decoded, enc)``."""
    enc = codec.compress(data, bound)
    return codec.decompress(enc), enc


def compression_curve(codec: Codec, data: np.ndarray,
                      bounds: Sequence[float], bound_key: str = "eb"
                      ) -> list[dict]:
    """CR / NRMSE points for a sweep of ``bounds``, computed from the REAL
    decoded payloads (every quoted ratio is for bytes that decode)."""
    from repro_torch.data.blocks import nrmse
    out = []
    for b in bounds:
        dec, enc = roundtrip(codec, data, b)
        out.append({bound_key: b, "cr": data.size * 4 / enc.nbytes,
                    "nrmse": float(nrmse(data, dec))})
    return out
