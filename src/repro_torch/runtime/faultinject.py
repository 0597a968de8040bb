"""Corruption injector + containment checker for the archive container.

Four corruption models, mirroring how storage actually fails:

* ``bit_flip``    — 1..8 random bit flips anywhere in the file (media decay)
* ``truncate``    — file cut at a random point (torn write / partial upload)
* ``zero_chunk``  — a random span zeroed (lost disk sector / hole punch)
* ``header_fuzz`` — random bytes splatted over the header + section table

``check_containment`` drives seeded corruptions through the reader and
asserts the contract the tests rely on: every corruption is
either *detected* (typed ``ArchiveError``) or *survived* (tolerant read
returns an archive whose damage is confined to reported chunks).  Any other
exception — raw ``struct.error``, ``zlib.error``, ``IndexError`` — is an
escape and fails the run.

CLI::

    python -m repro_torch.runtime.faultinject /tmp/a.rba --trials 40 --seed 0
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Callable, Optional

import numpy as np

from repro_torch.core.errors import ArchiveError
from repro_torch.runtime import archive_io

CORRUPTION_KINDS = ("bit_flip", "truncate", "zero_chunk", "header_fuzz")


def corrupt(data: bytes, kind: str, rng: np.random.Generator) -> bytes:
    """Return a corrupted copy of ``data`` under the given failure model."""
    buf = bytearray(data)
    if kind == "bit_flip":
        for _ in range(int(rng.integers(1, 9))):
            pos = int(rng.integers(0, len(buf)))
            buf[pos] ^= 1 << int(rng.integers(0, 8))
    elif kind == "truncate":
        buf = buf[:int(rng.integers(0, len(buf)))]
    elif kind == "zero_chunk":
        span = int(rng.integers(16, 513))
        pos = int(rng.integers(0, max(1, len(buf) - span)))
        buf[pos:pos + span] = b"\x00" * min(span, len(buf) - pos)
    elif kind == "header_fuzz":
        head = min(len(buf), archive_io._PROLOGUE.size + 256)
        for _ in range(int(rng.integers(1, 17))):
            pos = int(rng.integers(0, head))
            buf[pos] = int(rng.integers(0, 256))
    else:
        raise ValueError(f"unknown corruption kind {kind!r}")
    return bytes(buf)


@dataclasses.dataclass
class Trial:
    kind: str
    outcome: str          # "detected" | "survived" | "noop" | "escaped"
    detail: str = ""


@dataclasses.dataclass
class FuzzResult:
    trials: list[Trial]

    @property
    def escapes(self) -> list[Trial]:
        return [t for t in self.trials if t.outcome == "escaped"]

    @property
    def ok(self) -> bool:
        return not self.escapes

    def summary(self) -> str:
        counts: dict[str, int] = {}
        for t in self.trials:
            key = f"{t.kind}:{t.outcome}"
            counts[key] = counts.get(key, 0) + 1
        lines = [f"{len(self.trials)} trials, {len(self.escapes)} escapes"]
        lines += [f"  {k}: {v}" for k, v in sorted(counts.items())]
        lines += [f"  ESCAPE {t.kind}: {t.detail}" for t in self.escapes]
        return "\n".join(lines)


def check_containment(data: bytes, *, trials: int = 32, seed: int = 0,
                      decode: Optional[Callable] = None) -> FuzzResult:
    """Run seeded corruptions of a valid container through both read modes.

    ``decode``: optional callable ``decode(archive) -> None`` that runs the
    model-side tolerant decompression (when a fitted compressor is on hand);
    it must not raise for a tolerantly-read archive.
    """
    out: list[Trial] = []
    for t in range(trials):
        rng = np.random.default_rng(seed * 100003 + t)
        kind = CORRUPTION_KINDS[t % len(CORRUPTION_KINDS)]
        bad = corrupt(data, kind, rng)
        if bad == data:
            out.append(Trial(kind, "noop"))
            continue
        # strict mode: corruption must be detected with a typed error
        try:
            archive_io.deserialize_archive(bad, strict=True)
            # undetected change: only legal if it truly cannot alter decode
            out.append(Trial(kind, "escaped", "strict read accepted a "
                                              "modified container"))
            continue
        except ArchiveError as e:
            strict_detail = type(e).__name__
        except Exception as e:   # raw struct/zlib/index error leaked through
            out.append(Trial(kind, "escaped", f"strict: {e!r}"))
            continue
        # tolerant mode: must yield a damage-scoped archive or a typed error
        try:
            archive = archive_io.deserialize_archive(bad, strict=False)
            if decode is not None:
                decode(archive)
            out.append(Trial(kind, "survived",
                             f"{strict_detail}; "
                             f"{len(archive.chunk_errors)} chunks damaged"))
        except ArchiveError:
            out.append(Trial(kind, "detected", strict_detail))
        except Exception as e:
            out.append(Trial(kind, "escaped", f"tolerant: {e!r}"))
    return FuzzResult(trials=out)


def check_partial_containment(data: bytes, *, trials: int = 32, seed: int = 0,
                              decode: Optional[Callable] = None) -> FuzzResult:
    """Fuzz the streaming ``.partial`` salvage path.

    A ``<path>.partial`` left by an aborted ``StreamingArchiveWriter`` is not
    a valid container (placeholder table entries never verify), so the strict
    leg of ``check_containment`` does not apply.  The contract here is
    tolerant-read only: every corruption of a partial must yield either a
    damage-scoped archive (``survived``) or a typed ``ArchiveError``
    (``detected``) — never a raw ``struct``/``zlib``/``IndexError`` escape.
    """
    out: list[Trial] = []
    for t in range(trials):
        rng = np.random.default_rng(seed * 100003 + t)
        kind = CORRUPTION_KINDS[t % len(CORRUPTION_KINDS)]
        bad = corrupt(data, kind, rng) if t else data   # trial 0: as-is
        kind = kind if t else "as_left_on_disk"
        try:
            archive = archive_io.deserialize_archive(bad, strict=False)
            if decode is not None:
                decode(archive)
            out.append(Trial(kind, "survived",
                             f"{len(archive.chunk_errors)} chunks damaged"))
        except ArchiveError as e:
            out.append(Trial(kind, "detected", type(e).__name__))
        except Exception as e:
            out.append(Trial(kind, "escaped", f"tolerant: {e!r}"))
    return FuzzResult(trials=out)


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="seeded corruption-fuzz a .rba archive container")
    ap.add_argument("archive", help="path to a valid .rba container "
                                    "(or a .partial with --partial)")
    ap.add_argument("--trials", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--partial", action="store_true",
                    help="treat the input as a streaming-writer .partial: "
                         "skip the strict-validity precheck and fuzz the "
                         "tolerant salvage path only")
    args = ap.parse_args(argv)
    try:
        with open(args.archive, "rb") as f:
            data = f.read()
        if not args.partial:
            # the corpus must start from a valid container
            archive_io.deserialize_archive(data, strict=True)
    except (OSError, ArchiveError) as e:
        print(f"error: {args.archive}: not a valid container: {e}",
              file=sys.stderr)
        return 2
    if args.partial:
        result = check_partial_containment(data, trials=args.trials,
                                           seed=args.seed)
    else:
        result = check_containment(data, trials=args.trials, seed=args.seed)
    print(result.summary())
    if not result.ok:
        print("FAIL: corruption escaped the typed-error contract",
              file=sys.stderr)
        return 1
    print("OK: every corruption detected or survived")
    return 0


if __name__ == "__main__":
    sys.exit(main())
