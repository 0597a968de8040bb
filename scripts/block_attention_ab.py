#!/usr/bin/env python3
"""block_attention on the card for one or more trees of the port, each in its
own process, in the order given.

    python3 scripts/block_attention_ab.py [TREE ...]

A tree is a directory holding ``src/repro_torch`` (default: this checkout);
its kernels build into ``TREE/build/kernels``.  For comparing two commits on
one card, unpack the other one into a directory that ``.gitignore`` lists
and give the trees in turns: ``block_attention_ab.py old . . old``.

Each process holds the tree's kernel to its plain version at 1e-5 and times
it (``chip_smoke.time_ms``: device ms per call over 30 calls after 3
warm-ups) at the compressor's fp32 shapes: the S3D stripe (64, 10, 128),
E3SM's (64, 5, 128), XGC's (64, 8, 128), fit_basis's pass over the S3D
field of ``chip_smoke.py`` (1600, 10, 128) and over the paper's full
640x640 field (25600, 10, 128), heads 1; one line per shape, with the bytes
bound and the device time of ``torch.addcmul(q, k, v)``, which reads and
writes the same bytes as the kernel and so shows the rate the card's
memory reaches for them.  A shape that raises is reported as such, and the
run goes on.
"""
from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((64, 10, 128), (64, 5, 128), (64, 8, 128), (1600, 10, 128),
          (25600, 10, 128))


def one(tree: str) -> int:
    import torch

    sys.path.insert(0, os.path.join(tree, "src"))
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from repro_torch.kernels.block_attention import ops as ba

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for bsz, n, d in SHAPES:
        q, k, v = (torch.randn(bsz, n, d, generator=gen, device=dev)
                   for _ in range(3))
        try:
            got = ba.block_attention(q, k, v)
            torch.testing.assert_close(got, ba.block_attention_plain(q, k, v),
                                       atol=1e-5, rtol=1e-5)
            t = cs.time_ms(torch, lambda: ba.block_attention(q, k, v))
        except Exception as e:              # the report names what raised
            print(f"tree {tree}: block_attention {(bsz, n, d)}: raised "
                  f"{type(e).__name__}: {e}", flush=True)
            continue
        b_ms, b_by = cs.bound_ms(16 * bsz * n * d,
                                 bsz * (4 * n * n * d + 5 * n * n))
        copy = cs.time_ms(torch, lambda: torch.addcmul(q, k, v))
        print(f"tree {tree}: block_attention {(bsz, n, d)} float32: device ms "
              f"{t[0]:.5f} (per call ms {t[1]:.5f}), bound {b_ms:.5f} "
              f"({b_by}), torch.addcmul over the same bytes {copy[0]:.5f}",
              flush=True)
    return 0


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        return one(os.path.abspath(argv[1]))
    rc = 0
    for tree in argv or [HERE]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", tree]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
