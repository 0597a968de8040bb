#!/usr/bin/env python3
"""ssd_scan on the card for one or more trees of the port, each in its own
process, in the order given.

    python3 scripts/ssd_scan_ab.py [TREE ...]

A tree is a directory holding ``src/repro_torch`` (default: this checkout);
its kernels build into ``TREE/build/kernels``.  For comparing two commits on
one card, unpack the other one into a directory that ``.gitignore`` lists
and give the trees in turns: ``ssd_scan_ab.py old . . old``.

Each process makes the same seeded inputs (as ``chip_smoke.py`` makes
them), holds the tree's kernel to its plain version at 3e-4 of the
output's scale and times it (``chip_smoke.time_ms``: device ms per call
over 10 calls after 3 warm-ups, and by CUDA kernel) at the mamba2-370m
prefill shape (B 1, S 4096, H 32, P 64, G 1, N 128, chunk 256) and the same
with N 256.  A shape that raises is reported as such, and the run goes on.
"""
from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((1, 4096, 32, 64, 1, 128, 256), (1, 4096, 32, 64, 1, 256, 256))


def one(tree: str) -> int:
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, os.path.join(tree, "src"))
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from repro_torch.kernels.ssd_scan import ops as sd

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    for b, s, h, p, g, n, chunk in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(b, s, h, p, generator=gen, device=dev)
        dt = F.softplus(torch.randn(b, s, h, generator=gen, device=dev))
        a_log = torch.rand(h, generator=gen, device=dev)
        bm = torch.randn(b, s, g, n, generator=gen, device=dev)
        cm = torch.randn(b, s, g, n, generator=gen, device=dev)
        args = (x, dt, a_log, bm, cm)
        shape = (b, s, h, p, g, n, chunk)
        parts = {}
        try:
            for got, want in zip(sd.ssd(*args, chunk=chunk),
                                 sd.ssd_plain(*args, chunk=chunk)):
                scale = max(1.0, want.abs().max().item())
                torch.testing.assert_close(got, want, atol=3e-4 * scale,
                                           rtol=3e-4)
            t = cs.time_ms(torch, lambda: sd.ssd(*args, chunk=chunk),
                           iters=10, by_name=parts, match="ssd")
        except Exception as e:              # the report names what raised
            print(f"tree {tree}: ssd_scan {shape}: raised "
                  f"{type(e).__name__}: {e}", flush=True)
            continue
        print(f"tree {tree}: ssd_scan {shape} float32: device ms {t[0]:.5f} "
              f"(per call ms {t[1]:.5f}); by CUDA kernel: " + ", ".join(
                  f"{k} {v:.5f}" for k, v in parts.items()), flush=True)
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
