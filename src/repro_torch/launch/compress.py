"""Compression driver: the paper's pipeline end to end on a synthetic dataset
with the exact S3D/E3SM/XGC geometry, on the card by default: fit HBAE+BAE,
compress with a user error bound, verify the per-block guarantee, report
CR + NRMSE.

  python -m repro_torch.launch.compress --dataset s3d --tau 0.5 --quick
  python -m repro_torch.launch.compress --dataset e3sm --quick \\
      --out /tmp/a.rba --verify --device cpu

``--out`` writes the durable .rba container (the JAX package's format, byte
for byte); ``--verify`` re-reads it from disk and re-checks the tau
guarantee against the freshly decoded bytes.  Exit codes: 0 on success, 2 on
a guarantee violation (and, from argparse, on a bad command line), 3 when
the container cannot be written or the disk re-read fails, differs from the
in-memory decode or breaks tau.

``--stream``, ``--queue-depth``, ``--retries``, ``--stage-deadline``,
``--chaos`` and ``--mesh`` are the JAX package's streaming, fault-tolerance
and sharding paths, not ported yet: they are refused at parse time, before
any training.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch.core import exec as exec_mod
from repro_torch.core.errors import ArchiveError, ConfigError
from repro_torch.core.options import CompressOptions
from repro_torch.core.pipeline import HierarchicalCompressor, unported_options
from repro_torch.data import synthetic
from repro_torch.data.blocks import nrmse

_FLAGS = {"stream": "--stream", "queue_depth": "--queue-depth",
          "retries": "--retries", "stage_deadline_s": "--stage-deadline",
          "chaos_seed": "--chaos", "mesh": "--mesh"}


def _max_block_err(hyperblocks: np.ndarray, recon: np.ndarray,
                   d_gae: int) -> np.ndarray:
    x = hyperblocks.reshape(-1, d_gae)
    r = recon.reshape(-1, d_gae)
    return np.linalg.norm(x - r, axis=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="s3d", choices=("s3d", "e3sm", "xgc"))
    ap.add_argument("--tau", type=float, default=0.5,
                    help="per-block l2 bound (normalized domain)")
    ap.add_argument("--quick", action="store_true",
                    help="smaller field + fewer epochs (CI-speed)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", default="", help="write the fitted model "
                    "(manifest+npz, hash-verified on load)")
    ap.add_argument("--out", default="",
                    help="write the compressed archive container (.rba)")
    ap.add_argument("--verify", action="store_true",
                    help="re-read --out from disk and re-check the guarantee")
    ap.add_argument("--chunk-hyperblocks", type=int, default=64,
                    help="container stripe width (corruption blast radius)")
    ap.add_argument("--epochs-scale", type=float, default=None,
                    help="scale train epochs (e.g. 0.1 for smoke tests)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--stream", action="store_true",
                    help="pipelined compress: not ported yet, refused")
    ap.add_argument("--queue-depth", type=int, default=2,
                    help="--stream queue bound: not ported yet, refused")
    ap.add_argument("--retries", type=int, default=None,
                    help="--stream fault tolerance: not ported yet, refused")
    ap.add_argument("--stage-deadline", type=float, default=None,
                    help="--stream watchdog: not ported yet, refused")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="--stream chaos drill: not ported yet, refused")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="sharded stage programs: not ported yet, refused")
    args = ap.parse_args(argv)
    if args.verify and not args.out:
        ap.error("--verify requires --out")
    if (args.retries is not None or args.stage_deadline is not None
            or args.chaos is not None) and not args.stream:
        ap.error("--retries/--stage-deadline/--chaos require --stream")
    try:
        opts = CompressOptions(
            tau=args.tau, chunk_hyperblocks=args.chunk_hyperblocks,
            stream=args.stream, queue_depth=args.queue_depth,
            retries=args.retries, stage_deadline_s=args.stage_deadline,
            chaos_seed=args.chaos, mesh=args.mesh)
    except ConfigError as e:
        ap.error(str(e))
    unported = unported_options(opts)
    if unported:
        ap.error(f"{', '.join(_FLAGS[f] for f in unported)}: not ported to "
                 f"the PyTorch compressor yet")
    try:
        device = exec_mod.resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    cfg, hyperblocks = synthetic.make_dataset(args.dataset, quick=args.quick,
                                              seed=args.seed,
                                              epochs_scale=args.epochs_scale)
    print(f"{args.dataset}: {hyperblocks.shape[0]} hyper-blocks of "
          f"(k={hyperblocks.shape[1]}, D={hyperblocks.shape[2]})")

    t0 = time.time()
    comp = HierarchicalCompressor(cfg, device=device).fit(
        hyperblocks, seed=args.seed,
        log=lambda s, l: print(f"  step {s}: mse {l:.3e}"))
    print(f"fit in {time.time() - t0:.1f}s")

    exec_mod.reset_stage_stats()
    archive = comp.compress(hyperblocks, options=opts)
    recon = comp.decompress(archive)
    print("-- hot-path stage throughput --")
    print(exec_mod.stats_summary())

    # hard per-block guarantee check
    d_gae = cfg.gae_block_elems or cfg.block_elems
    errs = _max_block_err(hyperblocks, recon, d_gae)
    if float(errs.max()) > args.tau * (1 + 1e-5):
        bad = int(np.sum(errs > args.tau * (1 + 1e-5)))
        print(f"ERROR: tau guarantee violated on {bad}/{errs.size} GAE "
              f"blocks (max l2 {errs.max():.6f} > tau={args.tau})",
              file=sys.stderr)
        return 2

    print(f"compression ratio: {archive.compression_ratio():.1f}x  "
          f"(+model cost: "
          f"{archive.compression_ratio(comp.model_bytes()):.1f}x)")
    print(f"NRMSE: {nrmse(hyperblocks, recon):.3e}")
    print(f"max per-block l2: {errs.max():.4f} <= tau={args.tau}")

    from repro_torch.runtime import archive_io
    if args.out:
        try:
            nbytes = archive_io.write_archive(archive, args.out)
        except OSError as e:
            print(f"ERROR: cannot write container: {e}", file=sys.stderr)
            return 3
        print(f"container written to {args.out} "
              f"({nbytes:,} bytes = {len(archive.chunks)} chunks; "
              f"on-disk ratio {hyperblocks.size * 4 / nbytes:.1f}x)")
    if args.verify:
        try:
            recon2 = comp.decompress(archive_io.read_archive(args.out))
        except ArchiveError as e:
            print(f"ERROR: verification re-read failed: {e}", file=sys.stderr)
            return 3
        errs2 = _max_block_err(hyperblocks, recon2, d_gae)
        if not np.array_equal(recon2, recon):
            print("ERROR: on-disk decode differs from in-memory decode",
                  file=sys.stderr)
            return 3
        if float(errs2.max()) > args.tau * (1 + 1e-5):
            print(f"ERROR: tau guarantee violated after disk round-trip "
                  f"(max l2 {errs2.max():.6f})", file=sys.stderr)
            return 3
        print(f"verify OK: disk round-trip bit-exact, "
              f"max per-block l2 {errs2.max():.4f} <= tau={args.tau}")
    if args.save:
        comp.save(args.save)
        print(f"model saved to {args.save}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
