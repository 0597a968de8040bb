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

``--stream`` runs the pipelined compress path (repro_torch.stream): host
GAE/entropy coding of chunk *i* overlaps the device stage of chunk *i+1*,
and with ``--out`` finished chunk sections stream to disk as they complete
(crash-safe ``<out>.partial``, atomic finalize; exit 3 when the streaming
write fails).  The container is byte-identical to the batch path's.
``--retries``, ``--stage-deadline`` and ``--chaos`` arm its fault-tolerance
ladder and need ``--stream``.

``--mesh N`` runs the compress and both decompressions sharded over N
devices (``repro_torch.parallel.mesh_exec``); the archive stays
byte-identical to the single-device run.  A mesh the machine cannot hold
(more shards than devices, as ``--mesh 2`` on one card) exits 2 before any
training.  Several shards on one device are reached from Python, with
``make_compress_mesh(devices=[...])``.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch.core import exec as exec_mod
from repro_torch.core.errors import ArchiveError, ConfigError
from repro_torch.core.options import CompressOptions
from repro_torch.core.pipeline import HierarchicalCompressor
from repro_torch.data import synthetic
from repro_torch.data.blocks import nrmse
from repro_torch.parallel.mesh_exec import resolve_mesh


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
                    help="pipelined compress (device/host overlap); with "
                    "--out, chunk sections stream to disk as they finish")
    ap.add_argument("--queue-depth", type=int, default=2,
                    help="--stream inter-stage queue bound (backpressure)")
    ap.add_argument("--retries", type=int, default=None,
                    help="--stream fault tolerance: per-item transient-"
                    "failure retries (seeded backoff); enables the "
                    "quarantine fallback for permanently failing stripes")
    ap.add_argument("--stage-deadline", type=float, default=None,
                    help="--stream per-attempt watchdog deadline in seconds "
                    "for the compute stages (implies --retries)")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="--stream chaos drill: inject seeded transient "
                    "faults into the live pipeline (implies fault "
                    "tolerance); the run must still honor tau")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="run the stages sharded over an N-device mesh "
                    "(hyper-block data axis); archives stay byte-identical "
                    "to single-device runs")
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
    try:
        device = exec_mod.resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    try:
        resolve_mesh(opts.mesh, device=device)  # fail fast on impossible meshes
    except ConfigError as e:
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
    streamed_bytes = 0
    if opts.stream:
        from repro_torch.stream import stream_compress
        try:
            # fault tolerance + chaos arm themselves from opts (retries /
            # stage_deadline_s / chaos_seed)
            result = stream_compress(comp, hyperblocks, options=opts,
                                     out_path=args.out or None)
        except OSError as e:
            print(f"ERROR: streaming write failed: {e}", file=sys.stderr)
            return 3
        archive, streamed_bytes = result.archive, result.bytes_written
        s = result.stats
        print(f"stream: {s.n_items} items -> {len(archive.chunks)} chunks "
              f"in {s.wall_s:.2f}s, stage overlap {s.overlap_s:.2f}s "
              f"({s.overlap_efficiency() * 100:.0f}% of wall), "
              f"queue high-water {s.queue_high_water}")
        if opts.fault_tolerant():
            print(f"fault tolerance: {s.total_retries()} retries "
                  f"{dict(s.retries)}, deadline hits "
                  f"{dict(s.deadline_hits)}, failovers {dict(s.failovers)}")
        if opts.chaos_seed is not None:
            print(f"chaos injected: {result.chaos_injected}")
        if result.quarantined:
            print(f"QUARANTINED {len(result.quarantined)} chunk(s) "
                  f"{result.quarantined}: re-encoded as lossless verbatim "
                  f"fallback (tau holds trivially)")
            for ci in result.quarantined:
                print(f"  chunk {ci}: {result.quarantine_reasons.get(ci, '?')}")
    else:
        archive = comp.compress(hyperblocks, options=opts)
    recon = comp.decompress(archive, mesh=opts.mesh)
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
    if args.out and args.stream:
        # already on disk: the streaming writer finalized it chunk by chunk
        print(f"container streamed to {args.out} "
              f"({streamed_bytes:,} bytes = {len(archive.chunks)} chunks; "
              f"on-disk ratio {hyperblocks.size * 4 / streamed_bytes:.1f}x)")
    elif args.out:
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
            # same mesh as the first decode: bit-exact comparability
            recon2 = comp.decompress(archive_io.read_archive(args.out),
                                     mesh=opts.mesh)
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
