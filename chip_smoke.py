#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

Run from the repository root on a machine with a card:

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. environment: torch and CUDA versions, the card's name and power limit
   (``nvidia-smi``), TF32 off, and the build of every CUDA kernel from
   ``src/repro_torch/csrc/``;
2. kernel checks: each kernel against its plain PyTorch version on the card,
   at the shapes the compressor's main path gives it, with times of the
   kernel, the plain version, one PyTorch library call where there is one,
   and the card's bound for the same work;
3. main path: the S3D configuration at full width on a synthetic
   58x50x160x160 field — seeded untrained weights, ``fit_basis``,
   ``compress`` at tau 0.5, write and read the ``.rba`` archive, ``decompress``
   — with every kernel's launches counted, the tau guarantee and the disk
   round trip checked, and the first stripe held against the same path on
   the CPU;
4. one JSON line with every kernel's numbers, then the result line
   ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the result line.  Without a CUDA
device, or without the repository around it, the script exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM, dense published peaks: HBM bandwidth and fp32 outside the
# tensor cores (the kernels here use fp32 FMA only).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

TAU = 0.5
FIELD = dict(n_species=58, t=50, h=160, w=160)
FULL_FIELD = "58x50x640x640 (1.19 G values)"


class CheckFailed(Exception):
    pass


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_flops = n_flops / FP32_FLOPS
    return (max(t_bytes, t_flops) * 1e3,
            "bytes" if t_bytes >= t_flops else "operations")


def device_ms(torch, prof) -> float:
    """Summed duration of the device activities (kernels, copies) a
    ``torch.profiler`` run recorded, in ms; 0.0 when it recorded none."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == cuda) / 1e3


def time_ms(torch, fn, iters: int = 30, warmup: int = 3) -> tuple[float, float]:
    """``(device ms, call ms)`` per call of ``fn``, after ``warmup`` calls.

    device: the summed time of the kernels and copies the call ran on the
    card (torch.profiler), what the kernel's bound is compared with.  call:
    CUDA-event time over back-to-back calls, which also holds the host's
    launch overhead when that is longer than the work.  Falls back to the
    call time when the profiler records no device activity.
    """
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    call = start.elapsed_time(stop) / iters
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev = device_ms(torch, prof) / iters
    return (dev if dev > 0 else call), call


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(torch, dev) -> dict:
    """Every kernel at the main path's shapes; returns the JSON rows keyed by
    kernel name (numbers at each kernel's first, main shape)."""
    import torch.nn.functional as F

    from repro_torch.kernels.block_attention import ops as ba
    from repro_torch.kernels.gae_project import ops as gp
    from repro_torch.kernels.quantize import ops as qz

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def row(name, source, replaces, err, ms, plain, lib, n_bytes, n_flops):
        b_ms, b_by = bound_ms(n_bytes, n_flops)
        if name not in rows:
            rows[name] = {"name": name, "route": "cuda", "source": source,
                          "replaces": replaces, "launches": 0,
                          "max_abs_err": err, "ms": ms, "plain_ms": plain,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "library_ms": lib}
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
        return b_ms, b_by

    def report(name, shape, err, t, t_plain, t_lib, b_ms, b_by):
        lib_s = "none" if t_lib is None else f"{t_lib[0]:.5f} ({t_lib[1]:.5f})"
        print(f"kernel {name} {shape}: max_abs_err {err:.3e}  device ms "
              f"(per call ms): kernel {t[0]:.5f} ({t[1]:.5f})  plain "
              f"{t_plain[0]:.5f} ({t_plain[1]:.5f})  library {lib_s}  "
              f"bound {b_ms:.5f} ({b_by})", flush=True)

    # quantize: GAE coefficients (37120,80); latents per stripe (64,128),
    # (640,16); latents of fit_basis's one pass over all 1600 hyper-blocks
    # (1600,128), (16000,16)
    for shape, b in (((37120, 80), 0.01), ((64, 128), 0.005),
                     ((640, 16), 0.005), ((1600, 128), 0.005),
                     ((16000, 16), 0.005)):
        x = 0.3 * torch.randn(shape, generator=gen, device=dev)
        got = qz.quantize_fused(x, b)
        want = qz.quantize_fused_plain(x, b)
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise CheckFailed(f"quantize {shape}: kernel output is not "
                                  f"bit-identical to the plain version")
        err = 0.0
        t = time_ms(torch, lambda: qz.quantize_fused(x, b))
        t_plain = time_ms(torch, lambda: qz.quantize_fused_plain(x, b))
        n = x.numel()
        b_ms, b_by = row("quantize", "src/repro_torch/csrc/quantize.cu",
                         "src/repro/kernels/quantize/kernel.py:25", err,
                         t[0], t_plain[0], None, 16 * n, 5 * n)
        report("quantize", shape, err, t, t_plain, None, b_ms, b_by)

    # block_attention: S3D stripe (64,10,128); ragged multi-head; E3SM
    # (64,5,128); fit_basis's one pass over all of S3D (1600,10,128)
    for (bsz, n, d), heads in (((64, 10, 128), 1), ((37, 8, 128), 4),
                               ((64, 5, 128), 1), ((1600, 10, 128), 1)):
        q, k, v = (torch.randn(bsz, n, d, generator=gen, device=dev)
                   for _ in range(3))
        got = ba.block_attention(q, k, v, heads)
        want = ba.block_attention_plain(q, k, v, heads)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        err = (got - want).abs().max().item()
        dh = d // heads
        q4, k4, v4 = (t.view(bsz, n, heads, dh).transpose(1, 2).contiguous()
                      for t in (q, k, v))
        t = time_ms(torch, lambda: ba.block_attention(q, k, v, heads))
        t_plain = time_ms(torch, lambda: ba.block_attention_plain(q, k, v, heads))
        t_lib = time_ms(torch, lambda: F.scaled_dot_product_attention(q4, k4, v4))
        flops = bsz * heads * (4 * n * n * dh + 5 * n * n)
        b_ms, b_by = row("block_attention",
                         "src/repro_torch/csrc/block_attention.cu",
                         "src/repro/kernels/block_attention/kernel.py:27",
                         err, t[0], t_plain[0], t_lib[0], 4 * 4 * bsz * n * d,
                         flops)
        report("block_attention", (bsz, n, d, heads), err, t, t_plain, t_lib,
               b_ms, b_by)

    # gae_project: S3D stripe (37120,80); E3SM (4096,256); XGC (2048,1521)
    for nrows, d in ((37120, 80), (4096, 256), (2048, 1521)):
        r = torch.randn(nrows, d, generator=gen, device=dev)
        u = torch.linalg.qr(torch.randn(d, d, generator=gen, device=dev))[0]
        u = u.contiguous()
        got = gp.gae_project(r, u)
        want = gp.gae_project_plain(r, u)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=3e-5, rtol=3e-5)
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        t = time_ms(torch, lambda: gp.gae_project(r, u))
        t_plain = time_ms(torch, lambda: gp.gae_project_plain(r, u))
        t_lib = time_ms(torch, lambda: torch.matmul(r, u))   # c only, no c^2
        b_ms, b_by = row("gae_project", "src/repro_torch/csrc/gae_project.cu",
                         "src/repro/kernels/gae_project/kernel.py:25", err,
                         t[0], t_plain[0], t_lib[0],
                         4 * (nrows * d + d * d + 2 * nrows * d),
                         2 * nrows * d * d + nrows * d)
        report("gae_project", (nrows, d, d), err, t, t_plain, t_lib, b_ms,
               b_by)
    return rows


# ---------------------------------------------------------------------------
# phase 3: the compressor's main path
# ---------------------------------------------------------------------------

def run_main_path(torch, dev, counters) -> dict:
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import exec as exec_mod
    from repro_torch.core.options import CompressOptions
    from repro_torch.core.pipeline import HierarchicalCompressor
    from repro_torch.data import synthetic
    from repro_torch.runtime import archive_io

    t0 = time.perf_counter()
    cfg, hb = synthetic.make_dataset("s3d", quick=False, seed=0, field=FIELD)
    print(f"main path: S3D config block {cfg.block_elems}, k {cfg.k}, emb "
          f"{cfg.emb}, hidden {cfg.hidden}, hb_latent {cfg.hb_latent}, "
          f"bae_hidden {cfg.bae_hidden}, bae_latent {cfg.bae_latent}, GAE "
          f"blocks of {cfg.gae_block_elems}", flush=True)
    print(f"main path: field cut from {FULL_FIELD} to "
          f"{FIELD['n_species']}x{FIELD['t']}x{FIELD['h']}x{FIELD['w']} "
          f"({hb.size / 1e6:.1f} M values, {hb.shape[0]} hyper-blocks) "
          f"because the host GAE/entropy coders and the generator would "
          f"exceed the run's time limit at full size; generated in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    comp = HierarchicalCompressor(cfg)           # the card, by default
    comp.init_params(seed=0)
    exec_mod.reset_stage_stats()
    for c in counters.values():
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp, \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        path = os.path.join(tmp, "s3d.rba")
        t0 = time.perf_counter()
        comp.fit_basis(hb)
        archive = comp.compress(hb, options=CompressOptions(tau=TAU))
        written = archive_io.write_archive(archive, path)
        recon = comp.decompress(archive_io.read_archive(path))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: c.value for name, c in counters.items()}
        stats = exec_mod.stats_summary()
    recon_mem = comp.decompress(archive)

    busy = device_ms(torch, prof) / 1e3
    busy_s = (f"device busy {busy:.3f} s, idle share {1 - busy / wall:.4f}"
              if busy > 0 else "device busy not measured (no profiler events)")
    print(f"main path: wall {wall:.3f} s for fit_basis + compress + write + "
          f"read + decompress of {hb.size} values; {busy_s}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    print("main path stage stats (seconds summed over the codec pool's "
          "threads):\n" + stats, flush=True)
    print(f"main path: {len(archive.chunks)} chunks, {written} bytes on "
          f"disk, compression ratio {archive.compression_ratio():.4f} "
          f"(untrained AE, not a result)", flush=True)
    print(f"main path launches: {json.dumps(launches)}", flush=True)

    for name, n in launches.items():
        if n <= 0:
            raise CheckFailed(f"kernel {name} was not launched on the main path")
    if recon.shape != hb.shape or not np.isfinite(recon).all():
        raise CheckFailed(f"decompress gave shape {recon.shape} or "
                          f"non-finite values")
    errs = np.linalg.norm((hb - recon).reshape(-1, cfg.gae_block_elems), axis=1)
    print(f"main path: {errs.size} GAE blocks, max l2 error "
          f"{errs.max():.6f} (tau {TAU})", flush=True)
    if errs.max() > TAU * (1 + 1e-5):
        raise CheckFailed(f"GAE block error {errs.max()} exceeds tau {TAU}")
    if not np.array_equal(recon, recon_mem):
        raise CheckFailed("decode from disk differs from the in-memory decode")

    # the first stripe against the same path on the CPU (plain versions)
    cpu = HierarchicalCompressor(cfg, device="cpu")
    cpu.hbae_params = _to_cpu(comp.hbae_params)
    cpu.bae_params = [_to_cpu(p) for p in comp.bae_params]
    stripe = hb[:64]
    g_lh, g_lbs, g_rec = comp.encode_stripe_device(stripe)
    c_lh, c_lbs, _ = cpu.encode_stripe_device(stripe)
    for g, c in zip([g_lh] + g_lbs, [c_lh] + c_lbs):
        diff = np.abs(g.astype(np.int64) - c)
        if diff.max() > 1 or np.count_nonzero(diff) > 0.001 * diff.size:
            raise CheckFailed(f"stripe latents differ from the CPU path: "
                              f"{np.count_nonzero(diff)} of {diff.size}")
    c_rec = exec_mod.run_decompress_stage(cpu.hbae_params, cpu.bae_params,
                                          g_lh, g_lbs, cfg.hb_bin, cfg.bae_bin)
    rec_err = float(np.abs(c_rec - g_rec).max())
    print(f"main path: first stripe vs CPU path: latents within one bin, "
          f"reconstruction max abs diff {rec_err:.3e}", flush=True)
    if not np.allclose(c_rec, g_rec, atol=1e-4, rtol=1e-4):
        raise CheckFailed(f"stripe reconstruction differs from the CPU path "
                          f"by {rec_err}")
    return launches


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu() if hasattr(tree, "cpu") else tree


# ---------------------------------------------------------------------------

def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device: this script measures the port on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.kernels import build
        from repro_torch.kernels.block_attention import ops as ba
        from repro_torch.kernels.gae_project import ops as gp
        from repro_torch.kernels.quantize import ops as qz
    except ImportError as e:
        print(f"FAIL: the port's package is not beside this script: {e}",
              file=sys.stderr)
        return 3

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(f"env: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)
    print("env: card name, power limit (nvidia-smi):", flush=True)
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.build_all()
    print(f"env: built {', '.join(build.KERNELS)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    try:
        rows = check_kernels(torch, dev)
        counters = {"quantize": qz.launches, "block_attention": ba.launches,
                    "gae_project": gp.launches}
        launches = run_main_path(torch, dev, counters)
    except (CheckFailed, AssertionError) as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    for name, n in launches.items():
        rows[name]["launches"] = n
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
