#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

Run from the repository root on a machine with a card:

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. environment: torch and CUDA versions, the card's name and power limit
   (``nvidia-smi``), TF32 off, and the build of every CUDA kernel from
   ``src/repro_torch/csrc/``;
2. kernel checks: each kernel against its plain PyTorch version on the card,
   at the shapes the compressor's main path and the LM prefill and serve
   runs give it, with
   times of the kernel, the plain version, one PyTorch library call where
   there is one, and the card's bound for the same work; ssd_scan's four
   CUDA kernels are also each held to their plain phase and timed by name;
   flash_attention and block_attention run in fp32 and bf16; the card's
   launch floor (a one-element ``torch.add_``) is printed; quantize also
   takes bf16 and is held bit for bit to the fp32 formula; and the gates of
   the redesigned kernels hold: block_attention at the S3D stripe
   (64, 10, 128) at most 0.0042 ms (or 1.5x the launch floor, where that is
   above it), at (1600, 10, 128) at most 2.0x its bytes bound, and at both
   no slower than ``scaled_dot_product_attention`` in turns;
   flash_attention bf16 at most 2.0x ``scaled_dot_product_attention`` in
   turns, fp32 at most 2.0 ms and faster than it, ssd_scan at most
   0.72 ms, gae_project at most 1.10x ``torch.matmul`` in turns;
3. gradients: through each kernel's ``torch.autograd.Function`` against
   autograd through its plain version on the card — ``wq``, ``wk``, ``wv``
   and ``wo`` of one ``self_attention`` call at the S3D stripe
   (block_attention), and q, k, v of flash_attention and the five inputs of
   ssd_scan at small shapes — at 1e-5 of the largest gradient; and the
   device time of block_attention's forward (the kernel) and backward (its
   plain formula) at the stripe;
4. fit: ``HierarchicalCompressor.fit`` of the S3D configuration at full
   width on the main path's field (30 HBAE epochs of 25 steps, then 30 BAE
   epochs of 62 steps, Adam), with the wall and steps/s of each stage, the
   first and last logged loss, block_attention launched exactly twice per
   HBAE step plus twice for the residual pass, the last logged HBAE loss at
   most 1 / ``FIT_LOSS_DROP_MIN`` of the first, device busy time and idle
   share over a profiled window of ``PROFILE_STEPS`` HBAE steps, and one
   HBAE step on the card held to the same step on the CPU (the loss at
   1e-5, every gradient at 1e-5 of its leaf's largest, the params within
   Adam's first-step bound, as ``tests/test_torch_training.py`` holds them);
5. main path: the fitted model on the same synthetic 58x50x160x160 field —
   ``fit_basis``, ``compress`` at tau 0.5, write and read the ``.rba``
   archive, ``decompress`` — with every kernel's launches counted, the tau
   guarantee and the disk round trip checked, and the first stripe held
   against the same path on the CPU;
6. the launcher: ``python -m repro_torch.launch.compress --dataset e3sm
   --quick --epochs-scale 0.25 --out <tmp> --verify`` as a subprocess, which
   must exit 0 and print "verify OK";
7. LM path, for qwen2-1.5b and mamba2-370m at full width with seeded
   weights: ``forward`` over 1 x 4096 random tokens (the prefill, with its
   kernel launched once per layer) in fp32 and then with
   ``compute_dtype="bfloat16"``; the bf16 prefill's last 64 logits through
   the kernel are held to those through its plain version (both against
   the fp32 prefill's); ``forward``'s last logits against the
   serving engine's decode-step prefill on a 64-token prompt, the device
   time of one ``decode_step`` against its wall, and ``ServeEngine.serve``
   on 8 requests with raw KV and with ``kv_tau`` 0.05;
8. one JSON line with every kernel's numbers (one row per kernel and
   dtype), then the result line
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

# NVIDIA H100 SXM, dense published peaks: HBM bandwidth, fp32 outside the
# tensor cores (the kernels here use fp32 FMA only), and bf16 in the tensor
# cores (the peak for bf16 inputs).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12

# Gates on the two kernels redesigned for this card.  ssd_scan at the
# mamba2-370m shape takes at most half of its first port's 1.447 ms (device
# ms on an H100 80GB HBM3 at 700 W), and is faster than its plain version at
# every shape checked.  gae_project at the S3D shape may take at most 1.10x
# torch.matmul's median device time when the two are timed in turns; the
# redesign measured 0.92x, and the margin absorbs the rounds' spread.
SSD_MAMBA2_MS_MAX = 0.72
GAE_OVER_MATMUL_MAX = 1.10
# flash_attention at the qwen2-1.5b prefill shape, as redesigned for this
# card: in bf16 (tensor cores) at most 2.0x scaled_dot_product_attention's
# median when the two are timed in turns (PR 12's SIMT kernel was 23x); in
# fp32 at most 2.0 ms (PR 12's was 2.609 ms) and faster than SDPA in fp32.
FA_BF16_OVER_SDPA_MAX = 2.0
FA_F32_MS_MAX = 2.0
# block_attention, redesigned for this card: at the S3D stripe (64, 10, 128)
# at most half of the first port's 0.00844 ms (device ms on an H100 80GB
# HBM3 at 700 W), or 1.5x the card's launch floor where that floor is above
# it; at fit_basis's (1600, 10, 128) at most 2.0x its bytes bound; at both no
# slower than scaled_dot_product_attention timed in turns.
BA_STRIPE_MS_MAX = 0.0042
BA_FIT_OVER_BOUND_MAX = 2.0
BA_OVER_SDPA_MAX = 1.0

# Training.  The fit runs the S3D configuration's own 30 HBAE and 30 BAE
# epochs.  The last logged HBAE loss (step 700) must be at most
# 1 / FIT_LOSS_DROP_MIN of the first (step 0): the first run on an H100 80GB
# HBM3 at 700 W fell 22.85x (1.828e-2 to 7.998e-4); the gate keeps a
# margin of 2.3x below that.
FIT_LOSS_DROP_MIN = 10.0
PROFILE_STEPS = 50
LR, EPS = 1e-3, 1e-8        # the configuration's Adam

TAU = 0.5
KV_TAU = 0.05       # the LM serve run's per-token bound on the KV cache
FIELD = dict(n_species=58, t=50, h=160, w=160)
FULL_FIELD = "58x50x640x640 (1.19 G values)"


class CheckFailed(Exception):
    pass


def bound_ms(n_bytes: float, n_flops: float,
             peak: float = FP32_FLOPS) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_flops = n_flops / peak
    return (max(t_bytes, t_flops) * 1e3,
            "bytes" if t_bytes >= t_flops else "operations")


def device_ms(torch, prof) -> float:
    """Summed duration of the device activities (kernels, copies) a
    ``torch.profiler`` run recorded, in ms; 0.0 when it recorded none."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == cuda) / 1e3


def device_ms_by_name(torch, prof, match: str) -> dict:
    """Summed device ms of each CUDA kernel whose name holds ``match``, keyed
    by the kernel's identifier (``ssd_chunk_scan_kernel``, ...)."""
    import re

    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and match in e.name:
            found = re.search(r"\w*" + re.escape(match) + r"\w*", e.name)
            key = found.group(0) if found else e.name
            out[key] = out.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
    return out


def time_ms(torch, fn, iters: int = 30, warmup: int = 3,
            by_name: dict | None = None,
            match: str = "") -> tuple[float, float]:
    """``(device ms, call ms)`` per call of ``fn``, after ``warmup`` calls.

    device: the summed time of the kernels and copies the call ran on the
    card (torch.profiler), what the kernel's bound is compared with.  call:
    CUDA-event time over back-to-back calls, which also holds the host's
    launch overhead when that is longer than the work.  Falls back to the
    call time when the profiler records no device activity.  ``by_name``,
    where given, receives the device ms per call of each CUDA kernel whose
    name holds ``match``.
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
    if by_name is not None:
        by_name.update({k: v / iters for k, v in
                        device_ms_by_name(torch, prof, match).items()})
    return (dev if dev > 0 else call), call


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(torch, dev) -> dict:
    """Every kernel at the main path's shapes; returns the JSON rows keyed by
    kernel name (numbers at each kernel's first, main shape)."""
    import torch.nn.functional as F

    from repro_torch.kernels.block_attention import ops as ba
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.gae_project import ops as gp
    from repro_torch.kernels.quantize import ops as qz
    from repro_torch.kernels.ssd_scan import ops as sd

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def row(name, source, replaces, err, ms, plain, lib, n_bytes, n_flops,
            peak=FP32_FLOPS, dtype="float32"):
        b_ms, b_by = bound_ms(n_bytes, n_flops, peak)
        if (name, dtype) not in rows:
            rows[name, dtype] = {
                "name": name, "dtype": dtype, "route": "cuda",
                "source": source, "replaces": replaces, "launches": 0,
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
        rows[name, dtype]["max_abs_err"] = max(
            rows[name, dtype]["max_abs_err"], err)
        return b_ms, b_by

    def report(name, shape, err, t, t_plain, t_lib, b_ms, b_by):
        lib_s = "none" if t_lib is None else f"{t_lib[0]:.5f} ({t_lib[1]:.5f})"
        print(f"kernel {name} {shape}: max_abs_err {err:.3e}  device ms "
              f"(per call ms): kernel {t[0]:.5f} ({t[1]:.5f})  plain "
              f"{t_plain[0]:.5f} ({t_plain[1]:.5f})  library {lib_s}  "
              f"bound {b_ms:.5f} ({b_by})", flush=True)

    # quantize: GAE coefficients (37120,80); latents per stripe (64,128),
    # (640,16); latents of fit_basis's one pass over all 1600 hyper-blocks
    # (1600,128), (16000,16); the qwen2-1.5b serve run's K or V cache (28
    # layers x 1 x 128 tokens, KV*hd = 256) at bin 2 KV_TAU / sqrt(256)
    for shape, b in (((37120, 80), 0.01), ((64, 128), 0.005),
                     ((640, 16), 0.005), ((1600, 128), 0.005),
                     ((16000, 16), 0.005), ((3584, 256), 2 * KV_TAU / 16)):
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

    # quantize on bf16 input: read as fp32, deq written in bf16, err2 in fp32,
    # bit for bit the fp32 formula (and the plain version), at the HBAE
    # latents' shape; no compressor path hands it bf16 (launches 0)
    x = (3 * torch.randn((64, 128), generator=gen, device=dev)).to(torch.bfloat16)
    got = qz.quantize_fused(x, 0.005)
    x32, b32 = x.float(), torch.tensor(0.005, device=dev)
    q32 = torch.round(x32 / b32)
    deq32 = q32 * b32
    want = (q32.to(torch.int32), deq32.to(torch.bfloat16),
            torch.square(x32 - deq32))
    for g, w, p in zip(got, want, qz.quantize_fused_plain(x, 0.005)):
        if not (g.dtype == w.dtype and torch.equal(g, w) and torch.equal(g, p)):
            raise CheckFailed("quantize bf16 (64, 128): kernel output is not "
                              "bit-identical to the fp32 formula and the plain "
                              "version")
    t = time_ms(torch, lambda: qz.quantize_fused(x, 0.005))
    t_plain = time_ms(torch, lambda: qz.quantize_fused_plain(x, 0.005))
    n = x.numel()
    b_ms, b_by = row("quantize", "src/repro_torch/csrc/quantize.cu",
                     "src/repro/kernels/quantize/kernel.py:25", 0.0, t[0],
                     t_plain[0], None, 12 * n, 5 * n, dtype="bfloat16")
    report("quantize", (64, 128, "bfloat16"), 0.0, t, t_plain, None, b_ms,
           b_by)

    # the card's launch floor: the device time of the least kernel there is,
    # printed beside block_attention's small-shape time, which is below it
    one = torch.zeros(1, device=dev)
    floor = time_ms(torch, lambda: one.add_(1.0))
    print(f"launch floor: one-element in-place torch.add_ device ms "
          f"{floor[0]:.5f} (per call ms {floor[1]:.5f})", flush=True)

    # block_attention: S3D stripe (64,10,128); ragged multi-head; E3SM
    # (64,5,128); XGC (64,8,128); fit_basis's one pass over all of S3D
    # (1600,10,128) and over the paper's full 640x640 field (25600,10,128);
    # n 17, which only the general kernel takes; the S3D stripe in bf16, held
    # to its bf16 plain version at 5e-2 (the plain version rounds its
    # products to bf16) and to the fp32 plain version on the same bf16
    # inputs, rounded to bf16, at 8e-3 (one bf16 ulp: the kernel is fp32)
    f32, bf16 = torch.float32, torch.bfloat16
    ba_gated = {}
    for (bsz, n, d), heads, dtype in (
            ((64, 10, 128), 1, f32), ((37, 8, 128), 4, f32),
            ((64, 5, 128), 1, f32), ((64, 8, 128), 1, f32),
            ((1600, 10, 128), 1, f32), ((25600, 10, 128), 1, f32),
            ((64, 17, 128), 1, f32), ((64, 10, 128), 1, bf16)):
        q, k, v = (torch.randn(bsz, n, d, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        got = ba.block_attention(q, k, v, heads)
        want = ba.block_attention_plain(q, k, v, heads)
        tol = 1e-5
        if dtype == bf16:
            torch.testing.assert_close(got.float(), want.float(), atol=5e-2,
                                       rtol=5e-2)
            want = ba.block_attention_plain(q.float(), k.float(), v.float(),
                                            heads).to(bf16)
            tol = 8e-3
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
        err = (got.float() - want.float()).abs().max().item()
        dh = d // heads
        q4, k4, v4 = (t.view(bsz, n, heads, dh).transpose(1, 2).contiguous()
                      for t in (q, k, v))

        # bound now: the gates below call them after the loop has moved on
        def kernel(q=q, k=k, v=v, heads=heads):
            return ba.block_attention(q, k, v, heads)

        def library(q4=q4, k4=k4, v4=v4):
            return F.scaled_dot_product_attention(q4, k4, v4)

        t = time_ms(torch, kernel)
        t_plain = time_ms(torch, lambda: ba.block_attention_plain(q, k, v, heads))
        t_lib = time_ms(torch, library)
        flops = bsz * heads * (4 * n * n * dh + 5 * n * n)
        dname = str(dtype)[6:]
        b_ms, b_by = row("block_attention",
                         "src/repro_torch/csrc/block_attention.cu",
                         "src/repro/kernels/block_attention/kernel.py:27",
                         err, t[0], t_plain[0], t_lib[0],
                         q.element_size() * 4 * bsz * n * d, flops,
                         BF16_FLOPS if dtype == bf16 else FP32_FLOPS, dname)
        path = ba.launch_plan(bsz, n, d, d, heads, dtype, True,
                              torch.cuda.get_device_properties(dev)
                              .multi_processor_count)
        report("block_attention", (bsz, n, d, heads, dname, path), err, t,
               t_plain, t_lib, b_ms, b_by)
        if dtype == f32 and (bsz, n) in ((64, 10), (1600, 10)):
            ba_gated[bsz] = (kernel, library, b_ms)
    _block_attention_gates(torch, ba_gated, floor[0])

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
        if nrows == 37120:
            _kernel_against_library(
                torch, "gae_project", (nrows, d, d),
                lambda: gp.gae_project(r, u), lambda: torch.matmul(r, u),
                GAE_OVER_MATMUL_MAX)

    # flash_attention: the qwen2-1.5b prefill (B 1, S = T = 4096, H 12, KV 2,
    # hd 128, causal), a window of 64, T > S (queries suffix-aligned), a
    # ragged S; each in fp32 (SIMT) and bf16 (tensor cores).  The bound
    # counts the live (q, k) pairs of the mask, at the fp32 or bf16 peak.
    # bf16 is held to the fp32 plain version on the same inputs, rounded to
    # bf16: one bf16 rounding apart (8 significant bits, 2^-7 = 0.0078).
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b, s_, t_, window in ((1, 4096, 4096, 0), (1, 4096, 4096, 64),
                                  (1, 1000, 4096, 0), (1, 1000, 1000, 0)):
            h, kvh, hd = 12, 2, 128
            q = torch.randn(b, s_, h, hd, generator=gen, device=dev).to(dtype)
            k = torch.randn(b, t_, kvh, hd, generator=gen, device=dev).to(dtype)
            v = torch.randn(b, t_, kvh, hd, generator=gen, device=dev).to(dtype)
            got = fa.flash_attention(q, k, v, causal=True, window=window)
            want = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                            causal=True, window=window).to(dtype)
            tol = (dict(atol=1e-3, rtol=1e-2) if dtype == torch.bfloat16
                   else dict(atol=3e-5, rtol=3e-5))
            torch.testing.assert_close(got.float(), want.float(), **tol)
            err = (got.float() - want.float()).abs().max().item()
            mask = fa.attention_mask(s_, t_, True, window, dev)
            qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            sdpa_mask = None if (window == 0 and s_ == t_) else mask

            # bound now: the gates below call them after the loop has moved on
            def kernel(q=q, k=k, v=v, window=window):
                return fa.flash_attention(q, k, v, causal=True, window=window)

            def library(qh=qh, kh=kh, vh=vh, sdpa_mask=sdpa_mask):
                return F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=sdpa_mask,
                    is_causal=sdpa_mask is None, enable_gqa=True)

            t = time_ms(torch, kernel, iters=10)
            t_plain = time_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v, causal=True, window=window), iters=10)
            t_lib = time_ms(torch, library, iters=10)
            live = int(mask.sum().item())
            dname = str(dtype)[6:]
            b_ms, b_by = row("flash_attention",
                             "src/repro_torch/csrc/flash_attention.cu",
                             "src/repro/kernels/flash_attention/kernel.py:29",
                             err, t[0], t_plain[0], t_lib[0],
                             q.element_size() * (2 * q.numel() + 2 * k.numel()),
                             b * h * live * 4 * hd,
                             BF16_FLOPS if dtype == torch.bfloat16
                             else FP32_FLOPS, dname)
            report("flash_attention", (b, s_, t_, h, kvh, hd, dname,
                                       f"window {window}"),
                   err, t, t_plain, t_lib, b_ms, b_by)
            if (s_, t_, window) == (4096, 4096, 0):
                main[dtype] = (kernel, library, t[0], t_lib[0])
    # the gates of the redesign, at the qwen2-1.5b prefill shape
    shape = (1, 4096, 4096, 12, 2, 128)
    kernel, library, _, _ = main[torch.bfloat16]
    _kernel_against_library(torch, "flash_attention bf16", shape, kernel,
                            library, FA_BF16_OVER_SDPA_MAX)
    _, _, t32, t32_lib = main[torch.float32]
    print(f"kernel flash_attention float32 {shape}: {t32:.5f} ms (gate "
          f"{FA_F32_MS_MAX} ms), scaled_dot_product_attention {t32_lib:.5f} "
          f"ms", flush=True)
    if t32 > FA_F32_MS_MAX or t32 >= t32_lib:
        raise CheckFailed(f"flash_attention float32 {shape}: {t32:.5f} ms, "
                          f"more than {FA_F32_MS_MAX} ms or not faster than "
                          f"scaled_dot_product_attention's {t32_lib:.5f} ms")

    # ssd_scan: the mamba2-370m prefill (B 1, S 4096, H 32, P 64, G 1, N 128,
    # chunk 256), a ragged S, G = 2.  Inputs as the JAX kernel tests make
    # them.  The bound counts the chunked algorithm's products over the
    # chunks' real lengths: the causal half of C.B^T once per group (b and c
    # are shared by the group's heads), and per head the causal half of
    # scores.x, C.h and the state update.  Tolerance 3e-4 of the output's
    # scale: at chunk 256 cum reaches about -500, and exp of differences of
    # such fp32 sums carries ~1e-5 relative error that depends on the
    # cumsum's order.
    for b, s_, h, p, g, n, chunk in ((1, 4096, 32, 64, 1, 128, 256),
                                     (1, 1000, 32, 64, 1, 128, 256),
                                     (1, 4096, 32, 64, 2, 128, 256)):
        x = torch.randn(b, s_, h, p, generator=gen, device=dev)
        dt = F.softplus(torch.randn(b, s_, h, generator=gen, device=dev))
        a_log = torch.rand(h, generator=gen, device=dev)
        bm = torch.randn(b, s_, g, n, generator=gen, device=dev)
        cm = torch.randn(b, s_, g, n, generator=gen, device=dev)
        args = (x, dt, a_log, bm, cm)
        got = sd.ssd(*args, chunk=chunk)
        want = sd.ssd_plain(*args, chunk=chunk)
        for gt, wt in zip(got, want):
            scale = max(1.0, wt.abs().max().item())
            torch.testing.assert_close(gt, wt, atol=3e-4 * scale, rtol=3e-4)
        err = max((gt - wt).abs().max().item() for gt, wt in zip(got, want))
        # each CUDA kernel of the op against its plain phase, fed the
        # kernel's own upstream outputs, at the same tolerance
        for name, gt, wt in sd.phase_pairs(*args, chunk=chunk):
            scale = max(1.0, wt.abs().max().item())
            if not torch.allclose(gt, wt, atol=3e-4 * scale, rtol=3e-4):
                raise CheckFailed(
                    f"ssd_scan {(b, s_, h, p, g, n, chunk)}: {name} differs "
                    f"from its plain phase by "
                    f"{(gt - wt).abs().max().item():.3e} (scale {scale:.3e})")
        print(f"kernel ssd_scan {(b, s_, h, p, g, n, chunk)}: every phase "
              f"kernel within 3e-4 of the output's scale of its plain phase",
              flush=True)
        parts = {}
        t = time_ms(torch, lambda: sd.ssd(*args, chunk=chunk), iters=10,
                    by_name=parts, match="ssd")
        print(f"kernel ssd_scan {(b, s_, h, p, g, n, chunk)} device ms per "
              f"call by CUDA kernel: " + ", ".join(
                  f"{k} {v:.5f}" for k, v in parts.items()), flush=True)
        t_plain = time_ms(torch, lambda: sd.ssd_plain(*args, chunk=chunk),
                          iters=10)
        lens = [min(chunk, s_ - c0) for c0 in range(0, s_, chunk)]
        flops = b * sum(g * ln * (ln + 1) * n
                        + h * (ln * (ln + 1) * p + 4 * ln * n * p)
                        for ln in lens)
        n_bytes = 4 * (2 * x.numel() + dt.numel() + h + 2 * bm.numel()
                       + b * h * p * n)
        b_ms, b_by = row("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
                         "src/repro/kernels/ssd_scan/kernel.py:32", err,
                         t[0], t_plain[0], None, n_bytes, flops)
        report("ssd_scan", (b, s_, h, p, g, n, chunk), err, t, t_plain, None,
               b_ms, b_by)
        if t[0] >= t_plain[0]:
            raise CheckFailed(f"ssd_scan {(b, s_, h, p, g, n, chunk)}: kernel "
                              f"{t[0]:.5f} ms is not faster than its plain "
                              f"version's {t_plain[0]:.5f} ms")
        if (b, s_, g) == (1, 4096, 1) and t[0] > SSD_MAMBA2_MS_MAX:
            raise CheckFailed(f"ssd_scan at mamba2-370m: {t[0]:.5f} ms, more "
                              f"than {SSD_MAMBA2_MS_MAX} ms")
    return rows


def _block_attention_gates(torch, gated, floor_ms) -> None:
    """block_attention at the S3D stripe at most ``BA_STRIPE_MS_MAX`` (or
    1.5x the launch floor where the floor is above that), at fit_basis's
    shape at most ``BA_FIT_OVER_BOUND_MAX`` times its bytes bound, and at both
    no slower than ``scaled_dot_product_attention`` in turns; each on the
    kernel's median of the rounds in turns."""
    stripe_max = (BA_STRIPE_MS_MAX if floor_ms < BA_STRIPE_MS_MAX
                  else 1.5 * floor_ms)
    for bsz, (kernel, library, b_ms) in gated.items():
        max_ms = stripe_max if bsz == 64 else BA_FIT_OVER_BOUND_MAX * b_ms
        shape = (bsz, 10, 128, 1)
        k_ms, _ = _kernel_against_library(torch, "block_attention", shape,
                                          kernel, library, BA_OVER_SDPA_MAX)
        print(f"kernel block_attention {shape}: median {k_ms:.5f} ms, gate "
              f"{max_ms:.5f} ms (bound {b_ms:.5f} ms, launch floor "
              f"{floor_ms:.5f} ms)", flush=True)
        if k_ms > max_ms:
            raise CheckFailed(f"block_attention {shape}: median {k_ms:.5f} ms "
                              f"is more than its gate of {max_ms:.5f} ms")


def _kernel_against_library(torch, name, shape, kernel, library,
                            max_ratio: float,
                            rounds: int = 5) -> tuple[float, float]:
    """Device ms of a kernel and its library call timed in turns (kernel,
    library, library, kernel, ...), for a comparison that one pair of
    timings is too noisy to settle.  Fails if the kernel's median is more
    than ``max_ratio`` times the library call's; returns both medians."""
    import statistics

    times = {"kernel": [], "library": []}
    for i in range(rounds):
        order = ("kernel", "library") if i % 2 == 0 else ("library", "kernel")
        for which in order:
            fn = kernel if which == "kernel" else library
            times[which].append(time_ms(torch, fn)[0])
    k, lib = (statistics.median(times[w]) for w in ("kernel", "library"))
    print(f"kernel {name} {shape} in turns with the library call, "
          f"{rounds} rounds: median device ms kernel {k:.5f}, library "
          f"{lib:.5f} (kernel/library {k / lib:.4f}; kernel "
          f"{' '.join(f'{t:.5f}' for t in times['kernel'])}, library "
          f"{' '.join(f'{t:.5f}' for t in times['library'])})", flush=True)
    if k > max_ratio * lib:
        raise CheckFailed(f"{name} {shape}: median {k:.5f} ms is more than "
                          f"{max_ratio}x the library call's "
                          f"{lib:.5f} ms")
    return k, lib


# ---------------------------------------------------------------------------
# phase 3: gradients through the kernels' autograd Functions
# ---------------------------------------------------------------------------

def _grads_close(what, got, want, frac=1e-5) -> None:
    """Fails unless every gradient in ``got`` is nonzero somewhere and within
    ``frac`` of the largest in ``want`` of its partner."""
    scale = max(w.abs().max().item() for w in want)
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    if not all(g.abs().max().item() > 0 for g in got):
        raise CheckFailed(f"{what}: a gradient through the kernel is all zero")
    if err > frac * scale:
        raise CheckFailed(f"{what}: gradients through the kernel differ from "
                          f"the plain path's by {err:.3e}, more than {frac} x "
                          f"the largest ({scale:.3e})")
    print(f"gradients {what}: max abs diff {err:.3e} (gate {frac} x "
          f"{scale:.3e})", flush=True)


def check_gradients(torch, dev) -> None:
    """Each kernel's autograd Function against autograd through its plain
    version on the card; block_attention through ``self_attention``'s
    projections at the S3D stripe, and its forward and backward timed."""
    import torch.nn.functional as F

    from repro_torch.core import attention
    from repro_torch.kernels.block_attention import ops as ba
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as sd
    from repro_torch.train import optim

    cpu = torch.Generator().manual_seed(1)
    gen = torch.Generator(device=dev).manual_seed(1)

    # block_attention: one self_attention call at the S3D stripe, d 128
    params = optim.tree_map(lambda t: t.to(dev),
                            attention.attention_init(cpu, 128, heads=1))
    x = torch.randn(64, 10, 128, generator=gen, device=dev)
    w = torch.randn(64, 10, 128, generator=gen, device=dev)
    names = ("wq", "wk", "wv", "wo")
    grads = {}
    for route in ("kernel", "plain"):
        leaves = [params[n]["w"].detach().clone().requires_grad_()
                  for n in names]
        p = dict(params, **{n: {"w": leaf} for n, leaf in zip(names, leaves)})
        before = ba.launches.value
        if route == "plain":
            attention.block_attention = ba.block_attention_plain
        try:
            loss = torch.sum(attention.self_attention(p, x) * w)
        finally:
            attention.block_attention = ba.block_attention
        if ba.launches.value - before != (route == "kernel"):
            raise CheckFailed(f"self_attention ({route}) launched "
                              f"block_attention {ba.launches.value - before} "
                              f"times")
        grads[route] = torch.autograd.grad(loss, leaves)
    _grads_close("block_attention (self_attention wq, wk, wv, wo at "
                 "(64, 10, 128))", grads["kernel"], grads["plain"])

    q, k, v, d_out = (torch.randn(64, 10, 128, generator=gen, device=dev)
                      for _ in range(4))
    fwd = time_ms(torch, lambda: ba.block_attention(q, k, v, 1))
    bwd = time_ms(torch, lambda: ba.block_attention_backward_plain(
        q, k, v, 1, d_out))
    print(f"gradients block_attention (64, 10, 128) autograd Function: "
          f"forward (the kernel) device ms {fwd[0]:.5f} (per call "
          f"{fwd[1]:.5f}), backward (block_attention_backward_plain) "
          f"{bwd[0]:.5f} (per call {bwd[1]:.5f})", flush=True)

    def through(fn, ins, ws):
        leaves = [t.clone().requires_grad_() for t in ins]
        outs = fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return torch.autograd.grad(
            sum(torch.sum(o * w) for o, w in zip(outs, ws)), leaves)

    # flash_attention: qwen2-1.5b's heads over 512 tokens, causal
    q = torch.randn(1, 512, 12, 128, generator=gen, device=dev)
    k, v = (torch.randn(1, 512, 2, 128, generator=gen, device=dev)
            for _ in range(2))
    w = torch.randn(q.shape, generator=gen, device=dev)
    _grads_close("flash_attention (1, 512, 12, 2, 128) q, k, v",
                 through(fa.flash_attention, (q, k, v), (w,)),
                 through(fa.flash_attention_plain, (q, k, v), (w,)))

    # ssd_scan: mamba2-370m's heads over 512 tokens, chunk 256
    x = torch.randn(1, 512, 32, 64, generator=gen, device=dev)
    dt = F.softplus(torch.randn(1, 512, 32, generator=gen, device=dev))
    a_log = torch.rand(32, generator=gen, device=dev)
    b, c = (torch.randn(1, 512, 1, 128, generator=gen, device=dev)
            for _ in range(2))
    ws = (torch.randn(x.shape, generator=gen, device=dev),
          torch.randn(1, 32, 64, 128, generator=gen, device=dev))
    ins = (x, dt, a_log, b, c)
    _grads_close("ssd_scan (1, 512, 32, 64, N 128, chunk 256) x, dt, a_log, "
                 "b, c",
                 through(lambda *a: sd.ssd(*a, chunk=256), ins, ws),
                 through(lambda *a: sd.ssd_plain(*a, chunk=256), ins, ws))


# ---------------------------------------------------------------------------
# phase 4: fit
# ---------------------------------------------------------------------------

def _adam_first_step_bound(np, p, gj, gt):
    """How far two Adam first steps from param ``p`` with gradients ``gj``
    and ``gt`` may land apart: the update lr * g / (|g| + eps) moves at most
    lr * eps / (|g| + eps)^2 per unit of g between them, plus the roundings
    (``tests/test_torch_training.py``)."""
    g_min = np.where(np.sign(gj) == np.sign(gt),
                     np.minimum(np.abs(gj), np.abs(gt)), 0.0)
    slope = LR * EPS / (g_min + EPS) ** 2
    return (slope * np.abs(gt.astype(np.float64) - gj)
            + 8 * np.spacing(np.float32(LR)) + 2 * np.spacing(np.abs(p) + LR))


def run_fit(torch, dev, counters, cfg, hb):
    """``fit`` on the card; returns the fitted compressor."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import exec as exec_mod
    from repro_torch.core import training
    from repro_torch.core.pipeline import HierarchicalCompressor
    from repro_torch.train import optim

    n, k, d = hb.shape
    hb_batch, bae_batch = min(cfg.batch, n), min(max(cfg.batch * 4, 256), n * k)
    hbae_steps = cfg.epochs_hbae * (n // hb_batch)
    bae_steps = cfg.epochs_bae * (n * k // bae_batch)
    print(f"fit: S3D, {n} hyper-blocks, HBAE {cfg.epochs_hbae} epochs x "
          f"{n // hb_batch} steps of {hb_batch} = {hbae_steps} steps, BAE "
          f"{cfg.epochs_bae} epochs x {n * k // bae_batch} steps of "
          f"{bae_batch} rows = {bae_steps} steps, Adam lr {cfg.lr}",
          flush=True)
    for c in counters.values():
        c.reset()
    exec_mod.reset_stage_stats()
    logs = []
    comp = HierarchicalCompressor(cfg)           # the card, by default
    t0 = time.perf_counter()
    comp.fit(hb, seed=0, log=lambda s, l: logs.append((s, l)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.value for name, c in counters.items()}
    stats = exec_mod.stage_stats()
    hb_s, bae_s = stats["hbae_train"].seconds, stats["bae_train"].seconds
    split = [i for i, (step, _) in enumerate(logs) if step == 0][1]
    hb_logs, bae_logs = logs[:split], logs[split:]
    print(f"fit: wall {wall:.3f} s; HBAE {hb_s:.3f} s ({hbae_steps / hb_s:.1f} "
          f"steps/s), BAE {bae_s:.3f} s ({bae_steps / bae_s:.1f} steps/s), the "
          f"residual pass and moves between them {wall - hb_s - bae_s:.3f} s",
          flush=True)
    print(f"fit: HBAE mse by step {', '.join(f'{s} {l:.6e}' for s, l in hb_logs)}",
          flush=True)
    print(f"fit: BAE mse by step {', '.join(f'{s} {l:.6e}' for s, l in bae_logs)}",
          flush=True)
    print(f"fit launches: {json.dumps(launches)}", flush=True)
    want = 2 * hbae_steps + 2
    if launches["block_attention"] != want:
        raise CheckFailed(f"fit launched block_attention "
                          f"{launches['block_attention']} times, not {want} "
                          f"(2 per HBAE step and 2 for the residual pass)")
    drop = hb_logs[0][1] / hb_logs[-1][1]
    print(f"fit: HBAE loss fell {drop:.2f}x from step {hb_logs[0][0]} to "
          f"step {hb_logs[-1][0]} (gate {FIT_LOSS_DROP_MIN}x)", flush=True)
    if not drop >= FIT_LOSS_DROP_MIN:
        raise CheckFailed(f"the HBAE loss fell {drop:.3f}x, less than "
                          f"{FIT_LOSS_DROP_MIN}x")

    # where a step's time goes: PROFILE_STEPS HBAE steps from the fitted
    # params, after 5 warm-up steps, under the profiler
    data = exec_mod.upload(hb, dev)
    params = optim.tree_map(lambda t: t.clone(), comp.hbae_params)
    opt = optim.adam(lr=cfg.lr)
    state = opt.init(params)
    order = list(training._minibatches(np.random.default_rng(1), n, cfg.batch,
                                       3))[:PROFILE_STEPS + 5]
    idx = torch.from_numpy(np.stack(order)).to(dev)
    for i in range(5):
        params, state, _ = training._hbae_step(params, state, data[idx[i]], opt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(5, 5 + PROFILE_STEPS):
            params, state, _ = training._hbae_step(params, state,
                                                   data[idx[i]], opt)
        torch.cuda.synchronize()
        step_wall = time.perf_counter() - t0
    busy = device_ms(torch, prof) / 1e3
    ba_s = sum(device_ms_by_name(torch, prof, "block_attention").values()) / 1e3
    print(f"fit profile: {PROFILE_STEPS} HBAE steps in {step_wall:.4f} s "
          f"({PROFILE_STEPS / step_wall:.1f} steps/s, "
          f"{step_wall / PROFILE_STEPS * 1e3:.3f} ms a step); device busy "
          f"{busy * 1e3:.3f} ms ({busy / PROFILE_STEPS * 1e3:.4f} ms a step), "
          f"idle share {1 - busy / step_wall:.4f}; block_attention kernel "
          f"{ba_s * 1e3:.3f} ms ({ba_s / busy if busy else 0.0:.4f} of busy)",
          flush=True)

    # one HBAE step on the card against the same step on the CPU
    batch = hb[:cfg.batch]
    results = {}
    for where in ("cpu", "cuda"):
        p = optim.tree_map(lambda t: t.detach().to(where).clone(),
                           comp.hbae_params)
        x = exec_mod.upload(batch, torch.device(where))
        _, g = training._value_and_grad(training.hbae_loss, p, x)
        o = optim.adam(lr=cfg.lr)
        p, _, loss = training._hbae_step(p, o.init(p), x, o)
        results[where] = (float(loss), [t.cpu().numpy() for t in
                                        optim.tree_leaves(g)],
                          [t.detach().cpu().numpy() for t in
                           optim.tree_leaves(p)])
    before = [t.cpu().numpy() for t in optim.tree_leaves(comp.hbae_params)]
    (l_c, g_c, p_c), (l_g, g_g, p_g) = results["cpu"], results["cuda"]
    g_err = max(float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))
                for a, b in zip(g_c, g_g))
    p_over = max(float((np.abs(b - a) / _adam_first_step_bound(np, p0, ga, gb)
                        ).max())
                 for p0, ga, gb, a, b in zip(before, g_c, g_g, p_c, p_g))
    print(f"fit: one HBAE step card vs CPU: loss {l_g:.8e} vs {l_c:.8e} "
          f"(rel {abs(l_g / l_c - 1):.3e}, gate 1e-5), gradients max diff "
          f"{g_err:.3e} of their leaf's largest (gate 1e-5), params at "
          f"{p_over:.4f} of Adam's first-step bound (gate 1)", flush=True)
    if abs(l_g / l_c - 1) > 1e-5 or g_err > 1e-5 or p_over > 1:
        raise CheckFailed("one HBAE step on the card differs from the CPU's")
    return comp


# ---------------------------------------------------------------------------
# phase 6: the launcher
# ---------------------------------------------------------------------------

def run_launcher() -> None:
    """``python -m repro_torch.launch.compress`` as a user runs it."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "repro_torch.launch.compress",
               "--dataset", "e3sm", "--quick", "--epochs-scale", "0.25",
               "--out", os.path.join(tmp, "e3sm.rba"), "--verify"]
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        t0 = time.perf_counter()
        out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             timeout=600, cwd=tmp)
        wall = time.perf_counter() - t0
    print(f"launcher: {' '.join(cmd[1:4])} ... exit {out.returncode} in "
          f"{wall:.1f} s; its output:", flush=True)
    print("\n".join("  | " + line for line in
                    (out.stdout + out.stderr).splitlines()), flush=True)
    if out.returncode != 0 or "verify OK" not in out.stdout:
        raise CheckFailed(f"the launcher exited {out.returncode} without "
                          f"'verify OK'")


# ---------------------------------------------------------------------------
# phase 5: the compressor's main path
# ---------------------------------------------------------------------------

def make_field():
    """The S3D configuration at full width and its synthetic field, cut to
    ``FIELD``; the fit and the main path share them."""
    from repro_torch.data import synthetic

    t0 = time.perf_counter()
    cfg, hb = synthetic.make_dataset("s3d", quick=False, seed=0, field=FIELD)
    print(f"S3D config block {cfg.block_elems}, k {cfg.k}, emb {cfg.emb}, "
          f"hidden {cfg.hidden}, hb_latent {cfg.hb_latent}, bae_hidden "
          f"{cfg.bae_hidden}, bae_latent {cfg.bae_latent}, GAE blocks of "
          f"{cfg.gae_block_elems}, epochs {cfg.epochs_hbae}/{cfg.epochs_bae}",
          flush=True)
    print(f"S3D field cut from {FULL_FIELD} to "
          f"{FIELD['n_species']}x{FIELD['t']}x{FIELD['h']}x{FIELD['w']} "
          f"({hb.size / 1e6:.1f} M values, {hb.shape[0]} hyper-blocks) "
          f"because the host GAE/entropy coders and the generator would "
          f"exceed the run's time limit at full size; generated in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return cfg, hb


def run_main_path(torch, dev, counters, kernels, comp, hb) -> dict:
    """The compressor path on the fitted ``comp``; ``kernels`` are the
    counters' names it must launch."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import exec as exec_mod
    from repro_torch.core.options import CompressOptions
    from repro_torch.core.pipeline import HierarchicalCompressor
    from repro_torch.runtime import archive_io

    cfg = comp.cfg
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
          f"(trained ({cfg.epochs_hbae}/{cfg.epochs_bae} epochs))", flush=True)
    print(f"main path launches: {json.dumps(launches)}", flush=True)

    for name in kernels:
        if launches[name] <= 0:
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

    # the ratio of the same path with PR 15's seeded untrained weights
    raw = HierarchicalCompressor(cfg).init_params(seed=0)
    raw.fit_basis(hb)
    untrained = raw.compress(hb, options=CompressOptions(tau=TAU))
    print(f"main path: the same field with seeded untrained weights "
          f"(init_params(seed=0)): compression ratio "
          f"{untrained.compression_ratio():.4f}", flush=True)
    del raw, untrained

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


# ---------------------------------------------------------------------------
# phase 4: the LM path (prefill and serving)
# ---------------------------------------------------------------------------

LM_MODELS = (("qwen2-1.5b", "flash_attention"), ("mamba2-370m", "ssd_scan"))
PREFILL_TOKENS = 4096
CONSISTENCY_PROMPT = 64
# forward's last logits (the kernels, chunked) against the engine's prefill
# (one decode step at a time, plain code), fp32 through 28 or 48 layers
CONSISTENCY_ATOL = 1e-3
SERVE = dict(requests=8, slots=4, prompt=32, new=16, max_len=128)
# decode_step calls per request: the prompt's prefill, then all new tokens
# but the last
SERVE_STEPS = SERVE["requests"] * (SERVE["prompt"] + SERVE["new"] - 1)
DECODE_STEPS = 16
# the bf16 prefill's logits, through the kernel and through its plain
# version, are compared with the fp32 prefill's on the last positions
TAIL = 64


def lm_prefill(torch, api, params, cfg, run, tokens, kernel,
               counters) -> dict:
    """``forward`` over ``tokens`` (the prefill) after a warm-up: wall and
    tokens/s, launches of every counter, the device busy time of a profiled
    repeat and the part of it in CUDA kernels whose name holds the kernel's
    first word.  Fails unless the kernel launched once per layer and the
    logits are finite and of the expected shape.  Returns the numbers and
    the logits of the last ``TAIL`` positions in fp32."""
    from torch.profiler import ProfilerActivity, profile

    api.forward(params, cfg, run, tokens[:, :256])       # warm-up
    torch.cuda.synchronize()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    logits = api.forward(params, cfg, run, tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.value for name, c in counters.items()}
    if launches[kernel] != cfg.n_layers:
        raise CheckFailed(f"{cfg.arch} forward ({run.compute_dtype}) launched "
                          f"{kernel} {launches[kernel]} times, not once per "
                          f"layer ({cfg.n_layers})")
    if (tuple(logits.shape) != (1, tokens.shape[1], cfg.vocab)
            or not torch.isfinite(logits).all()):
        raise CheckFailed(f"{cfg.arch} forward ({run.compute_dtype}) gave "
                          f"shape {tuple(logits.shape)} or non-finite logits")
    tail = logits[:, -TAIL:].float().clone()
    del logits
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        api.forward(params, cfg, run, tokens)
        torch.cuda.synchronize()
    busy = device_ms(torch, prof)
    parts = device_ms_by_name(torch, prof, kernel.split("_")[0])
    return dict(wall=wall, tokens_s=tokens.shape[1] / wall, busy=busy,
                mine=sum(parts.values()), parts=parts, launches=launches,
                tail=tail)


def print_prefill(arch, kernel, dtype, r) -> None:
    busy, mine = r["busy"], r["mine"]
    print(f"lm {arch} prefill {dtype}: B 1 x S {PREFILL_TOKENS}, wall "
          f"{r['wall']:.4f} s, {r['tokens_s']:.1f} tokens/s; profiled run: "
          f"device busy {busy:.3f} ms, of it {kernel} {mine:.3f} ms "
          f"({mine / busy if busy else 0.0:.4f} of it; by CUDA kernel: "
          + ", ".join(f"{k} {v:.3f}" for k, v in r["parts"].items())
          + f"); launches {json.dumps(r['launches'])}", flush=True)


def run_lm_path(torch, dev, counters) -> dict:
    """Prefill (fp32, then bf16), consistency and serving for each LM model;
    returns the launches of each model's kernel in its prefill runs, keyed
    by (kernel, dtype)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import registry
    from repro_torch.serve.engine import Request, ServeEngine

    def reset():
        for c in counters.values():
            c.reset()

    def read():
        return {name: c.value for name, c in counters.items()}

    prefill_launches = {}
    for arch, kernel in LM_MODELS:
        cfg, run = get_config(arch), RunConfig()
        gen = torch.Generator(device=dev).manual_seed(0)
        t0 = time.perf_counter()
        params = registry.init_params(cfg, run, gen, dev)
        api = registry.get_model(cfg)
        n_params = sum(_numel(params))
        print(f"lm {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"vocab {cfg.vocab}, {n_params / 1e6:.1f} M params (seeded, "
              f"fp32), made in {time.perf_counter() - t0:.1f} s", flush=True)
        tokens = torch.randint(0, cfg.vocab, (1, PREFILL_TOKENS),
                               generator=gen, device=dev)

        # 1. prefill: forward over 1 x 4096 tokens, fp32
        r32 = lm_prefill(torch, api, params, cfg, run, tokens, kernel,
                         counters)
        print_prefill(arch, kernel, "float32", r32)
        prefill_launches[kernel, "float32"] = r32["launches"][kernel]

        # 1b. the same prefill in bf16 (the JAX package's deployment dtype),
        # same fp32 params; then once more with the kernel's wrapper swapped
        # for its plain version, to hold the kernel to it on the model path
        run16 = RunConfig(compute_dtype="bfloat16")
        r16 = lm_prefill(torch, api, params, cfg, run16, tokens, kernel,
                         counters)
        print_prefill(arch, kernel, "bfloat16", r16)
        if kernel == "flash_attention":
            prefill_launches[kernel, "bfloat16"] = r16["launches"][kernel]
        tail_plain = _forward_plain(torch, api, params, cfg, run16, tokens,
                                    kernel)
        ref = r32["tail"]
        e_kernel = (r16["tail"] - ref).abs().max().item()
        e_plain = (tail_plain - ref).abs().max().item()
        scale = ref.abs().max().item()
        limit = 1.5 * e_plain + 1e-3 * scale
        print(f"lm {arch} prefill bf16 against fp32, last {TAIL} positions: "
              f"max abs diff through {kernel} {e_kernel:.5f}, through its "
              f"plain version {e_plain:.5f} (max |logit| {scale:.4f}; gate "
              f"{limit:.5f} = 1.5 x plain + 1e-3 x max |logit|)", flush=True)
        if not e_kernel <= limit:
            raise CheckFailed(f"{arch} bf16 prefill through {kernel} is "
                              f"{e_kernel} from fp32, more than {limit}")
        del r32, r16, tail_plain, ref

        # 2. consistency: forward (kernel) against the engine's prefill
        prompt = tokens[:, :CONSISTENCY_PROMPT]
        full = api.forward(params, cfg, run, prompt)[:, -1]
        eng = ServeEngine(cfg, run, params, batch_size=1, max_len=128,
                          device=dev)
        _, last = eng.prefill(prompt, api.init_decode_state(params, cfg, run,
                                                            1, 128))
        diff = (full - last).abs().max().item()
        print(f"lm {arch} consistency: forward vs engine prefill on "
              f"{CONSISTENCY_PROMPT} tokens, last logits max abs diff "
              f"{diff:.3e} (max |logit| {full.abs().max().item():.3f}, "
              f"tolerance {CONSISTENCY_ATOL})", flush=True)
        if not diff <= CONSISTENCY_ATOL:
            raise CheckFailed(f"{arch}: forward and engine prefill differ by "
                              f"{diff}")
        if cfg.family == "dense":
            _check_kv_quantize(torch, arch, eng.prefill(
                prompt, api.init_decode_state(params, cfg, run, 1,
                                              SERVE["max_len"]))[0].caches)

        # where a serving step's time goes: the device time of one
        # decode_step (B 1, as the engine runs each slot) against its wall
        state = api.init_decode_state(params, cfg, run, 1, SERVE["max_len"])
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for t in range(DECODE_STEPS):
                _, state = api.decode_step(params, cfg, run,
                                           prompt[:, t:t + 1], state)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) / DECODE_STEPS * 1e3
        busy_ms = device_ms(torch, prof) / DECODE_STEPS
        print(f"lm {arch} decode_step (B 1, profiled): wall {step_ms:.3f} ms, "
              f"device busy {busy_ms:.3f} ms, idle share "
              f"{1 - busy_ms / step_ms:.4f}", flush=True)

        # 3. serving: continuous batching, raw KV and kv_tau
        rng = np.random.default_rng(0)
        reqs = [Request(rid=i, prompt=rng.integers(
                    0, cfg.vocab, SERVE["prompt"]).astype(np.int32),
                    max_new_tokens=SERVE["new"])
                for i in range(SERVE["requests"])]
        outs = {}
        for tau in (None, KV_TAU):
            eng = ServeEngine(cfg, run, params, batch_size=SERVE["slots"],
                              max_len=SERVE["max_len"], kv_tau=tau, device=dev)
            reset()
            t0 = time.perf_counter()
            outs[tau] = eng.serve(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read()
            gen_tokens = sum(len(c.tokens) for c in outs[tau])
            print(f"lm {arch} serve (kv_tau {tau}): {len(outs[tau])} "
                  f"requests, {SERVE['slots']} slots, prompt "
                  f"{SERVE['prompt']}, {gen_tokens} new tokens in {wall:.4f} "
                  f"s, {gen_tokens / wall:.2f} tokens/s, "
                  f"{wall / SERVE_STEPS * 1e3:.2f} ms per decode_step; launches "
                  f"{json.dumps(launches)}", flush=True)
            if (len(outs[tau]) != SERVE["requests"]
                    or gen_tokens != SERVE["requests"] * SERVE["new"]):
                raise CheckFailed(f"{arch} serve (kv_tau {tau}) returned "
                                  f"{len(outs[tau])} completions, "
                                  f"{gen_tokens} tokens")
            if tau is not None and cfg.family == "dense" \
                    and launches["quantize"] <= 0:
                raise CheckFailed(f"{arch}: the kv_tau run launched no "
                                  f"quantize kernel")
        agree = np.mean([np.mean(a.tokens == b.tokens)
                         for a, b in zip(outs[None], outs[KV_TAU])])
        print(f"lm {arch} serve: token agreement raw KV vs kv_tau "
              f"{KV_TAU}: {agree:.4f}" + ("" if cfg.family == "dense" else
                                          " (an SSM has no KV cache)"),
              flush=True)
        del params, eng
        torch.cuda.empty_cache()
    return prefill_launches


def _forward_plain(torch, api, params, cfg, run, tokens, kernel):
    """The last ``TAIL`` positions' fp32 logits of ``forward`` with the
    kernel's wrapper swapped, for this call only, for its plain version."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as sd

    mod, attr, plain = ((fa, "flash_attention", fa.flash_attention_plain)
                        if kernel == "flash_attention"
                        else (sd, "ssd", sd.ssd_plain))
    wrapper = getattr(mod, attr)
    setattr(mod, attr, plain)
    try:
        with torch.no_grad():
            return api.forward(params, cfg, run, tokens)[:, -TAIL:].float()
    finally:
        setattr(mod, attr, wrapper)


def _check_kv_quantize(torch, arch, caches) -> None:
    """The kv_tau path's quantize kernel on the serving path's own input: a
    prefilled K and V cache, against the plain version, bit for bit."""
    from repro_torch.kernels.quantize import ops as qz
    from repro_torch.runtime.kvcache import quantize_kv_bounded

    for name, kv in (("k", caches.k), ("v", caches.v)):
        d = kv.shape[-2] * kv.shape[-1]
        flat = kv.reshape(-1, d).float().contiguous()
        got = quantize_kv_bounded(kv, KV_TAU)
        want = qz.quantize_fused_plain(flat, 2 * KV_TAU / d ** 0.5)[1]
        if not torch.equal(got.reshape(flat.shape), want):
            raise CheckFailed(f"{arch}: quantize_kv_bounded on the prefilled "
                              f"{name} cache {tuple(kv.shape)} is not "
                              f"bit-identical to the plain version")
        print(f"lm {arch} kv_tau: quantize kernel on the prefilled {name} "
              f"cache {tuple(kv.shape)} bit-identical to the plain version",
              flush=True)


def _numel(tree):
    for v in tree.values():
        yield from (_numel(v) if isinstance(v, dict) else [v.numel()])


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
        from repro_torch.kernels.flash_attention import ops as fa
        from repro_torch.kernels.gae_project import ops as gp
        from repro_torch.kernels.quantize import ops as qz
        from repro_torch.kernels.ssd_scan import ops as sd
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
        check_gradients(torch, dev)
        counters = {"quantize": qz.launches, "block_attention": ba.launches,
                    "gae_project": gp.launches, "flash_attention": fa.launches,
                    "ssd_scan": sd.launches}
        cfg, hb = make_field()
        comp = run_fit(torch, dev, counters, cfg, hb)
        launches = run_main_path(torch, dev, counters,
                                 ("quantize", "block_attention", "gae_project"),
                                 comp, hb)
        launches = {(name, "float32"): launches[name] for name in
                    ("quantize", "block_attention", "gae_project")}
        del comp, hb
        run_launcher()
        launches.update(run_lm_path(torch, dev, counters))
    except (CheckFailed, AssertionError) as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    for key, n in launches.items():
        rows[key]["launches"] = n
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
