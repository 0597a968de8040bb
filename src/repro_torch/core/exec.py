"""Execution layer for the compression hot path, in PyTorch.

This module owns three things:

1. **Fused device-resident stage functions**: ``_encode_frontend`` runs
   HBAE-encode -> quantize -> dequantize -> HBAE-decode -> per-stage
   BAE-encode/quantize/decode/residual-update, with every latent quantized by
   the fused quantize kernel; ``_decode_backend`` runs dequantize -> HBAE/BAE
   decode -> residual sum.  ``run_compress_stage`` chains them with the
   quantized latents staying on the device, so one stripe is one upload and
   one download.  Compress and decompress both take the AE reconstruction
   from ``_decode_backend``, so the reconstruction the GAE guarantee was
   verified against is exactly the one the decoder reproduces.

2. **Stage timing / throughput counters** (``stage`` / ``stage_stats``).

3. **A shared worker pool** (``map_parallel``) for the chunk-striped host
   coders: archive chunks are independently codable by design (see
   docs/ARCHIVE_FORMAT.md).

PyTorch runs eagerly, so the JAX package's persistent jit cache and its
retrace accounting have no counterpart here.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch.core import bae as bae_mod
from repro_torch.core import hbae as hbae_mod
from repro_torch.core.quantization import dequantize
from repro_torch.kernels.quantize.ops import quantize_fused

Tensor = torch.Tensor


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card.  Without a
    card and without an explicit device this raises instead of falling back
    to the CPU quietly."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run "
                           "on the CPU")
    return torch.device("cuda")


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# stage timing / throughput counters
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StageStat:
    calls: int = 0
    seconds: float = 0.0
    values: int = 0

    def values_per_s(self) -> float:
        return self.values / self.seconds if self.seconds > 0 else 0.0


_STAGES: dict[str, StageStat] = {}
_STAGE_LOCK = threading.Lock()


@contextlib.contextmanager
def stage(name: str, n_values: int = 0):
    """Time one hot-path stage; accumulates wall time + processed values.

    Thread-safe: the codec worker pool enters stages concurrently, so every
    read-modify-write of the accumulator happens under ``_STAGE_LOCK``.
    Device work inside a stage is timed up to the point where its result is
    copied to the host, which waits for it.
    """
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record_stage(name, time.perf_counter() - t0, n_values)


def record_stage(name: str, seconds: float, n_values: int = 0,
                 calls: int = 1) -> None:
    """Accumulate a pre-measured duration into a stage counter.  Thread-safe."""
    with _STAGE_LOCK:
        st = _STAGES.setdefault(name, StageStat())
        st.calls += int(calls)
        st.seconds += float(seconds)
        st.values += int(n_values)


def stage_stats() -> dict[str, StageStat]:
    with _STAGE_LOCK:
        return {k: dataclasses.replace(v) for k, v in _STAGES.items()}


def reset_stage_stats() -> None:
    """Clear stage timings."""
    with _STAGE_LOCK:
        _STAGES.clear()


def stats_summary() -> str:
    """Human-readable per-stage throughput report."""
    return "\n".join(
        f"{name}: {st.calls} calls, {st.seconds:.3f}s, "
        f"{st.values_per_s() / 1e6:.2f} Mvalues/s"
        for name, st in sorted(stage_stats().items()))


# ---------------------------------------------------------------------------
# shared worker pool for chunk-parallel host coding
# ---------------------------------------------------------------------------

_POOL: Optional[ThreadPoolExecutor] = None
_POOL_LOCK = threading.Lock()
_WORKERS = max(1, min(32, os.cpu_count() or 1))


def _pool() -> ThreadPoolExecutor:
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(max_workers=_WORKERS,
                                       thread_name_prefix="repro-codec")
        return _POOL


def map_parallel(fn: Callable, items: Iterable) -> list:
    """``[fn(x) for x in items]`` across the shared pool, order-preserving.

    Runs the serial loop for <=1 items or on a one-core host.
    If several items raise, the exception propagated is always the one from
    the lowest-index failing item, as the serial loop would raise; items
    after the first detected failure are cancelled if they have not started.
    """
    items = list(items)
    if len(items) <= 1 or _WORKERS <= 1:
        return [fn(x) for x in items]
    futures = [_pool().submit(fn, x) for x in items]
    results: list = []
    first_err: Optional[BaseException] = None
    for f in futures:
        if first_err is None:
            try:
                results.append(f.result())
            except BaseException as e:   # noqa: BLE001 — re-raised below
                first_err = e
        else:
            f.cancel()
    if first_err is not None:
        raise first_err
    return results


# ---------------------------------------------------------------------------
# fused device-resident stage functions
# ---------------------------------------------------------------------------

def _encode_frontend(hbae_params: dict, bae_params: list, x: Tensor,
                     hb_bin: float, bae_bin: float):
    """x -> (q_lh, [q_lb per stage]), int32, on x's device.  Residual chaining
    needs the intermediate decoded reconstruction, so the decode work happens
    here too — but the reconstruction handed to callers always comes from
    ``_decode_backend`` so encode/decode agree bit-exactly."""
    latent = hbae_mod.hbae_encode(hbae_params, x)
    q_lh, deq_lh, _ = quantize_fused(latent, hb_bin)
    recon = hbae_mod.hbae_decode(hbae_params, deq_lh)
    q_lbs = []
    if bae_params:
        n, k, d = x.shape
        resid = (x - recon).reshape(n * k, d)
        for p in bae_params:
            lb = bae_mod.bae_encode(p, resid)
            q_lb, deq_lb, _ = quantize_fused(lb, bae_bin)
            r_hat = bae_mod.bae_decode(p, deq_lb)
            recon = recon + r_hat.reshape(n, k, d)
            resid = resid - r_hat
            q_lbs.append(q_lb)
    return q_lh, q_lbs


def _decode_backend(hbae_params: dict, bae_params: list, q_lh: Tensor,
                    q_lbs: list, hb_bin: float, bae_bin: float) -> Tensor:
    """(q_lh, [q_lb]) -> reconstruction."""
    recon = hbae_mod.hbae_decode(hbae_params, dequantize(q_lh, hb_bin))
    for p, q_lb in zip(bae_params, q_lbs):
        r_hat = bae_mod.bae_decode(p, dequantize(q_lb, bae_bin))
        recon = recon + r_hat.reshape(recon.shape)
    return recon


def _recon_frontend(hbae_params: dict, bae_params: list, x: Tensor) -> Tensor:
    """AE reconstruction WITHOUT latent quantization (ablation path)."""
    y, _ = hbae_mod.hbae_apply(hbae_params, x)
    recon = y
    if bae_params:
        n, k, d = x.shape
        resid = (x - y).reshape(n * k, d)
        for p in bae_params:
            r_hat, _ = bae_mod.bae_apply(p, resid)
            recon = recon + r_hat.reshape(n, k, d)
            resid = resid - r_hat
    return recon


def upload(a: np.ndarray, device: torch.device, dtype=np.float32) -> Tensor:
    """numpy -> tensor on ``device`` (shares memory on the CPU; a read-only
    array is copied first, since torch tensors are always writable)."""
    a = np.ascontiguousarray(a, dtype=dtype)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def _download(t: Tensor) -> np.ndarray:
    """Tensor -> writable numpy array (callers write GAE corrections into the
    reconstruction in place).  Every tensor passed here is a fresh result,
    so on the CPU sharing its memory is safe."""
    return t.cpu().numpy()


def _device_of(params: dict) -> torch.device:
    return params["to_latent"]["w"].device


@torch.inference_mode()
def run_compress_stage(hbae_params: dict, bae_params: list,
                       hyperblocks: np.ndarray, hb_bin: float, bae_bin: float
                       ) -> tuple[np.ndarray, list[np.ndarray], np.ndarray]:
    """Device-resident compress front-end on the params' device: one upload,
    the two stage functions (latents stay on the device between them), one
    download.

    Returns numpy ``(q_lh, [q_lb per stage], recon)``; ``recon`` is computed
    by the same ``_decode_backend`` ``run_decompress_stage`` uses, so the GAE
    encoder corrects exactly what the decoder will reproduce.
    """
    x = upload(hyperblocks, _device_of(hbae_params), np.float32)
    q_lh, q_lbs = _encode_frontend(hbae_params, bae_params, x, hb_bin, bae_bin)
    recon = _decode_backend(hbae_params, bae_params, q_lh, q_lbs, hb_bin,
                            bae_bin)
    return _download(q_lh), [_download(q) for q in q_lbs], _download(recon)


@torch.inference_mode()
def run_decompress_stage(hbae_params: dict, bae_params: list,
                         q_lh: np.ndarray, q_lbs: list, hb_bin: float,
                         bae_bin: float) -> np.ndarray:
    """Dequantize+decode back-end: one upload, one download.  Entropy-decoded
    latents arrive int64 and go up as the int32 the quantizer emits."""
    device = _device_of(hbae_params)
    recon = _decode_backend(
        hbae_params, bae_params, upload(q_lh, device, np.int32),
        [upload(q, device, np.int32) for q in q_lbs], hb_bin, bae_bin)
    return _download(recon)


@torch.inference_mode()
def run_recon_stage(hbae_params: dict, bae_params: list,
                    hyperblocks: np.ndarray) -> np.ndarray:
    """Unquantized AE reconstruction (``reconstruct_ae(quantize_latents=
    False)``)."""
    x = upload(hyperblocks, _device_of(hbae_params), np.float32)
    return _download(_recon_frontend(hbae_params, bae_params, x))
