"""Execution layer for the compression hot path, in PyTorch.

This module owns three things:

1. **Fused device-resident stage functions**: ``_encode_frontend`` runs
   HBAE-encode -> quantize -> dequantize -> HBAE-decode -> per-stage
   BAE-encode/quantize/decode/residual-update, with every latent quantized by
   the fused quantize kernel; ``_decode_backend`` runs dequantize -> HBAE/BAE
   decode -> residual sum.  ``run_compress_stage_async`` chains them with the
   quantized latents staying on the device and starts the downloads;
   ``fetch_compress_stage`` waits for them.  ``run_compress_stage`` is the
   two in a row, so the batch and streaming paths run one code path and
   give the same bytes.  Compress and decompress both take the AE
   reconstruction from ``_decode_backend``, so the reconstruction the GAE
   guarantee was verified against is exactly the one the decoder
   reproduces.

   ``run_compress_stage_sharded{,_async}`` and
   ``run_decompress_stage_sharded`` run the same functions over a mesh of
   devices, one stripe per shard (``repro_torch.parallel.mesh_exec``).

2. **Stage timing / throughput counters** (``stage`` / ``stage_stats``)
   and gauges (``counter_add`` / ``counter_max``: queue depths, overlap
   seconds of the streaming scheduler).

3. **A shared worker pool** (``map_parallel``, ``pool_submit``) for the
   chunk-striped host coders: archive chunks are independently codable by
   design (see docs/ARCHIVE_FORMAT.md).  ``REPRO_CODEC_WORKERS`` sets its
   width.

PyTorch runs eagerly, so the JAX package's persistent jit cache and its
retrace accounting have no counterpart here.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
import weakref
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Iterable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import bae as bae_mod
from repro_torch.core import hbae as hbae_mod
from repro_torch.core.errors import ConfigError, TransientStageError
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

    Thread-safe: the codec worker pool and the streaming scheduler both enter
    stages concurrently, so every read-modify-write of the accumulator
    happens under ``_STAGE_LOCK``.
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
    """Clear stage timings AND the gauge/counter registry."""
    with _STAGE_LOCK:
        _STAGES.clear()
        _COUNTERS.clear()


# -- gauge/counter registry (queue depths, overlap seconds, ...) ------------
# Scalar counters that don't fit the calls/seconds/values shape of StageStat:
# the streaming scheduler records max queue depths and measured stage
# overlap here.  Shares _STAGE_LOCK so a stats snapshot is one lock hop.

_COUNTERS: dict[str, float] = {}


def counter_add(name: str, delta: float = 1.0) -> None:
    with _STAGE_LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0.0) + float(delta)


def counter_max(name: str, value: float) -> None:
    """Record a high-water mark (e.g. observed queue depth)."""
    with _STAGE_LOCK:
        if value > _COUNTERS.get(name, float("-inf")):
            _COUNTERS[name] = float(value)


def counters() -> dict[str, float]:
    with _STAGE_LOCK:
        return dict(_COUNTERS)


def stats_summary() -> str:
    """Human-readable per-stage throughput + counter report."""
    lines = [f"{name}: {st.calls} calls, {st.seconds:.3f}s, "
             f"{st.values_per_s() / 1e6:.2f} Mvalues/s"
             for name, st in sorted(stage_stats().items())]
    lines += [f"{name}: {value:g}"
              for name, value in sorted(counters().items())]
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# shared worker pool for chunk-parallel host coding
# ---------------------------------------------------------------------------

_POOL: Optional[ThreadPoolExecutor] = None
_POOL_LOCK = threading.Lock()


def codec_workers() -> int:
    """Worker count for chunk-parallel host coding (env-overridable;
    ``REPRO_CODEC_WORKERS=1`` forces the serial path)."""
    env = os.environ.get("REPRO_CODEC_WORKERS", "")
    if env.strip():
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return max(1, min(32, os.cpu_count() or 1))


def _pool() -> ThreadPoolExecutor:
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(max_workers=codec_workers(),
                                       thread_name_prefix="repro-codec")
        return _POOL


def reset_pool() -> None:
    """Tear down the shared codec pool; the next submission lazily rebuilds
    it.  Used by tests/chaos to emulate losing the host worker pool."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is not None:
            _POOL.shutdown(wait=False, cancel_futures=True)
        _POOL = None


def pool_submit(fn: Callable, *args, **kwargs) -> Future:
    """Submit one call onto the shared codec pool (the streaming scheduler's
    host-encode stage rides the same workers as ``map_parallel``).

    A submission refused because the executor was shut down rebuilds the
    pool once and resubmits; a second refusal surfaces as
    ``TransientStageError`` so the streaming retry ladder (not the caller)
    owns the failure.
    """
    global _POOL
    try:
        return _pool().submit(fn, *args, **kwargs)
    except RuntimeError:
        with _POOL_LOCK:
            _POOL = None
        try:
            return _pool().submit(fn, *args, **kwargs)
        except RuntimeError as e:
            raise TransientStageError(
                f"codec pool rejected submission: {e}") from e


def map_parallel(fn: Callable, items: Iterable) -> list:
    """``[fn(x) for x in items]`` across the shared pool, order-preserving.

    Runs the serial loop for <=1 items or a 1-worker configuration.
    If several items raise, the exception propagated is always the one from
    the lowest-index failing item, as the serial loop would raise; items
    after the first detected failure are cancelled if they have not started.
    """
    items = list(items)
    if len(items) <= 1 or codec_workers() <= 1:
        return [fn(x) for x in items]
    futures = [pool_submit(fn, x) for x in items]
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


# ---------------------------------------------------------------------------
# the compress front-end, split into dispatch and fetch
# ---------------------------------------------------------------------------
# On a card the front-end runs on one dispatch stream per device, apart from
# the default stream on which the codec pool's threads run the GAE selection.
# Every tensor of a dispatch is made and read on that stream (the caching
# allocator hands a freed block out again only to later work on the same
# stream), so none needs ``record_stream``; the params, made earlier on the
# caller's stream, are ordered by ``wait_stream``.  The stripe goes up from,
# and the results come down into, pinned host tensors with non-blocking
# copies; PyTorch's pinned-memory allocator records an event on each copy, so
# a pinned block is not handed out again before its copy has finished.  Each
# dispatch gets its own result tensors, which live as long as the numpy views
# ``fetch_compress_stage`` returns of them.

_DISPATCH_STREAMS: dict = {}
_DISPATCH_LOCK = threading.Lock()


def _dispatch_stream(device: torch.device):
    """The dispatch stream of ``device``, made on first use."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    with _DISPATCH_LOCK:
        stream = _DISPATCH_STREAMS.get(index)
        if stream is None:
            stream = _DISPATCH_STREAMS[index] = torch.cuda.Stream(index)
        return stream


def _pinned_from(a: np.ndarray) -> Tensor:
    """numpy float32 -> a new pinned host tensor holding a copy of it."""
    buf = torch.empty(a.shape, dtype=torch.float32, pin_memory=True)
    buf.numpy()[...] = a
    return buf


def _pinned_copy_of(t: Tensor) -> Tensor:
    """Start the device-to-host copy of ``t`` into a new pinned tensor on
    the current stream."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


class StageHandles(NamedTuple):
    """What ``run_compress_stage_async`` hands back: the host tensors the
    results land in and the event that marks their arrival (``None`` on the
    CPU, where the work is done when the call returns)."""
    q_lh: Tensor
    q_lbs: list
    recon: Tensor
    done: Optional[object]


@torch.inference_mode()
def run_compress_stage_async(hbae_params: dict, bae_params: list,
                             hyperblocks: np.ndarray, hb_bin: float,
                             bae_bin: float) -> StageHandles:
    """Dispatch the compress front-end on the params' device WITHOUT waiting
    for its result: one upload, the two stage functions (latents stay on the
    device between them), and the downloads of ``q_lh``, each ``q_lb`` and
    ``recon`` started.  The streaming scheduler dispatches stripe *i+1*
    while stripe *i*'s results are still being computed or copied.  Pass
    the handles to ``fetch_compress_stage``.

    The stream and ``inference_mode`` are entered here, in the calling
    thread: both are thread-local, and the scheduler may call this from a
    fresh watchdog thread.  On the CPU the work runs to its end in the call.
    """
    device = _device_of(hbae_params)
    if device.type != "cuda":
        x = upload(hyperblocks, device, np.float32)
        q_lh, q_lbs = _encode_frontend(hbae_params, bae_params, x, hb_bin,
                                       bae_bin)
        recon = _decode_backend(hbae_params, bae_params, q_lh, q_lbs, hb_bin,
                                bae_bin)
        return StageHandles(q_lh, q_lbs, recon, None)
    stream = _dispatch_stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        x = _pinned_from(np.ascontiguousarray(hyperblocks, np.float32)).to(
            device, non_blocking=True)
        q_lh, q_lbs = _encode_frontend(hbae_params, bae_params, x, hb_bin,
                                       bae_bin)
        recon = _decode_backend(hbae_params, bae_params, q_lh, q_lbs, hb_bin,
                                bae_bin)
        host = [_pinned_copy_of(t) for t in (q_lh, *q_lbs, recon)]
        done = torch.cuda.Event()
        done.record(stream)
    return StageHandles(host[0], host[1:-1], host[-1], done)


def fetch_compress_stage(handles: StageHandles
                         ) -> tuple[np.ndarray, list[np.ndarray], np.ndarray]:
    """Wait until the dispatched front-end's downloads have landed and return
    numpy views of them; the views share memory with the host tensors and
    keep them alive."""
    if handles.done is not None:
        handles.done.synchronize()
    return (handles.q_lh.numpy(), [q.numpy() for q in handles.q_lbs],
            handles.recon.numpy())


def run_compress_stage(hbae_params: dict, bae_params: list,
                       hyperblocks: np.ndarray, hb_bin: float, bae_bin: float
                       ) -> tuple[np.ndarray, list[np.ndarray], np.ndarray]:
    """Device-resident compress front-end, run to its end: the batch path's
    ``fetch_compress_stage(run_compress_stage_async(...))``.

    Returns numpy ``(q_lh, [q_lb per stage], recon)``; ``recon`` is computed
    by the same ``_decode_backend`` ``run_decompress_stage`` uses, so the GAE
    encoder corrects exactly what the decoder will reproduce.
    """
    return fetch_compress_stage(run_compress_stage_async(
        hbae_params, bae_params, hyperblocks, hb_bin, bae_bin))


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


# ---------------------------------------------------------------------------
# the sharded stage path: one process over a mesh of devices
# ---------------------------------------------------------------------------
# Shard i of a group runs exactly what ``run_compress_stage_async`` runs on
# one stripe, on ``mesh.devices[i]``: per-shard shapes equal per-stripe
# shapes, so the kernels, their launches and their bits are the unsharded
# path's.  Shards on one device share that device's one dispatch stream, so
# the allocator argument above holds for them unchanged.  Params are
# replicated once to each device of the mesh that does not hold them, and
# the replicas are cached per (params, device): the counterpart of the JAX
# package's ``P()`` replication and of its mesh-keyed program cache.  On the
# device that holds the params the replica is the params themselves.

class _Replica(NamedTuple):
    refs: tuple          # weak references to the source leaves
    versions: tuple      # their in-place version counters when copied
    params: tuple        # (hbae_params, bae_params) on the target device


_REPLICAS: dict = {}
_REPLICA_LOCK = threading.Lock()


def _tensor_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for key in sorted(tree) for t in _tensor_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [t for item in tree for t in _tensor_leaves(item)]
    return [tree] if isinstance(tree, Tensor) else []


def _moved(tree, device: torch.device):
    if isinstance(tree, dict):
        return {key: _moved(value, device) for key, value in tree.items()}
    if isinstance(tree, list):
        return [_moved(item, device) for item in tree]
    if isinstance(tree, Tensor):
        return tree.to(device)
    return tree


def replicate_params(hbae_params: dict, bae_params: list,
                     device: torch.device) -> tuple[dict, list]:
    """``(hbae_params, bae_params)`` on ``device``: the params themselves on
    their own device, else a copy made once and cached until a source
    tensor dies or is changed in place.  A device of another type than the
    params' is a :class:`ConfigError`: nothing moves between the card and
    the CPU."""
    home = _device_of(hbae_params)
    if device.type != home.type:
        raise ConfigError(f"cannot replicate params on {home} to {device}: "
                          f"a compress mesh stays on the compressor's "
                          f"device type")
    if device == home:
        return hbae_params, bae_params
    leaves = _tensor_leaves((hbae_params, bae_params))
    key = (device, tuple(id(t) for t in leaves))
    versions = tuple(t._version for t in leaves)
    with _REPLICA_LOCK:
        hit = _REPLICAS.get(key)
        if hit is not None and hit.versions == versions and all(
                ref() is t for ref, t in zip(hit.refs, leaves)):
            return hit.params
        for stale in [k for k, v in _REPLICAS.items()
                      if any(ref() is None for ref in v.refs)]:
            del _REPLICAS[stale]
        params = (_moved(hbae_params, device),
                  [_moved(p, device) for p in bae_params])
        _REPLICAS[key] = _Replica(tuple(weakref.ref(t) for t in leaves),
                                  versions, params)
    counter_add("mesh.param_replicas")
    return params


def _shard_rows(n_rows: int, n_shards: int) -> int:
    rows, rem = divmod(n_rows, n_shards)
    if rem:
        raise ConfigError(f"{n_rows} hyper-blocks do not split into "
                          f"{n_shards} equal shards")
    return rows


def run_compress_stage_sharded_async(hbae_params: dict, bae_params: list,
                                     stacked: np.ndarray, hb_bin: float,
                                     bae_bin: float, mesh
                                     ) -> list[StageHandles]:
    """Dispatch the compress front-end for ONE shard group: ``stacked`` is
    ``n_shards`` equal-width stripes on the hyper-block axis.  Every shard
    is dispatched (``run_compress_stage_async`` on its stripe, with the
    params replicated to its device) before any is fetched.  Returns one
    ``StageHandles`` per shard, in shard order; pass each to
    ``fetch_compress_stage``."""
    rows = _shard_rows(stacked.shape[0], len(mesh.devices))
    handles = []
    for i, device in enumerate(mesh.devices):
        h, b = replicate_params(hbae_params, bae_params, device)
        handles.append(run_compress_stage_async(
            h, b, stacked[i * rows:(i + 1) * rows], hb_bin, bae_bin))
    return handles


def run_compress_stage_sharded(hbae_params: dict, bae_params: list,
                               stacked: np.ndarray, hb_bin: float,
                               bae_bin: float, mesh) -> list[tuple]:
    """The sharded compress front-end for one shard group, run to its end:
    ``[(q_lh, [q_lb per stage], recon)]`` per shard, in shard order (the
    JAX package returns their concatenation, which both of its callers
    slice back into these).  Stage time is recorded under
    ``ae_encode_sharded`` with ``calls`` = the shard count."""
    n_shards = len(mesh.devices)
    t0 = time.perf_counter()
    out = [fetch_compress_stage(h) for h in run_compress_stage_sharded_async(
        hbae_params, bae_params, stacked, hb_bin, bae_bin, mesh)]
    record_stage("ae_encode_sharded", time.perf_counter() - t0,
                 int(stacked.size), calls=n_shards)
    counter_max("mesh.shards", n_shards)
    counter_add("mesh.sharded_groups")
    return out


@torch.inference_mode()
def run_decompress_stage_sharded(hbae_params: dict, bae_params: list,
                                 q_lh: np.ndarray, q_lbs: list,
                                 hb_bin: float, bae_bin: float, mesh
                                 ) -> np.ndarray:
    """Dequantize+decode back-end over the mesh: hyper-block rows are
    zero-padded to an even shard split (padded rows decode to garbage and
    are sliced off), every shard's decode is dispatched on its device
    before any is downloaded.  ``q_lbs`` rows group ``k`` blocks a
    hyper-block, so they are padded by ``pad * k`` rows and stay aligned
    with ``q_lh``'s shard boundaries."""
    n_shards = len(mesh.devices)
    n = q_lh.shape[0]
    pad = (-n) % n_shards
    ks = [q.shape[0] // max(n, 1) for q in q_lbs]
    if pad:
        q_lh = np.concatenate(
            [q_lh, np.zeros((pad,) + q_lh.shape[1:], q_lh.dtype)], axis=0)
        q_lbs = [np.concatenate(
            [q, np.zeros((pad * k,) + q.shape[1:], q.dtype)], axis=0)
            for q, k in zip(q_lbs, ks)]
    rows = (n + pad) // n_shards
    t0 = time.perf_counter()
    recons = []
    for i, device in enumerate(mesh.devices):
        h, b = replicate_params(hbae_params, bae_params, device)
        lo, hi = i * rows, (i + 1) * rows
        recons.append(_decode_backend(
            h, b, upload(q_lh[lo:hi], device, np.int32),
            [upload(q[lo * k:hi * k], device, np.int32)
             for q, k in zip(q_lbs, ks)], hb_bin, bae_bin))
    recon = np.concatenate([_download(r) for r in recons], axis=0)[:n]
    record_stage("ae_decode_sharded", time.perf_counter() - t0,
                 int(recon.size), calls=n_shards)
    counter_max("mesh.shards", n_shards)
    return recon
