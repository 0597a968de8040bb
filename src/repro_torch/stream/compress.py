"""Streaming compress: the batch stripe stages, pipelined.

Stage graph (one stripe = one archive chunk flows left to right)::

    dispatch ──▶ transfer ──▶ host_encode ──▶ sink
    (front-end    (wait for     (GAE bound +     (StreamingArchiveWriter
     enqueued on   the stripe's  entropy coding   .append, in-order
     the dispatch  downloads)    on the shared    reorder-buffered)
     stream)                     codec pool)

* ``dispatch`` calls ``exec.run_compress_stage_async``: on a card it enqueues
  the upload, the front-end and the downloads on the dispatch stream and
  returns.  The bounded queue to ``transfer`` (depth = ``queue_depth``)
  bounds how many stripes are in flight on the device.
* ``transfer`` blocks on ``exec.fetch_compress_stage`` (the stripe's event),
  overlapping stripe *i*'s download with stripe *i+1*'s compute.
* ``host_encode`` rides the SHARED codec worker pool (``exec.pool_submit``)
  — the same threads ``map_parallel`` uses for batch chunk fan-out — and
  calls ``HierarchicalCompressor.encode_stripe_host``, the exact function
  the batch path calls on the exact same slices.  Chunk sections are
  therefore byte-identical to the batch path BY CONSTRUCTION.  Its GAE
  selection launches kernels too, on the pool threads' default stream.
* ``sink`` appends each finished chunk to the ``StreamingArchiveWriter``
  (chunk *i* can hit disk while chunk *i+2* is still on the device) and
  collects chunks for the returned in-memory ``Archive``.

On any stage failure the scheduler drains, the writer is aborted — leaving
``<out_path>.partial`` on disk for ``read_archive(strict=False)`` salvage —
and the lowest-index stage error is re-raised.

With a ``FaultTolerance`` policy the run instead degrades gracefully:
transient stage failures retry with seeded backoff, hung attempts are
abandoned at the stage deadline, and a stripe that permanently fails (or
raises ``GuaranteeUnsatisfiable``) is QUARANTINED — re-encoded as a lossless
verbatim fallback chunk, so the finalized archive still contains every
hyper-block within tau.  Quarantined chunk indices surface in
``StreamResult.quarantined`` / ``StreamStats``.  An attempt abandoned at
its deadline keeps running on its daemon thread, and on a card may keep
launching kernels; its result is discarded.  A deadline below the stage's
real time only abandons real work.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import exec as exec_mod
from repro_torch.core.errors import TransientStageError
from repro_torch.core.options import CompressOptions
from repro_torch.core.pipeline import (Archive, ArchiveChunk,
                                       HierarchicalCompressor)
from repro_torch.parallel import mesh_exec
from repro_torch.runtime.stream_writer import StreamingArchiveWriter
from repro_torch.stream.scheduler import RetryPolicy, StageGraph, StageSpec, \
    StreamScheduler, StreamStats


@dataclasses.dataclass
class FaultTolerance:
    """Fault-tolerance posture for one streaming run.

    * ``retry`` applies per item to the dispatch/transfer/host_encode stages
      (and, with OSErrors classified transient, to the sink).
    * ``deadline_s`` arms the per-attempt watchdog on the compute stages
      (never the sink: an abandoned half-finished disk write racing its own
      retry is worse than blocking on it).
    * ``quarantine=True`` re-encodes a permanently-failed stripe as a
      lossless verbatim chunk instead of failing the run.
    """
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    deadline_s: Optional[float] = None
    quarantine: bool = True


class _Quarantined:
    """In-flight marker: this stripe permanently failed an upstream stage
    and rides the rest of the pipeline as a quarantine order."""

    def __init__(self, exc: BaseException):
        self.exc = exc


@dataclasses.dataclass
class StreamResult:
    """What ``stream_compress`` hands back."""
    archive: Archive
    stats: StreamStats
    bytes_written: int = 0        # 0 when no out_path was given
    quarantined: list = dataclasses.field(default_factory=list)
    quarantine_reasons: dict = dataclasses.field(default_factory=dict)
    chaos_injected: dict = dataclasses.field(default_factory=dict)
    # ^ faults the injector actually fired, by kind (empty when no chaos)


def stream_compress(comp: HierarchicalCompressor, hyperblocks: np.ndarray,
                    out_path: Optional[str] = None, *,
                    options: Optional[CompressOptions] = None,
                    fsync_every: bool = False,
                    fault_tolerance: Optional[FaultTolerance] = None,
                    chaos=None) -> StreamResult:
    """Pipelined compress of ``hyperblocks``; byte-identical chunks to
    ``comp.compress(hyperblocks, options=options)``.

    Configuration comes in as one ``CompressOptions``.  ``out_path`` and
    ``fsync_every`` are IO concerns of THIS entry point, not compression
    semantics, so they stay plain kwargs.  The host_encode stage runs
    ``codec_workers()`` workers, the size of the codec pool it submits to.

    When ``out_path`` is given, finished chunk sections stream into
    ``<out_path>.partial`` as they complete and the container is atomically
    finalized to ``out_path`` on success; on failure the partial is kept for
    tolerant salvage.  Without ``out_path`` only the in-memory ``Archive`` is
    produced.

    Fault tolerance arms itself from the options (``retries`` /
    ``stage_deadline_s`` / ``chaos_seed`` — any one of them set enables the
    retry → deadline → quarantine ladder).  An explicit ``fault_tolerance=``
    / ``chaos=`` object overrides the options-derived default for callers
    that need a custom ``RetryPolicy`` or ``ChaosSpec``; permanently failing
    stripes are quarantined as lossless verbatim chunks so the run still
    finalizes with every hyper-block within tau.

    With ``options.mesh`` set, aligned runs of ``n_shards`` stripes ride the
    scheduler as ONE item each (one dispatch, one stripe a shard); the
    ragged tail stays per-stripe.  The retry, deadline and quarantine
    ladder works on a group item as on a stripe item (a quarantined group
    becomes one verbatim chunk a stripe).  Chunk boundaries, chunk bytes
    and the on-disk container are identical to the single-device stream.
    """
    opts = options if options is not None else CompressOptions()
    tau = opts.tau
    queue_depth = opts.queue_depth
    mesh = comp._resolve_mesh(opts.mesh)

    ft = fault_tolerance
    if ft is None and opts.fault_tolerant():
        ft = FaultTolerance(
            retry=RetryPolicy(
                max_retries=opts.retries if opts.retries is not None else 3,
                seed=opts.chaos_seed if opts.chaos_seed is not None else 0),
            deadline_s=opts.stage_deadline_s, quarantine=True)
    if chaos is None and opts.chaos_seed is not None:
        from repro_torch.runtime.chaosinject import ChaosInjector, ChaosSpec
        chaos = ChaosInjector(ChaosSpec(seed=opts.chaos_seed,
                                        transient_rate=0.25,
                                        permanent_rate=0.05))

    cfg = comp.cfg
    n = hyperblocks.shape[0]
    gae_dim = comp.prepare_compress(hyperblocks, tau, mesh=mesh)
    spans = comp.stripe_spans(n, opts.chunk_hyperblocks,
                              with_gae=tau is not None)
    width = comp._chunk_width(opts.chunk_hyperblocks,
                              with_gae=tau is not None)
    chunks: list[Optional[ArchiveChunk]] = [None] * len(spans)
    quarantine_reasons: dict[int, str] = {}

    # Scheduler items: one a DEVICE DISPATCH, each a list of
    # (chunk_idx, span).  Unsharded: one stripe an item.  Sharded: an
    # aligned group of n_shards stripes is one item; the ragged tail stays
    # one stripe an item.
    if mesh is not None:
        groups, tail = mesh_exec.plan_shard_groups(
            spans, mesh_exec.mesh_shards(mesh))
        planned = groups + [[span] for span in tail]
    else:
        planned = [[span] for span in spans]
    items: list[list] = []
    ci = 0
    for group in planned:
        items.append([(ci + j, span) for j, span in enumerate(group)])
        ci += len(group)

    writer: Optional[StreamingArchiveWriter] = None
    if out_path is not None:
        writer = StreamingArchiveWriter(
            out_path, n_hyperblocks=n, n_values=hyperblocks.size,
            chunk_hyperblocks=width, gae_dim=gae_dim, spans=spans,
            fsync_every=fsync_every)

    def dispatch(i: int, item: list) -> tuple:
        if len(item) == 1:
            _, (start, n_hb) = item[0]
            return item, [exec_mod.run_compress_stage_async(
                comp.hbae_params, comp._stage_params(),
                hyperblocks[start:start + n_hb], cfg.hb_bin, cfg.bae_bin)]
        start, stop = mesh_exec.group_slice([span for _, span in item])
        handles = exec_mod.run_compress_stage_sharded_async(
            comp.hbae_params, comp._stage_params(), hyperblocks[start:stop],
            cfg.hb_bin, cfg.bae_bin, mesh)
        exec_mod.counter_max("mesh.shards", len(item))
        exec_mod.counter_add("mesh.sharded_groups")
        return item, handles

    def transfer(i: int, payload):
        if isinstance(payload, _Quarantined):
            return payload                     # ride through to host_encode
        item, handles = payload
        return [(ci, span, exec_mod.fetch_compress_stage(h))
                for (ci, span), h in zip(item, handles)]

    def quarantine_encode(i: int, exc: BaseException) -> list:
        out = []
        for ci, (start, n_hb) in items[i]:
            quarantine_reasons[ci] = repr(exc)
            out.append((ci, comp.encode_stripe_verbatim(
                start, hyperblocks[start:start + n_hb])))
        return out

    def host_encode(i: int, payload) -> list:
        if isinstance(payload, _Quarantined):
            return quarantine_encode(i, payload.exc)
        # ride the shared codec pool — same workers as batch map_parallel;
        # a group item fans its stripes out across the pool at once
        futures = [(ci, exec_mod.pool_submit(
            comp.encode_stripe_host, start, hyperblocks[start:start + n_hb],
            q_lh, q_lbs, recon, tau, gae_dim))
            for ci, (start, n_hb), (q_lh, q_lbs, recon) in payload]
        return [(ci, f.result()) for ci, f in futures]

    def sink(i: int, encoded: list) -> int:
        for ci, chunk in encoded:
            chunks[ci] = chunk
            if writer is not None:
                try:
                    writer.append(ci, chunk)
                except OSError as e:
                    # transient disk errors ride the retry ladder; append is
                    # idempotent under retry (byte-identical re-append), so
                    # a group item replays its already-durable chunks safely
                    raise TransientStageError(
                        f"sink append of chunk {ci} failed: {e}") from e
        return i

    retry = ft.retry if ft is not None else None
    deadline = ft.deadline_s if ft is not None else None
    fallback = (lambda i, payload, exc: _Quarantined(exc)) \
        if ft is not None and ft.quarantine else None
    encode_fallback = (lambda i, payload, exc: quarantine_encode(i, exc)) \
        if ft is not None and ft.quarantine else None

    workers = exec_mod.codec_workers()
    graph = StageGraph([
        StageSpec("dispatch", dispatch, workers=1, queue_depth=queue_depth,
                  retry=retry, deadline_s=deadline, fallback=fallback),
        StageSpec("transfer", transfer, workers=1, queue_depth=queue_depth,
                  retry=retry, deadline_s=deadline, fallback=fallback),
        StageSpec("host_encode", host_encode, workers=workers,
                  queue_depth=max(queue_depth, workers),
                  retry=retry, deadline_s=deadline,
                  fallback=encode_fallback),
        StageSpec("sink", sink, workers=1, queue_depth=1, retry=retry),
    ])

    bytes_written = 0
    try:
        _, stats = StreamScheduler(graph, chaos=chaos).run(items)
    except BaseException:      # retry-boundary: abort the writer, re-raise
        if writer is not None:
            writer.abort()     # keep <out_path>.partial for tolerant salvage
        raise
    if writer is not None:
        bytes_written = writer.finalize()

    archive = Archive(n_hyperblocks=n, n_values=hyperblocks.size,
                      chunk_hyperblocks=width, gae_dim=gae_dim, chunks=chunks)
    quarantined = archive.verbatim_chunks()
    stats.quarantined = list(quarantined)
    if quarantined:
        exec_mod.counter_add("stream.quarantined_chunks", len(quarantined))
    return StreamResult(archive=archive, stats=stats,
                        bytes_written=bytes_written,
                        quarantined=quarantined,
                        quarantine_reasons=dict(quarantine_reasons),
                        chaos_injected=(dict(chaos.injected)
                                        if chaos is not None else {}))
