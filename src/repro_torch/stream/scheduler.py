"""Pipelined stage scheduler: bounded queues, backpressure, overlap metering.

A ``StageGraph`` is a linear chain of ``StageSpec``s.  ``StreamScheduler``
runs every input item through every stage on dedicated worker threads, with a
bounded ``queue.Queue`` between consecutive stages:

* **Backpressure** — ``queue_depth`` caps how many finished results of stage
  *s* may wait for stage *s+1*.  A full queue blocks stage *s*'s workers (and
  ultimately the feeder), so a slow host coder throttles device dispatch
  instead of accumulating unbounded device buffers.  Depth 1 between the
  dispatch and transfer stages is classic double-buffering: one stripe being
  fetched while at most ``depth + 1`` are in flight behind it.
* **Ordered feed, unordered completion** — items enter stage 0 in index
  order; stages with several workers may finish out of order.  Results are
  collected by index, so downstream consumers (the streaming archive writer)
  see a deterministic mapping regardless of thread scheduling.
* **Deterministic failures** — a stage raising on item *j* records the error
  and drops *j* from the pipeline; every other item still runs to completion
  (no short-circuit racing).  After the drain, the scheduler raises the error
  of the LOWEST failing index — the same exception a serial loop would have
  raised — so streaming failures are reproducible in tests.
* **Shutdown** — the feeder appends one sentinel per stage-0 worker; the last
  worker of each stage to see its sentinel forwards sentinels downstream, so
  every thread exits even on partial failure.

Overlap metering: a shared ``_BusyTracker`` integrates wall time over the
run, attributing each interval by how many DISTINCT stages had a busy worker
— ``busy_s`` (>= 1 stage active) and ``overlap_s`` (>= 2 stages active).
It counts stages that are busy on the host's clock, not device overlap: a
stage waiting on the card counts as busy, and the host-encode stage also
launches kernels.  A device profile says what the card did.  Per-stage busy time
feeds ``exec.record_stage("stream.<name>", ...)`` and queue high-water marks
feed ``exec.counter_max``, so ``exec.stats_summary()`` shows the whole
picture next to the batch counters.

Fault tolerance (the retry → failover ladder, per item, per stage):

* **Retry** — a ``StageSpec`` with a ``RetryPolicy`` re-runs an attempt that
  raised a transient error (``TransientStageError``, which includes deadline
  hits) with seeded exponential backoff + jitter.  Backoff delays are a pure
  function of ``(policy.seed, stage, item, attempt)``, so the retry timeline
  is reproducible run to run — the determinism the chaos harness asserts.
* **Deadline** — a ``deadline_s`` stage runs each attempt on a disposable
  watchdog thread and abandons it past the deadline
  (``StageDeadlineExceeded``).  The worker keeps draining its queue, so a
  hung attempt can never deadlock the bounded queues; the abandoned call
  finishes (or not) on a daemon thread whose result is discarded.
* **Failover** — when retries are exhausted (or the error is permanent) a
  stage's ``fallback(index, payload, exc)`` may substitute a result and keep
  the item alive (the compress pipeline uses this to quarantine a poison
  stripe into a lossless verbatim chunk).  Without a fallback the item is
  dropped and its error re-raised after the drain, exactly as before.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
import zlib
from typing import Any, Callable, Optional, Sequence

from repro_torch.core import exec as exec_mod
from repro_torch.core.errors import StageDeadlineExceeded, TransientStageError

_SENTINEL = object()


def _unit_hash(*parts) -> float:
    """Deterministic (cross-process, hash-seed independent) uniform in
    [0, 1) from the given parts — the seeded jitter source.

    crc32 alone has poor avalanche on near-identical strings (draws for
    adjacent items land within ~1% of each other), so a murmur-style 32-bit
    finalizer decorrelates the bits before normalizing."""
    h = zlib.crc32("|".join(map(str, parts)).encode())
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & 0xFFFFFFFF
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & 0xFFFFFFFF
    return (h ^ (h >> 16)) / 2.0 ** 32


@dataclasses.dataclass
class RetryPolicy:
    """Per-item, per-stage retry schedule for transient failures.

    ``delay(stage, item, attempt)`` is a pure function of the policy seed and
    the coordinates — same seed, same failure pattern => same retry timeline,
    which is what makes chaos runs reproducible.
    """
    max_retries: int = 3
    base_backoff_s: float = 0.01
    max_backoff_s: float = 1.0
    jitter: float = 0.25              # +[0, jitter) fraction on top of base
    seed: int = 0
    retryable: Optional[Callable[[BaseException], bool]] = None

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.base_backoff_s < 0 or self.max_backoff_s < 0:
            raise ValueError("backoff seconds must be >= 0")

    def is_transient(self, exc: BaseException) -> bool:
        if self.retryable is not None:
            return bool(self.retryable(exc))
        return isinstance(exc, TransientStageError)

    def delay(self, stage: str, item: int, attempt: int) -> float:
        base = min(self.max_backoff_s, self.base_backoff_s * (2 ** attempt))
        u = _unit_hash("backoff", self.seed, stage, item, attempt)
        return base * (1.0 + self.jitter * u)


@dataclasses.dataclass
class StageSpec:
    """One pipeline stage.

    ``fn(index, payload) -> result``; the result is the next stage's payload.
    ``workers`` threads run the stage concurrently; ``queue_depth`` bounds the
    stage's INPUT queue — how many upstream results may wait for this stage
    before the upstream workers (or the feeder, for stage 0) block.

    Fault-tolerance knobs (all optional; defaults keep the pre-existing
    fail-fast semantics):

    * ``retry`` — retry transient failures per ``RetryPolicy``.
    * ``deadline_s`` — per-attempt watchdog; a hung attempt is abandoned and
      surfaces as ``StageDeadlineExceeded`` (transient, so retryable).
    * ``fallback(index, payload, exc)`` — called when an item permanently
      fails this stage; its return value is forwarded downstream in place of
      the stage result.  If the fallback itself raises, the item is dropped
      and that error is recorded.
    """
    name: str
    fn: Callable[[int, Any], Any]
    workers: int = 1
    queue_depth: int = 2
    retry: Optional[RetryPolicy] = None
    deadline_s: Optional[float] = None
    fallback: Optional[Callable[[int, Any, BaseException], Any]] = None

    def __post_init__(self):
        if self.workers < 1:
            raise ValueError(f"stage {self.name!r}: workers must be >= 1")
        if self.queue_depth < 1:
            raise ValueError(f"stage {self.name!r}: queue_depth must be >= 1")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"stage {self.name!r}: deadline_s must be > 0")


class StageGraph:
    """A linear chain of stages (the only topology the compress path needs;
    fan-out lives inside a stage via the shared codec pool)."""

    def __init__(self, stages: Sequence[StageSpec]):
        if not stages:
            raise ValueError("StageGraph needs at least one stage")
        names = [s.name for s in stages]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stage names: {names}")
        self.stages = list(stages)


@dataclasses.dataclass
class StreamStats:
    """Measured pipeline behavior for one ``run``."""
    n_items: int = 0
    wall_s: float = 0.0
    busy_s: float = 0.0      # wall time with >= 1 stage busy
    overlap_s: float = 0.0   # wall time with >= 2 distinct stages busy
    stage_busy_s: dict = dataclasses.field(default_factory=dict)
    queue_high_water: dict = dataclasses.field(default_factory=dict)
    # fault-tolerance accounting (empty on a clean run)
    retries: dict = dataclasses.field(default_factory=dict)        # per stage
    deadline_hits: dict = dataclasses.field(default_factory=dict)  # per stage
    failovers: dict = dataclasses.field(default_factory=dict)      # per stage
    retry_events: list = dataclasses.field(default_factory=list)
    #   ^ [(stage, item, attempt, delay_s), ...] — the deterministic timeline
    quarantined: list = dataclasses.field(default_factory=list)
    #   ^ item indices whose shipped result is a fallback (set by the
    #     compress pipeline, which knows what a fallback result means)

    def overlap_efficiency(self) -> float:
        """Fraction of the wall clock during which at least two pipeline
        stages were simultaneously busy (1.0 = perfectly overlapped)."""
        return self.overlap_s / self.wall_s if self.wall_s > 0 else 0.0

    def total_retries(self) -> int:
        return sum(self.retries.values())


class _BusyTracker:
    """Integrates wall time by the number of distinct busy stages."""

    def __init__(self):
        self._lock = threading.Lock()
        self._active: dict[str, int] = {}
        self._last = time.perf_counter()
        self.busy_s = 0.0
        self.overlap_s = 0.0

    def _advance(self) -> None:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        distinct = sum(1 for v in self._active.values() if v > 0)
        if distinct >= 1:
            self.busy_s += dt
        if distinct >= 2:
            self.overlap_s += dt

    def enter(self, name: str) -> None:
        with self._lock:
            self._advance()
            self._active[name] = self._active.get(name, 0) + 1

    def exit(self, name: str) -> None:
        with self._lock:
            self._advance()
            self._active[name] -= 1


class StreamScheduler:
    """Runs items through a ``StageGraph`` with bounded inter-stage queues.

    ``chaos`` (optional) is a fault injector consulted before every attempt:
    ``chaos.before(stage_name, item_index, attempt)`` may raise (injected
    transient/permanent fault) or sleep (injected hang — covered by the
    stage deadline because the call runs inside the watchdog thread).  See
    ``repro_torch.runtime.chaosinject``.
    """

    def __init__(self, graph: StageGraph, *, chaos=None):
        self.graph = graph
        self.chaos = chaos

    def _attempt(self, spec: StageSpec, idx: int, payload, attempt: int):
        """Run one attempt of ``spec.fn`` (chaos hook included), abandoning
        it past ``spec.deadline_s`` on a disposable watchdog thread."""
        chaos = self.chaos

        def invoke():
            if chaos is not None:
                chaos.before(spec.name, idx, attempt)
            return spec.fn(idx, payload)

        if spec.deadline_s is None:
            return invoke()
        box: dict = {}
        done = threading.Event()

        def guarded():
            try:
                box["result"] = invoke()
            except BaseException as e:   # retry-boundary: re-raised below
                box["error"] = e
            finally:
                done.set()

        t = threading.Thread(target=guarded, daemon=True,
                             name=f"stream-{spec.name}-attempt-{idx}")
        t.start()
        if not done.wait(spec.deadline_s):
            # the attempt keeps running on its daemon thread; its boxed
            # result (if it ever arrives) is never read again
            raise StageDeadlineExceeded(spec.name, idx, spec.deadline_s)
        if "error" in box:
            raise box["error"]
        return box["result"]

    def run(self, items: Sequence) -> tuple[list, StreamStats]:
        """Push every item through the pipeline; returns ``(results, stats)``
        with ``results[i]`` = last stage's output for item ``i``.

        Raises the lowest-index stage error after ALL other items have
        drained (deterministic regardless of worker scheduling); the partial
        results of non-failing items are discarded by the raise, but their
        side effects (e.g. archive-writer appends) have already happened.
        """
        stages = self.graph.stages
        items = list(items)
        stats = StreamStats(n_items=len(items))
        if not items:
            return [], stats

        # queues[s] feeds stage s; the feeder owns queues[0].
        queues: list[queue.Queue] = [
            queue.Queue(maxsize=max(1, spec.queue_depth))
            for spec in stages]
        results: dict[int, Any] = {}
        errors: dict[int, BaseException] = {}
        stage_busy: dict[str, float] = {s.name: 0.0 for s in stages}
        high_water: dict[str, int] = {s.name: 0 for s in stages}
        remaining = [s.workers for s in stages]   # workers yet to shut down
        lock = threading.Lock()
        busy = _BusyTracker()

        def process(spec: StageSpec, idx: int, payload) -> tuple[bool, Any]:
            """Retry → failover ladder for one item; returns (ok, result).
            On ``ok=False`` the error has been recorded and the item drops
            out of the pipeline."""
            attempt = 0
            while True:
                try:
                    return True, self._attempt(spec, idx, payload, attempt)
                except BaseException as e:   # retry-boundary: ladder below
                    if isinstance(e, StageDeadlineExceeded):
                        with lock:
                            stats.deadline_hits[spec.name] = \
                                stats.deadline_hits.get(spec.name, 0) + 1
                    policy = spec.retry
                    if (policy is not None and policy.is_transient(e)
                            and attempt < policy.max_retries):
                        delay = policy.delay(spec.name, idx, attempt)
                        with lock:
                            stats.retries[spec.name] = \
                                stats.retries.get(spec.name, 0) + 1
                            stats.retry_events.append(
                                (spec.name, idx, attempt, round(delay, 9)))
                        time.sleep(delay)
                        attempt += 1
                        continue
                    if spec.fallback is not None:
                        try:
                            result = spec.fallback(idx, payload, e)
                        except BaseException as e2:   # retry-boundary
                            with lock:
                                errors[idx] = e2
                            return False, None
                        with lock:
                            stats.failovers[spec.name] = \
                                stats.failovers.get(spec.name, 0) + 1
                        return True, result
                    with lock:
                        errors[idx] = e
                    return False, None

        def worker(si: int) -> None:
            spec = stages[si]
            in_q = queues[si]
            out_q = queues[si + 1] if si + 1 < len(stages) else None
            while True:
                with lock:
                    depth = in_q.qsize()
                    if depth > high_water[spec.name]:
                        high_water[spec.name] = depth
                task = in_q.get()
                if task is _SENTINEL:
                    break
                idx, payload = task
                t0 = time.perf_counter()
                busy.enter(spec.name)
                try:
                    ok, result = process(spec, idx, payload)
                    if ok:
                        if out_q is not None:
                            out_q.put((idx, result))
                        else:
                            with lock:
                                results[idx] = result
                finally:
                    busy.exit(spec.name)
                    dt = time.perf_counter() - t0
                    with lock:
                        stage_busy[spec.name] += dt
            # last worker out forwards shutdown downstream
            with lock:
                remaining[si] -= 1
                last = remaining[si] == 0
            if last and si + 1 < len(stages):
                for _ in range(stages[si + 1].workers):
                    queues[si + 1].put(_SENTINEL)

        t_start = time.perf_counter()
        threads = [threading.Thread(target=worker, args=(si,),
                                    name=f"stream-{spec.name}-{w}",
                                    daemon=True)
                   for si, spec in enumerate(stages)
                   for w in range(spec.workers)]
        for t in threads:
            t.start()
        for i, item in enumerate(items):
            queues[0].put((i, item))          # blocks when stage 0 backs up
        for _ in range(stages[0].workers):
            queues[0].put(_SENTINEL)
        for t in threads:
            t.join()
        stats.wall_s = time.perf_counter() - t_start
        # the per-(stage, item) retry timeline is deterministic; the GLOBAL
        # append order is thread-interleaving noise — canonicalize it so
        # same-seed runs compare equal (the chaos determinism invariant)
        stats.retry_events.sort()
        stats.busy_s = busy.busy_s
        stats.overlap_s = busy.overlap_s
        stats.stage_busy_s = dict(stage_busy)
        stats.queue_high_water = dict(high_water)

        # fold into the global exec counters so launch/compress.py and the
        # benchmarks surface pipeline behavior via exec.stats_summary()
        for name, seconds in stage_busy.items():
            exec_mod.record_stage(f"stream.{name}", seconds, calls=1)
        for name, depth in high_water.items():
            exec_mod.counter_max(f"stream.queue_high_water.{name}", depth)
        exec_mod.counter_add("stream.overlap_s", stats.overlap_s)
        exec_mod.counter_add("stream.busy_s", stats.busy_s)
        exec_mod.counter_max("stream.overlap_efficiency",
                             round(stats.overlap_efficiency(), 4))
        if stats.retries:
            exec_mod.counter_add("stream.retries", stats.total_retries())
        for name, hits in stats.deadline_hits.items():
            exec_mod.counter_add(f"stream.deadline_hits.{name}", hits)
        for name, n in stats.failovers.items():
            exec_mod.counter_add(f"stream.failovers.{name}", n)

        if errors:
            raise errors[min(errors)]
        return [results[i] for i in range(len(items))], stats
