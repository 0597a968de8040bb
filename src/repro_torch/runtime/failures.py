"""Failure handling & straggler posture for long-running jobs, in PyTorch
(the JAX package's ``runtime/failures.py``; the loop is the same, and the
step's loss is read with ``float``).

``ResilientRunner`` wraps a step function with the recovery loop a 1000-node
deployment needs:

  * **crash/device-loss recovery** — any exception from the step (including
    injected ``SimulatedDeviceFailure``) triggers: reload newest valid
    checkpoint, rebuild the data iterator at that exact step (the token
    pipeline is deterministic-by-step), resume; bounded retries.
  * **NaN / loss-spike anomalies** — pluggable policy: ``"skip"`` drops the
    batch and the step's new state and moves on (so the step must leave the
    state it was given untouched, as ``train.loop.make_train_step``'s step
    does), ``"restore"`` treats it like a crash and rolls back.
  * **preemption hook** — ``request_preemption()`` (wire it to SIGTERM in the
    launcher) checkpoints at the next step boundary and exits cleanly.
  * **straggler watchdog** — per-step wall-clock EMA; steps slower than
    ``watchdog_factor``x the EMA are counted and surfaced in stats (on real
    fleets this feeds the scheduler's replace-node signal; here it is the
    observable hook + test point).  Synchronous SPMD absorbs transient
    stragglers at the collective; the data pipeline keeps prefetch >= 2 so
    host hiccups don't stall the device stream.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Iterator, Optional

from repro_torch.runtime.checkpoint import CheckpointManager


class SimulatedDeviceFailure(RuntimeError):
    """Raised by tests / chaos hooks to emulate losing a worker."""


@dataclasses.dataclass
class RunnerStats:
    steps: int = 0
    restores: int = 0
    skipped_batches: int = 0
    slow_steps: int = 0
    last_loss: float = float("nan")
    step_time_ema: float = 0.0


class ResilientRunner:
    """step_fn(state, batch) -> (state, metrics dict with 'loss')."""

    def __init__(self, step_fn: Callable, ckpt: CheckpointManager,
                 make_data_iter: Callable[[int], Iterator],
                 *, save_every: int = 50, max_retries: int = 3,
                 anomaly_policy: str = "skip", loss_spike_factor: float = 10.0,
                 watchdog_factor: float = 3.0,
                 on_event: Optional[Callable[[str, dict], None]] = None):
        assert anomaly_policy in ("skip", "restore")
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.make_data_iter = make_data_iter
        self.save_every = save_every
        self.max_retries = max_retries
        self.anomaly_policy = anomaly_policy
        self.loss_spike_factor = loss_spike_factor
        self.watchdog_factor = watchdog_factor
        self.on_event = on_event or (lambda kind, info: None)
        self.stats = RunnerStats()
        self._preempted = False
        self._loss_ema: Optional[float] = None

    # -- hooks ------------------------------------------------------------
    def request_preemption(self) -> None:
        """Wire to SIGTERM: checkpoint at the next boundary and stop."""
        self._preempted = True

    # -- recovery ----------------------------------------------------------
    def _restore(self, fallback_state) -> tuple[int, Any]:
        try:
            step, state = self.ckpt.restore()
            self.stats.restores += 1
            self.on_event("restore", {"step": step})
            return step, state
        except FileNotFoundError:
            self.stats.restores += 1
            self.on_event("restore", {"step": 0, "cold": True})
            return 0, fallback_state

    def _anomalous(self, loss: float) -> bool:
        if not math.isfinite(loss):
            return True
        if self._loss_ema is None:
            return False
        return loss > self.loss_spike_factor * max(self._loss_ema, 1e-8)

    # -- main loop -----------------------------------------------------------
    def run(self, state: Any, start_step: int, num_steps: int) -> tuple[Any, int]:
        step = start_step
        data = self.make_data_iter(step)
        retries = 0
        end = start_step + num_steps
        while step < end and not self._preempted:
            t0 = time.monotonic()
            try:
                # next(data) INSIDE the recovery try: a crashing data
                # iterator (e.g. a prefetch worker death propagated by
                # PrefetchIterator) counts as a step failure and goes
                # through restore + iterator rebuild, not up the stack.
                batch = next(data)
                new_state, metrics = self.step_fn(state, batch)
                loss = float(metrics["loss"])
            except StopIteration:                        # exhausted, not failed
                raise
            except Exception as e:                       # crash / device loss
                retries += 1
                self.on_event("failure", {"step": step, "error": repr(e),
                                          "retry": retries})
                if retries > self.max_retries:
                    raise
                step, state = self._restore(state)
                data = self.make_data_iter(step)
                continue
            retries = 0

            if self._anomalous(loss):
                self.on_event("anomaly", {"step": step, "loss": loss})
                if self.anomaly_policy == "skip":
                    self.stats.skipped_batches += 1
                    step += 1                            # drop batch, keep state
                    continue
                step, state = self._restore(state)
                data = self.make_data_iter(step)
                continue

            dt = time.monotonic() - t0
            ema = self.stats.step_time_ema
            if ema > 0 and dt > self.watchdog_factor * ema:
                self.stats.slow_steps += 1
                self.on_event("straggler", {"step": step, "dt": dt, "ema": ema})
            self.stats.step_time_ema = dt if ema == 0 else 0.9 * ema + 0.1 * dt

            state = new_state
            self._loss_ema = (loss if self._loss_ema is None
                              else 0.9 * self._loss_ema + 0.1 * loss)
            self.stats.last_loss = loss
            self.stats.steps += 1
            step += 1
            if step % self.save_every == 0:
                self.ckpt.save(step, state)
        if self._preempted:
            self.ckpt.save(step, state, blocking=True)
            self.on_event("preempted", {"step": step})
        self.ckpt.wait()
        return state, step


def chaos_wrap(step_fn: Callable, fail_at_steps: set[int]) -> Callable:
    """Test helper: make step_fn raise SimulatedDeviceFailure at given steps
    (once each)."""
    remaining = set(fail_at_steps)
    counter = {"n": 0}

    def wrapped(state, batch):
        n = counter["n"]
        counter["n"] += 1
        if n in remaining:
            remaining.discard(n)
            raise SimulatedDeviceFailure(f"injected failure at call {n}")
        return step_fn(state, batch)

    return wrapped
