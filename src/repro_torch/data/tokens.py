"""Deterministic, shardable, resumable-by-step LM token pipeline (a copy of
the JAX package's ``data/tokens.py``: pure numpy, so its batches equal the
JAX package's byte for byte).

Requirements from the fault-tolerance story (DESIGN.md §7): after a crash the
runner restores step N and must see the EXACT batch stream it would have seen
without the crash — so batches are a pure function of (step, shard).  No
iterator state is ever checkpointed; ``batch_at(step)`` is the contract.

The corpus here is a synthetic-but-structured Zipfian n-gram stream (no real
corpus ships with the repository); real deployments swap ``SyntheticCorpus`` for a
tokenized shard reader behind the same ``batch_at`` interface.  Host prefetch
(depth >= 2) decouples host hiccups from the device stream.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    shard_index: int = 0          # this host's data shard
    shard_count: int = 1
    seed: int = 1234


class SyntheticCorpus:
    """Zipfian unigram mixture with a deterministic per-position bigram kick —
    enough structure that a ~100M model's loss visibly drops, fully
    reproducible from (seed, step, shard)."""

    def __init__(self, cfg: TokenPipelineConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        self._probs = p / p.sum()
        # deterministic bigram successor table: v -> (a*v + b) % vocab
        rng = np.random.default_rng(cfg.seed)
        self._a = int(rng.integers(1, cfg.vocab - 1) | 1)
        self._b = int(rng.integers(0, cfg.vocab))

    def batch_at(self, step: int) -> dict:
        """Pure function of (step, shard): {'tokens','labels'} int32 arrays of
        shape (local_batch, seq_len)."""
        cfg = self.cfg
        assert cfg.global_batch % cfg.shard_count == 0
        local = cfg.global_batch // cfg.shard_count
        ss = np.random.SeedSequence(
            entropy=cfg.seed, spawn_key=(step, cfg.shard_index))
        rng = np.random.default_rng(ss)
        base = rng.choice(cfg.vocab, size=(local, cfg.seq_len + 1),
                          p=self._probs).astype(np.int64)
        # bigram kick: with p=0.5 the next token is the deterministic successor
        follow = rng.random((local, cfg.seq_len)) < 0.5
        succ = (self._a * base[:, :-1] + self._b) % cfg.vocab
        seq = base.copy()
        seq[:, 1:] = np.where(follow, succ, base[:, 1:])
        return {"tokens": seq[:, :-1].astype(np.int32),
                "labels": seq[:, 1:].astype(np.int32)}


class PrefetchIterator:
    """Threaded prefetch (depth >= 2) over ``batch_at`` starting at ``step``.

    A worker-thread crash (corrupt shard, OOM in ``batch_at``) is re-raised
    from ``__next__`` on the consumer thread — an error sentinel rides the
    queue, so the consumer never blocks forever on a dead producer.
    ``close()`` joins the worker.
    """

    _ERR = object()      # queue sentinel: payload is the worker's exception

    def __init__(self, corpus: SyntheticCorpus, start_step: int,
                 depth: int = 2):
        self.corpus = corpus
        self.step = start_step
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        s = self.step
        try:
            while not self._stop.is_set():
                batch = self.corpus.batch_at(s)
                while not self._stop.is_set():
                    try:
                        self.q.put((s, batch), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                s += 1
        except BaseException as e:   # propagate to consumer via the queue
            self._exc = e
            while not self._stop.is_set():
                try:
                    self.q.put((self._ERR, e), timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        if self._exc is not None and self.q.empty():
            raise self._exc
        while True:
            if self._stop.is_set():
                raise StopIteration
            try:
                tag, batch = self.q.get(timeout=0.5)
            except queue.Empty:
                # producer dead without a queued sentinel (e.g. it crashed
                # while the queue was full and close() drained it)?
                if not self._thread.is_alive():
                    if self._exc is not None:
                        raise self._exc
                    raise StopIteration
                continue
            if tag is self._ERR:
                raise batch
            return batch

    def close(self) -> None:
        """Stop and JOIN the worker; safe to call twice."""
        self._stop.set()
        while True:     # unblock a producer stuck on a full queue
            try:
                self.q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)


def make_iterator(cfg: TokenPipelineConfig, start_step: int,
                  prefetch: int = 2) -> PrefetchIterator:
    return PrefetchIterator(SyntheticCorpus(cfg), start_step, depth=prefetch)
