"""Live chaos injection for the streaming compression pipeline.

``faultinject`` fuzzes archives at rest; this module attacks the pipeline
WHILE IT RUNS: a seeded ``ChaosInjector`` hooks into ``StreamScheduler``
(``chaos=`` argument; ``stream_compress(chaos=...)``) and, per
(stage, item, attempt), may inject

* a **transient fault**  — raises ``TransientStageError``; the retry ladder
  must absorb it (decision re-rolled per attempt, so retries can succeed),
* a **permanent fault**  — raises ``ChaosPermanentFault`` on EVERY attempt
  of that (stage, item); the quarantine ladder must convert the stripe into
  a lossless verbatim fallback chunk,
* a **hang**             — sleeps past the stage deadline; the watchdog must
  abandon the attempt instead of deadlocking the bounded queues.

All decisions are pure functions of ``(seed, stage, item, attempt)`` via
crc32 — independent of thread scheduling and of Python's per-process hash
seed — which is what makes a chaos run reproducible: same seed, same fault
schedule, same retry timeline, same quarantine set.

``run_chaos_check`` is the invariant harness the CLI runs: it streams
a dataset under injected chaos (twice) and asserts

1. **no deadlock** — the run finishes within a generous wall-clock budget;
2. **determinism** — both runs produce identical retry timelines and
   quarantine sets;
3. **guaranteed bound** — every chunk in the finalized container is either
   byte-identical to the batch path's chunk or a flagged verbatim fallback
   that decodes losslessly (error 0 <= tau);
4. **salvageable failure** — if the run does abort, ``<out>.partial`` is
   still tolerantly readable.

CLI (on the card by default; ``--device cpu`` for the plain versions)::

    python -m repro_torch.runtime.chaosinject --seed 0
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import threading
import time
import zlib
from typing import Optional

import numpy as np

from repro_torch.core.errors import TransientStageError

CHAOS_STAGES = ("dispatch", "transfer", "host_encode")


class ChaosPermanentFault(RuntimeError):
    """An injected fault that no retry can clear (poison stripe)."""


def _unit(seed: int, *parts) -> float:
    """Deterministic uniform in [0, 1) from (seed, parts); crc32 plus a
    murmur-style finalizer (bare crc32 correlates across adjacent items)."""
    h = zlib.crc32(f"{seed}|".encode()
                   + "|".join(map(str, parts)).encode())
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & 0xFFFFFFFF
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & 0xFFFFFFFF
    return (h ^ (h >> 16)) / 2.0 ** 32


@dataclasses.dataclass
class ChaosSpec:
    """Seeded fault schedule.  Rates are per (stage, item) for permanent
    faults and per (stage, item, attempt) for transient faults and hangs,
    applied only to ``stages``."""
    seed: int = 0
    transient_rate: float = 0.0
    permanent_rate: float = 0.0
    hang_rate: float = 0.0
    hang_s: float = 0.5
    stages: tuple = CHAOS_STAGES


class ChaosInjector:
    """``StreamScheduler`` hook: consult ``before(stage, item, attempt)``
    ahead of every attempt.  Thread-safe; keeps injection counts."""

    def __init__(self, spec: ChaosSpec):
        self.spec = spec
        self._lock = threading.Lock()
        self.injected: dict[str, int] = {"transient": 0, "permanent": 0,
                                         "hang": 0}

    def _count(self, kind: str) -> None:
        with self._lock:
            self.injected[kind] += 1

    def before(self, stage: str, item: int, attempt: int) -> None:
        spec = self.spec
        if stage not in spec.stages:
            return
        if _unit(spec.seed, "perm", stage, item) < spec.permanent_rate:
            self._count("permanent")
            raise ChaosPermanentFault(
                f"chaos: permanent fault at {stage}[{item}]")
        if _unit(spec.seed, "hang", stage, item, attempt) < spec.hang_rate:
            self._count("hang")
            time.sleep(spec.hang_s)
            return
        if _unit(spec.seed, "trans", stage, item, attempt) \
                < spec.transient_rate:
            self._count("transient")
            raise TransientStageError(
                f"chaos: transient fault at {stage}[{item}] "
                f"attempt {attempt}")


# ---------------------------------------------------------------------------
# invariant harness
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ChaosReport:
    scenario: str
    violations: list
    retries: int = 0
    deadline_hits: int = 0
    quarantined: int = 0
    wall_s: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.violations

    def summary(self) -> str:
        state = "OK" if self.ok else "FAIL"
        lines = [f"[{state}] {self.scenario}: {self.retries} retries, "
                 f"{self.deadline_hits} deadline hits, "
                 f"{self.quarantined} quarantined, {self.wall_s:.2f}s"]
        lines += [f"  VIOLATION: {v}" for v in self.violations]
        return "\n".join(lines)


def _run_with_watchdog(fn, budget_s: float):
    """Run ``fn`` on a thread with a wall-clock budget; returns
    ``(finished, result_or_exc)``.  A blown budget IS the deadlock signal —
    the stuck thread is daemonic and abandoned."""
    box: dict = {}
    done = threading.Event()

    def call():
        try:
            box["result"] = fn()
        except BaseException as e:   # retry-boundary: unpacked by caller
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=call, daemon=True, name="chaos-watchdog")
    t.start()
    if not done.wait(budget_s):
        return False, None
    if "error" in box:
        return True, box["error"]
    return True, box["result"]


def run_chaos_check(comp, hyperblocks, tau: float, spec: ChaosSpec,
                    out_path: str, *, scenario: str = "chaos",
                    chunk_hyperblocks: int = 7,
                    deadline_s: Optional[float] = None,
                    budget_s: float = 120.0) -> ChaosReport:
    """Stream ``hyperblocks`` under injected chaos and assert the
    fault-tolerance invariants.  Returns a ``ChaosReport``; every broken
    invariant is a ``violations`` entry (empty == pass)."""
    import os

    from repro_torch.core.options import CompressOptions
    from repro_torch.runtime import archive_io
    from repro_torch.stream import FaultTolerance, RetryPolicy, \
        stream_compress

    report = ChaosReport(scenario=scenario, violations=[])
    opts = CompressOptions(tau=tau, chunk_hyperblocks=chunk_hyperblocks)
    batch = comp.compress(hyperblocks, options=opts)
    batch_sections = [archive_io.pack_chunk_section(c) for c in batch.chunks]

    # explicit FaultTolerance/ChaosInjector objects (custom backoff + spec
    # rates) override the CompressOptions-derived defaults
    ft = FaultTolerance(
        retry=RetryPolicy(max_retries=3, base_backoff_s=0.005,
                          max_backoff_s=0.05, seed=spec.seed),
        deadline_s=deadline_s, quarantine=True)

    outcomes = []
    t0 = time.perf_counter()
    for run_i in range(2):                      # two runs: determinism check
        path = f"{out_path}.run{run_i}"
        chaos = ChaosInjector(spec)
        finished, result = _run_with_watchdog(
            lambda: stream_compress(
                comp, hyperblocks, options=opts, out_path=path,
                fault_tolerance=ft, chaos=chaos),
            budget_s)
        if not finished:
            report.violations.append(
                f"run {run_i}: DEADLOCK — no result within {budget_s}s")
            report.wall_s = time.perf_counter() - t0
            return report
        if isinstance(result, BaseException):
            # an aborted run is legal only if it left a salvageable partial
            if os.path.exists(path):
                report.violations.append(
                    f"run {run_i}: raised {result!r} but finalized {path}")
            try:
                with open(path + ".partial", "rb") as f:
                    archive_io.deserialize_archive(f.read(), strict=False)
            except Exception as e:   # retry-boundary: any failure is a viol.
                report.violations.append(
                    f"run {run_i}: aborted ({result!r}) without a "
                    f"salvageable partial: {e!r}")
            outcomes.append(("aborted", repr(result)))
            continue
        outcomes.append(("finalized", tuple(result.stats.retry_events),
                         tuple(result.quarantined)))
        report.retries = result.stats.total_retries()
        report.deadline_hits = sum(result.stats.deadline_hits.values())
        report.quarantined = len(result.quarantined)

        # finalized container: strict-readable, every chunk either
        # byte-identical to batch or a lossless verbatim fallback
        try:
            disk = archive_io.read_archive(path, strict=True)
        except Exception as e:   # retry-boundary: any failure is a violation
            report.violations.append(
                f"run {run_i}: finalized container unreadable: {e!r}")
            continue
        for ci, chunk in enumerate(disk.chunks):
            sec = archive_io.pack_chunk_section(chunk)
            if ci in result.quarantined:
                if not chunk.verbatim_blob:
                    report.violations.append(
                        f"run {run_i}: chunk {ci} quarantined but not "
                        f"flagged verbatim on disk")
                    continue
                start, n_hb = chunk.hb_start, chunk.n_hyperblocks
                decoded = comp.decode_stripe_verbatim(chunk)
                if not np.array_equal(
                        decoded, hyperblocks[start:start + n_hb]):
                    report.violations.append(
                        f"run {run_i}: verbatim chunk {ci} is not lossless")
            elif sec != batch_sections[ci]:
                report.violations.append(
                    f"run {run_i}: chunk {ci} differs from batch encoding "
                    f"without being quarantined")
        # end-to-end: the decoded field honors tau everywhere
        recon = comp.decompress(disk)
        d_gae = comp.cfg.gae_block_elems or comp.cfg.block_elems
        errs = np.linalg.norm(
            (hyperblocks - recon).reshape(-1, d_gae), axis=1)
        if float(errs.max()) > tau * (1 + 1e-5):
            report.violations.append(
                f"run {run_i}: tau guarantee violated after chaos "
                f"(max l2 {errs.max():.6g} > {tau})")
    report.wall_s = time.perf_counter() - t0
    # abandoned watchdog attempts may still be inside native (torch) code;
    # let them land before interpreter teardown
    for t in threading.enumerate():
        if t.daemon and t is not threading.current_thread() \
                and t.name.startswith(("stream-", "chaos-")):
            t.join(timeout=10.0)
    if len(outcomes) == 2 and outcomes[0] != outcomes[1]:
        report.violations.append(
            f"nondeterministic outcome for seed {spec.seed}: "
            f"{outcomes[0]!r} != {outcomes[1]!r}")
    return report


def _make_test_compressor(seed: int = 0, device=None):
    """A small fitted-enough compressor (seeded random init + fitted PCA
    basis — no training) plus a matching dataset, on ``device`` (default
    the card); the configuration and data of the JAX package's harness, so
    the CLI gate runs in seconds."""
    from repro_torch.core.pipeline import CompressorConfig, \
        HierarchicalCompressor

    cfg = CompressorConfig(block_elems=40, k=2, emb=16, hidden=32,
                           hb_latent=8, bae_hidden=32, bae_latent=4,
                           gae_block_elems=80, hb_bin=0.01, bae_bin=0.01,
                           gae_bin=0.02)
    comp = HierarchicalCompressor(cfg, device=device).init_params(seed)
    rng = np.random.default_rng(seed)
    hb = rng.standard_normal((28, cfg.k, cfg.block_elems)).astype(np.float32)
    hb *= 0.1
    comp.fit_basis(hb)
    return comp, hb


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        description="live chaos gate: stream-compress under injected "
                    "faults and assert the fault-tolerance invariants")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tau", type=float, default=0.5)
    ap.add_argument("--out", default="", help="scratch path for containers "
                    "(default: a temp dir)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    try:
        comp, hb = _make_test_compressor(args.seed, device=args.device)
    except RuntimeError as e:
        ap.error(str(e))
    if args.out:
        return _run_scenarios(comp, hb, args.seed, args.tau, args.out)
    import os
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chaos_") as tmp:
        return _run_scenarios(comp, hb, args.seed, args.tau,
                              os.path.join(tmp, "chaos.rba"))


def _run_scenarios(comp, hb, seed: int, tau: float, out: str) -> int:
    """The CLI's three scenarios; 0 when every invariant held."""
    scenarios = [
        ("transient-storm", ChaosSpec(seed=seed, transient_rate=0.35),
         None),
        ("poison-stripes", ChaosSpec(seed=seed, transient_rate=0.1,
                                     permanent_rate=0.25), None),
        ("stage-hangs", ChaosSpec(seed=seed, hang_rate=0.3,
                                  hang_s=0.6), 0.15),
    ]
    failures = 0
    for name, spec, deadline in scenarios:
        report = run_chaos_check(
            comp, hb, tau, spec, f"{out}.{name}", scenario=name,
            deadline_s=deadline)
        print(report.summary())
        if name == "transient-storm" and report.quarantined:
            print(f"  VIOLATION: transient-only chaos quarantined "
                  f"{report.quarantined} chunks (retries should absorb)")
            failures += 1
        if not report.ok:
            failures += 1
    if failures:
        print(f"FAIL: {failures} chaos scenario(s) violated invariants",
              file=sys.stderr)
        return 1
    print("OK: all chaos scenarios honored the fault-tolerance invariants")
    return 0


if __name__ == "__main__":
    sys.exit(main())
