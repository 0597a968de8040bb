"""The port's fault tolerance on the CPU: retry ladder determinism, deadline
watchdog, poison-stripe quarantine with the lossless verbatim fallback,
chaos-harness invariants and the streaming ``.partial`` fuzz contract — the
cases of ``test_chaos.py`` run against ``repro_torch`` — and parity with the
JAX package: chaos decisions, backoff delays, retry timelines, quarantine
sets and archive fuzzing are pure functions of their seeds in both.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
import zlib

import jax
import numpy as np
import pytest

from repro.core import CompressorConfig as JConfig
from repro.core import HierarchicalCompressor as JCompressor
from repro.core import bae as j_bae
from repro.core import hbae as j_hbae
from repro.core.errors import TransientStageError as JTransient
from repro.core.options import CompressOptions as JOptions
from repro.runtime import chaosinject as j_chaos
from repro.runtime import faultinject as j_fault
from repro.stream import FaultTolerance as JFaultTolerance
from repro.stream import RetryPolicy as JRetryPolicy
from repro.stream import stream_compress as j_stream_compress
from repro_torch.core import exec as exec_mod
from repro_torch.core.errors import (ArchiveError, GuaranteeUnsatisfiable,
                                     MalformedStream, StageDeadlineExceeded,
                                     TransientStageError)
from repro_torch.core.options import CompressOptions
from repro_torch.core.pipeline import CompressorConfig, HierarchicalCompressor
from repro_torch.core.pipeline import params_from_jax
from repro_torch.runtime import archive_io, chaosinject, faultinject
from repro_torch.runtime.chaosinject import (ChaosInjector,
                                             ChaosPermanentFault, ChaosSpec,
                                             run_chaos_check)
from repro_torch.stream import (FaultTolerance, RetryPolicy, StageGraph,
                                StageSpec, StreamScheduler, stream_compress)

TAU = 0.5
CFG = dict(block_elems=40, k=2, emb=16, hidden=32, hb_latent=8, bae_hidden=32,
           bae_latent=4, gae_block_elems=80, hb_bin=0.01, bae_bin=0.01,
           gae_bin=0.02)
OPTS = CompressOptions(tau=TAU, chunk_hyperblocks=7)
J_OPTS = JOptions(tau=TAU, chunk_hyperblocks=7)


@pytest.fixture(scope="module")
def pair():
    """(JAX compressor, port compressor on the CPU, hyper-blocks) holding the
    same weights and PCA basis."""
    jc = JCompressor(JConfig(**CFG))
    khb, kb = jax.random.split(jax.random.PRNGKey(0))
    jc.hbae_params = j_hbae.hbae_init(khb, in_dim=40, k=2, emb=16, hidden=32,
                                      latent=8, heads=1)
    jc.bae_params = [j_bae.bae_init(kb, in_dim=40, hidden=32, latent=4)]
    rng = np.random.default_rng(0)
    hb = rng.standard_normal((24, 2, 40)).astype(np.float32)
    hb *= 0.1
    jc.fit_basis(hb)
    tc = HierarchicalCompressor(CompressorConfig(**CFG), device="cpu")
    tc.hbae_params, tc.bae_params = params_from_jax(
        jax.device_get(jc.hbae_params), jax.device_get(jc.bae_params),
        device="cpu")
    tc.basis = np.array(jc.basis)
    return jc, tc, hb


@pytest.fixture(scope="module")
def comp_hb(pair):
    _, tc, hb = pair
    return tc, hb


def _poison_at(monkeypatch, hb_start, exc):
    real = HierarchicalCompressor.encode_stripe_host

    def poison(self, start, *args, **kwargs):
        if start == hb_start:
            raise exc
        return real(self, start, *args, **kwargs)
    monkeypatch.setattr(HierarchicalCompressor, "encode_stripe_host", poison)


# ---------------------------------------------------------------------------
# retry policy & scheduler-level ladder
# ---------------------------------------------------------------------------

def test_retry_policy_delay_is_deterministic_and_bounded():
    p = RetryPolicy(max_retries=5, base_backoff_s=0.01, max_backoff_s=0.1,
                    jitter=0.25, seed=3)
    d1 = [p.delay("enc", 7, a) for a in range(6)]
    d2 = [p.delay("enc", 7, a) for a in range(6)]
    assert d1 == d2
    assert d1 != [p.delay("enc", 8, a) for a in range(6)]
    for a, d in enumerate(d1):
        base = min(0.1, 0.01 * 2 ** a)
        assert base <= d <= base * 1.25
    assert RetryPolicy(seed=3).delay("enc", 7, 0) != \
        RetryPolicy(seed=4).delay("enc", 7, 0)


def test_scheduler_retries_transient_then_succeeds():
    calls = {}
    lock = threading.Lock()

    def flaky(i, x):
        with lock:
            calls[i] = calls.get(i, 0) + 1
        if i == 2 and calls[i] < 3:
            raise TransientStageError("flaky")
        return x * 10

    policy = RetryPolicy(max_retries=3, base_backoff_s=0.001,
                         max_backoff_s=0.005, seed=1)
    graph = StageGraph([StageSpec("flaky", flaky, workers=2, queue_depth=2,
                                  retry=policy)])
    results, stats = StreamScheduler(graph).run(list(range(5)))
    assert results == [x * 10 for x in range(5)]
    assert stats.retries == {"flaky": 2}
    assert [(e[0], e[1], e[2]) for e in stats.retry_events] == \
        [("flaky", 2, 0), ("flaky", 2, 1)]
    assert stats.retry_events[0][3] == round(policy.delay("flaky", 2, 0), 9)


def test_scheduler_retry_timeline_is_reproducible():
    def flaky(i, x):
        raise TransientStageError("always")

    timelines = []
    for _ in range(2):
        graph = StageGraph([StageSpec(
            "f", flaky, workers=3, queue_depth=2,
            retry=RetryPolicy(max_retries=2, base_backoff_s=0.001,
                              max_backoff_s=0.004, seed=9),
            fallback=lambda i, payload, exc: -1)])
        results, stats = StreamScheduler(graph).run(list(range(6)))
        assert results == [-1] * 6
        assert stats.failovers == {"f": 6}
        timelines.append(list(stats.retry_events))
    assert timelines[0] == timelines[1]


def test_scheduler_permanent_error_skips_retries():
    attempts = {"n": 0}

    def perm(i, x):
        attempts["n"] += 1
        if i == 1:
            raise ValueError("permanent")
        return x

    graph = StageGraph([StageSpec("perm", perm, queue_depth=2,
                                  retry=RetryPolicy(max_retries=3))])
    with pytest.raises(ValueError, match="permanent"):
        StreamScheduler(graph).run([0, 1, 2])
    assert attempts["n"] == 3


def test_scheduler_custom_retryable_classifier():
    calls = {"n": 0}

    def fn(i, x):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("disk hiccup")
        return x

    policy = RetryPolicy(max_retries=2, base_backoff_s=0.001,
                         retryable=lambda e: isinstance(e, OSError))
    graph = StageGraph([StageSpec("io", fn, retry=policy)])
    results, stats = StreamScheduler(graph).run([5])
    assert results == [5] and stats.total_retries() == 1


def test_deadline_abandons_hung_attempt_without_deadlock():
    hung = threading.Event()

    def hang_once(i, x):
        if i == 1 and not hung.is_set():
            hung.set()
            time.sleep(5.0)                      # way past the deadline
        return x + 100

    graph = StageGraph([StageSpec(
        "hang", hang_once, workers=2, queue_depth=2, deadline_s=0.05,
        retry=RetryPolicy(max_retries=2, base_backoff_s=0.001,
                          max_backoff_s=0.002))])
    t0 = time.perf_counter()
    results, stats = StreamScheduler(graph).run(list(range(4)))
    assert time.perf_counter() - t0 < 4.0
    assert results == [x + 100 for x in range(4)]
    assert stats.deadline_hits == {"hang": 1}
    assert stats.total_retries() == 1


def test_deadline_exhaustion_surfaces_typed_error():
    def always_hang(i, x):
        time.sleep(5.0)

    graph = StageGraph([StageSpec("h", always_hang, deadline_s=0.02,
                                  retry=RetryPolicy(
                                      max_retries=1, base_backoff_s=0.001,
                                      max_backoff_s=0.002))])
    with pytest.raises(StageDeadlineExceeded) as ei:
        StreamScheduler(graph).run([0])
    assert ei.value.stage == "h" and ei.value.deadline_s == 0.02


def test_scheduler_shutdown_with_inflight_retries_raises_lowest_index():
    def bad(i, x):
        if i in (1, 3):
            raise TransientStageError(f"bad-{i}")
        return x

    graph = StageGraph([StageSpec(
        "bad", bad, workers=3, queue_depth=2,
        retry=RetryPolicy(max_retries=2, base_backoff_s=0.001,
                          max_backoff_s=0.002))])
    with pytest.raises(TransientStageError, match="bad-1"):
        StreamScheduler(graph).run(list(range(5)))
    assert not [t for t in threading.enumerate()
                if t.name.startswith("stream-bad")]


def test_failing_fallback_records_error():
    def boom(i, x):
        raise ValueError("boom")

    def bad_fallback(i, payload, exc):
        raise RuntimeError("fallback also died")

    graph = StageGraph([StageSpec("b", boom, fallback=bad_fallback)])
    with pytest.raises(RuntimeError, match="fallback also died"):
        StreamScheduler(graph).run([0])


# ---------------------------------------------------------------------------
# verbatim fallback chunks
# ---------------------------------------------------------------------------

def test_verbatim_chunk_roundtrip_and_flags(comp_hb):
    comp, hb = comp_hb
    chunk = comp.encode_stripe_verbatim(7, hb[7:14])
    assert chunk.verbatim_blob and chunk.hb_stream is None
    blob = archive_io.pack_chunk_section(chunk)
    assert len(blob) == archive_io.chunk_section_size(chunk)
    back = archive_io.unpack_chunk_section(blob)
    assert back.verbatim_blob == chunk.verbatim_blob
    assert (back.hb_start, back.n_hyperblocks) == (7, 7)
    assert np.array_equal(comp.decode_stripe_verbatim(back), hb[7:14])


def test_verbatim_chunk_malformed_payload_is_typed(comp_hb):
    comp, hb = comp_hb
    chunk = comp.encode_stripe_verbatim(0, hb[:7])
    blob = archive_io.pack_chunk_section(chunk)
    with pytest.raises(ArchiveError):
        archive_io.unpack_chunk_section(blob[:-3])
    short = dataclasses.replace(chunk,
                                verbatim_blob=zlib.compress(b"\x00" * 12))
    with pytest.raises(MalformedStream, match="verbatim"):
        comp.decode_stripe_verbatim(short)


def test_quarantine_on_permanent_encode_failure(comp_hb, tmp_path,
                                                monkeypatch):
    comp, hb = comp_hb
    out = str(tmp_path / "quarantine.rba")
    batch = comp.compress(hb, options=OPTS)
    _poison_at(monkeypatch, 14, RuntimeError("poison stripe"))
    ft = FaultTolerance(retry=RetryPolicy(max_retries=1,
                                          base_backoff_s=0.001,
                                          max_backoff_s=0.002))
    result = stream_compress(comp, hb, out_path=out, options=OPTS,
                             fault_tolerance=ft)
    monkeypatch.undo()
    assert result.quarantined == [2]
    assert "poison stripe" in result.quarantine_reasons[2]
    assert result.stats.quarantined == [2]
    assert result.stats.failovers.get("host_encode") == 1
    assert result.stats.total_retries() == 0

    disk = archive_io.read_archive(out, strict=True)
    for i, chunk in enumerate(disk.chunks):
        if i == 2:
            assert chunk.verbatim_blob
            assert np.array_equal(comp.decode_stripe_verbatim(chunk),
                                  hb[14:21])
        else:
            assert archive_io.pack_chunk_section(chunk) == \
                archive_io.pack_chunk_section(batch.chunks[i])
    assert disk.verbatim_chunks() == [2]
    recon = comp.decompress(disk)
    errs = np.linalg.norm((hb - recon).reshape(-1, 80), axis=1)
    assert float(errs.max()) <= TAU * (1 + 1e-5)
    assert np.array_equal(recon[14:21], hb[14:21])


def test_quarantine_on_guarantee_unsatisfiable(comp_hb, monkeypatch):
    comp, hb = comp_hb
    _poison_at(monkeypatch, 0, GuaranteeUnsatisfiable(
        block=0, err=1.0, tau=TAU, max_refine=20))
    result = stream_compress(
        comp, hb, options=OPTS,
        fault_tolerance=FaultTolerance(retry=RetryPolicy(
            max_retries=2, base_backoff_s=0.001, max_backoff_s=0.002)))
    monkeypatch.undo()
    assert result.quarantined == [0]
    assert result.stats.total_retries() == 0
    recon = comp.decompress(result.archive)
    assert np.array_equal(recon[0:7], hb[0:7])


def test_no_fault_tolerance_keeps_fail_fast_semantics(comp_hb, tmp_path,
                                                      monkeypatch):
    comp, hb = comp_hb
    out = str(tmp_path / "failfast.rba")
    _poison_at(monkeypatch, 14, RuntimeError("hard crash"))
    with pytest.raises(RuntimeError, match="hard crash"):
        stream_compress(comp, hb, out_path=out, options=OPTS)
    monkeypatch.undo()
    assert not os.path.exists(out)
    assert os.path.exists(out + ".partial")


# ---------------------------------------------------------------------------
# live chaos: injector + harness invariants
# ---------------------------------------------------------------------------

def test_chaos_injector_decisions_are_seeded():
    spec = ChaosSpec(seed=5, transient_rate=0.4, permanent_rate=0.1)
    a, b = ChaosInjector(spec), ChaosInjector(spec)
    for inj in (a, b):
        for item in range(12):
            for attempt in range(3):
                try:
                    inj.before("host_encode", item, attempt)
                except (TransientStageError, ChaosPermanentFault):
                    pass
    assert a.injected == b.injected
    assert a.injected["transient"] > 0
    inj = ChaosInjector(spec)
    for item in range(12):
        hits = []
        for attempt in range(3):
            try:
                inj.before("host_encode", item, attempt)
                hits.append(False)
            except ChaosPermanentFault:
                hits.append(True)
            except TransientStageError:
                hits.append(False)
        assert all(hits) or not any(hits), \
            f"permanent fault flickered across attempts for item {item}"


def test_stream_compress_under_transient_chaos_is_deterministic(comp_hb,
                                                                tmp_path):
    comp, hb = comp_hb
    spec = ChaosSpec(seed=11, transient_rate=0.35)
    ft = FaultTolerance(retry=RetryPolicy(max_retries=4,
                                          base_backoff_s=0.002,
                                          max_backoff_s=0.01, seed=11))
    runs = []
    for r in range(2):
        out = str(tmp_path / f"chaos{r}.rba")
        result = stream_compress(comp, hb, out_path=out, options=OPTS,
                                 fault_tolerance=ft,
                                 chaos=ChaosInjector(spec))
        runs.append((tuple(result.stats.retry_events),
                     tuple(result.quarantined)))
        assert result.quarantined == []
    assert runs[0] == runs[1]
    assert runs[0][0]
    batch = comp.compress(hb, options=OPTS)
    with open(str(tmp_path / "chaos0.rba"), "rb") as f:
        assert f.read() == archive_io.serialize_archive(batch)


def test_run_chaos_check_invariant_harness(comp_hb, tmp_path):
    comp, hb = comp_hb
    report = run_chaos_check(
        comp, hb, TAU,
        ChaosSpec(seed=3, transient_rate=0.25, permanent_rate=0.2),
        str(tmp_path / "harness.rba"), scenario="test", budget_s=60.0)
    assert report.ok, report.summary()
    assert report.quarantined > 0
    assert "OK" in report.summary()


# ---------------------------------------------------------------------------
# codec pool resilience & partial fuzz
# ---------------------------------------------------------------------------

def test_pool_submit_recovers_from_reset():
    exec_mod.reset_pool()
    assert exec_mod.pool_submit(lambda x: x + 1, 41).result() == 42
    exec_mod.reset_pool()
    assert exec_mod.pool_submit(lambda x: x * 2, 21).result() == 42


def test_partial_fuzz_containment(comp_hb, tmp_path, monkeypatch):
    comp, hb = comp_hb
    out = str(tmp_path / "fuzzme.rba")
    _poison_at(monkeypatch, 14, RuntimeError("crash"))
    with pytest.raises(RuntimeError):
        stream_compress(comp, hb, out_path=out, options=OPTS)
    monkeypatch.undo()
    with open(out + ".partial", "rb") as f:
        partial = f.read()
    result = faultinject.check_partial_containment(
        partial, trials=24, seed=1,
        decode=lambda a: comp.decompress(a, strict=False))
    assert result.ok, result.summary()
    assert result.trials[0].kind == "as_left_on_disk"
    assert result.trials[0].outcome == "survived"


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_chaos_cli_on_the_cpu(capsys):
    assert chaosinject.main(["--seed", "0", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for scenario in ("transient-storm", "poison-stripes", "stage-hangs"):
        assert f"[OK] {scenario}:" in out
    assert "OK: all chaos scenarios" in out


def test_faultinject_cli_exit_codes(comp_hb, tmp_path, capsys):
    comp, hb = comp_hb
    good = str(tmp_path / "good.rba")
    archive_io.write_archive(comp.compress(hb, options=OPTS), good)
    assert faultinject.main([good, "--trials", "8", "--seed", "0"]) == 0
    assert "OK: every corruption detected or survived" in \
        capsys.readouterr().out
    with open(str(tmp_path / "junk.rba"), "wb") as f:
        f.write(b"not a container")
    assert faultinject.main([str(tmp_path / "junk.rba")]) == 2


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def _decisions(injector_cls, spec, transient, permanent):
    inj = injector_cls(spec)
    out = []
    for stage in ("dispatch", "transfer", "host_encode", "sink"):
        for item in range(16):
            for attempt in range(4):
                try:
                    inj.before(stage, item, attempt)
                    out.append("ok")
                except permanent:
                    out.append("permanent")
                except transient:
                    out.append("transient")
    return out, dict(inj.injected)


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_chaos_decisions_equal_jax(seed):
    spec = dict(seed=seed, transient_rate=0.3, permanent_rate=0.1)
    port = _decisions(ChaosInjector, ChaosSpec(**spec), TransientStageError,
                      ChaosPermanentFault)
    ref = _decisions(j_chaos.ChaosInjector, j_chaos.ChaosSpec(**spec),
                     JTransient, j_chaos.ChaosPermanentFault)
    assert port == ref
    assert port[1]["transient"] > 0 and port[1]["permanent"] > 0


def test_retry_policy_delays_equal_jax():
    for seed in (0, 3, 9):
        p = RetryPolicy(max_retries=5, base_backoff_s=0.01,
                        max_backoff_s=0.1, seed=seed)
        j = JRetryPolicy(max_retries=5, base_backoff_s=0.01,
                         max_backoff_s=0.1, seed=seed)
        for stage in ("dispatch", "host_encode", "sink"):
            for item in range(8):
                for attempt in range(6):
                    assert p.delay(stage, item, attempt) == \
                        j.delay(stage, item, attempt)


def test_chaos_retry_timeline_and_quarantine_equal_jax(pair, tmp_path):
    jc, tc, hb = pair
    spec = dict(seed=3, transient_rate=0.25, permanent_rate=0.2)
    retry = dict(max_retries=3, base_backoff_s=0.001, max_backoff_s=0.004,
                 seed=3)
    j = j_stream_compress(
        jc, hb, out_path=str(tmp_path / "j.rba"), options=J_OPTS,
        fault_tolerance=JFaultTolerance(retry=JRetryPolicy(**retry)),
        chaos=j_chaos.ChaosInjector(j_chaos.ChaosSpec(**spec)))
    t = stream_compress(
        tc, hb, out_path=str(tmp_path / "t.rba"), options=OPTS,
        fault_tolerance=FaultTolerance(retry=RetryPolicy(**retry)),
        chaos=ChaosInjector(ChaosSpec(**spec)))
    assert t.stats.retry_events == j.stats.retry_events
    assert t.quarantined == j.quarantined and t.quarantined
    assert t.chaos_injected == j.chaos_injected
    assert t.stats.failovers == j.stats.failovers
    with open(str(tmp_path / "j.rba"), "rb") as f:
        j_blob = f.read()
    with open(str(tmp_path / "t.rba"), "rb") as f:
        assert f.read() == j_blob


def test_options_derived_chaos_equals_jax(pair):
    """``CompressOptions(retries=..., chaos_seed=...)`` arms the same ladder
    and injector in both packages."""
    jc, tc, hb = pair
    j = j_stream_compress(jc, hb, options=JOptions(
        tau=TAU, chunk_hyperblocks=7, retries=2, chaos_seed=4))
    t = stream_compress(tc, hb, options=CompressOptions(
        tau=TAU, chunk_hyperblocks=7, retries=2, chaos_seed=4))
    assert t.stats.retry_events == j.stats.retry_events
    assert t.quarantined == j.quarantined
    assert t.chaos_injected == j.chaos_injected


def test_corrupt_bytes_equal_jax(pair):
    _, tc, hb = pair
    blob = archive_io.serialize_archive(tc.compress(hb, options=OPTS))
    for t in range(16):
        kind = faultinject.CORRUPTION_KINDS[t % 4]
        assert faultinject.corrupt(blob, kind, np.random.default_rng(t)) == \
            j_fault.corrupt(blob, kind, np.random.default_rng(t))


def test_containment_classifies_like_jax(pair, tmp_path, monkeypatch):
    jc, tc, hb = pair
    blob = archive_io.serialize_archive(tc.compress(hb, options=OPTS))
    port = faultinject.check_containment(blob, trials=24, seed=2)
    ref = j_fault.check_containment(blob, trials=24, seed=2)
    assert port.ok and ref.ok
    assert [dataclasses.astuple(t) for t in port.trials] == \
        [dataclasses.astuple(t) for t in ref.trials]

    out = str(tmp_path / "p.rba")
    _poison_at(monkeypatch, 14, RuntimeError("crash"))
    with pytest.raises(RuntimeError):
        stream_compress(tc, hb, out_path=out, options=OPTS)
    monkeypatch.undo()
    with open(out + ".partial", "rb") as f:
        partial = f.read()
    port = faultinject.check_partial_containment(partial, trials=24, seed=1)
    ref = j_fault.check_partial_containment(partial, trials=24, seed=1)
    assert port.ok
    assert [dataclasses.astuple(t) for t in port.trials] == \
        [dataclasses.astuple(t) for t in ref.trials]
