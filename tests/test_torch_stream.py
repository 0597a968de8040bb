"""The port's streaming subsystem on the CPU: scheduler semantics
(backpressure, ordering, deterministic errors), stream/batch byte identity,
the two-phase streaming archive writer and crash-mid-stream salvage — the
cases of ``test_compress_stream.py`` run against ``repro_torch`` — and
parity with the JAX package's ``stream_compress`` on the same inputs.

Both compressors hold the JAX package's seeded weights (carried across with
``params_from_jax``) and its fitted PCA basis, as ``test_torch_pipeline.py``
does, so their archives are comparable byte for byte.
"""
from __future__ import annotations

import os
import sys
import threading
import time

import jax
import numpy as np
import pytest

from repro.core import CompressorConfig as JConfig
from repro.core import HierarchicalCompressor as JCompressor
from repro.core import bae as j_bae
from repro.core import hbae as j_hbae
from repro.core.options import CompressOptions as JOptions
from repro.runtime import archive_io as j_io
from repro.stream import stream_compress as j_stream_compress
from repro_torch.core import exec as exec_mod
from repro_torch.core.errors import ChecksumMismatch, ConfigError
from repro_torch.core.options import CompressOptions
from repro_torch.core.pipeline import CompressorConfig, HierarchicalCompressor
from repro_torch.core.pipeline import params_from_jax
from repro_torch.runtime import archive_io, faultinject
from repro_torch.runtime.stream_writer import StreamingArchiveWriter, \
    WriterStateError
from repro_torch.stream import StageGraph, StageSpec, StreamScheduler, \
    stream_compress

TAU = 0.5
CFG = dict(block_elems=40, k=2, emb=16, hidden=32, hb_latent=8, bae_hidden=32,
           bae_latent=4, gae_block_elems=80, hb_bin=0.01, bae_bin=0.01,
           gae_bin=0.02)


def _opts(tau=TAU, chunk=7, **kw) -> CompressOptions:
    return CompressOptions(tau=tau, chunk_hyperblocks=chunk, **kw)


@pytest.fixture(scope="module")
def pair():
    """(JAX compressor, port compressor on the CPU, hyper-blocks): the JAX
    package's test fixture, and the port holding the same weights and
    basis."""
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


def _writer(out, batch):
    spans = [(c.hb_start, c.n_hyperblocks) for c in batch.chunks]
    return StreamingArchiveWriter(out, n_hyperblocks=batch.n_hyperblocks,
                                  n_values=batch.n_values,
                                  chunk_hyperblocks=batch.chunk_hyperblocks,
                                  gae_dim=batch.gae_dim, spans=spans), spans


# ---------------------------------------------------------------------------
# scheduler semantics
# ---------------------------------------------------------------------------

def test_scheduler_orders_results_despite_unordered_completion():
    def jitter(i, x):
        time.sleep(0.002 * ((x * 7) % 5))
        return x * x
    graph = StageGraph([StageSpec("jitter", jitter, workers=4,
                                  queue_depth=4)])
    results, stats = StreamScheduler(graph).run(list(range(20)))
    assert results == [x * x for x in range(20)]
    assert stats.n_items == 20 and stats.wall_s > 0


def test_scheduler_backpressure_bounds_queues():
    def fast(i, x):
        return x + 1

    def slow(i, x):
        time.sleep(0.003)
        return x * 10
    graph = StageGraph([StageSpec("fast", fast, queue_depth=1),
                        StageSpec("slow", slow, queue_depth=2)])
    results, stats = StreamScheduler(graph).run(list(range(16)))
    assert results == [(x + 1) * 10 for x in range(16)]
    assert stats.queue_high_water["slow"] <= 2
    assert stats.queue_high_water["fast"] <= 1


def test_scheduler_raises_lowest_index_error_deterministically():
    for _ in range(5):
        seen = []
        lock = threading.Lock()

        def fn(i, x):
            with lock:
                seen.append(x)
            if x in (2, 5):
                time.sleep(0.001 * (5 - x))   # let index 5 fail FIRST
                raise ValueError(f"boom-{x}")
            return x
        graph = StageGraph([StageSpec("fn", fn, workers=3, queue_depth=4)])
        with pytest.raises(ValueError, match="boom-2"):
            StreamScheduler(graph).run(list(range(8)))
        assert sorted(seen) == list(range(8))   # no short-circuit: all ran


def test_scheduler_multistage_error_drops_item_but_drains():
    done = []

    def explode(i, x):
        if x == 1:
            raise RuntimeError("stage1 fail")
        return x

    def collect(i, x):
        done.append(x)
        return x
    graph = StageGraph([StageSpec("explode", explode, queue_depth=2),
                        StageSpec("collect", collect, queue_depth=2)])
    with pytest.raises(RuntimeError, match="stage1 fail"):
        StreamScheduler(graph).run([0, 1, 2, 3])
    assert sorted(done) == [0, 2, 3]


def test_scheduler_stress_with_more_workers_than_cores():
    """Results stay in index order and every item passes every stage once
    with many workers and a shortened interpreter switch interval."""
    workers = 2 * (os.cpu_count() or 1) + 4
    seen = {"a": [], "b": []}

    def stage(name):
        def fn(i, x):
            seen[name].append(i)
            return x + 1
        return fn
    graph = StageGraph([StageSpec("a", stage("a"), workers=workers,
                                  queue_depth=2),
                        StageSpec("b", stage("b"), workers=workers,
                                  queue_depth=3)])
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t0 = time.perf_counter()
        results, stats = StreamScheduler(graph).run(list(range(300)))
        assert time.perf_counter() - t0 < 30.0
    finally:
        sys.setswitchinterval(old)
    assert results == [x + 2 for x in range(300)]
    assert sorted(seen["a"]) == sorted(seen["b"]) == list(range(300))
    assert stats.queue_high_water["b"] <= 3
    assert not [t for t in threading.enumerate()
                if t.name.startswith(("stream-a", "stream-b"))]


def test_scheduler_validates_graph():
    with pytest.raises(ValueError):
        StageGraph([])
    with pytest.raises(ValueError):
        StageGraph([StageSpec("a", lambda i, x: x),
                    StageSpec("a", lambda i, x: x)])
    with pytest.raises(ValueError):
        StageSpec("w", lambda i, x: x, workers=0)


# ---------------------------------------------------------------------------
# stream/batch byte-identity
# ---------------------------------------------------------------------------

def test_stream_matches_batch_byte_for_byte(comp_hb, tmp_path):
    comp, hb = comp_hb
    out = str(tmp_path / "stream.rba")
    exec_mod.reset_stage_stats()
    batch = comp.compress(hb, options=_opts())
    result = stream_compress(comp, hb, out_path=out, options=_opts())
    blob = archive_io.serialize_archive(batch)
    assert archive_io.serialize_archive(result.archive) == blob
    with open(out, "rb") as f:
        assert f.read() == blob
    assert result.bytes_written == len(blob)
    assert result.archive.compressed_bytes() == batch.compressed_bytes()
    assert not os.path.exists(out + ".partial")
    recon = comp.decompress(archive_io.read_archive(out))
    errs = np.linalg.norm((hb - recon).reshape(-1, 80), axis=1)
    assert float(errs.max()) <= TAU * (1 + 1e-5)
    counters = exec_mod.counters()
    assert counters["stream.overlap_s"] >= 0
    assert "stream.queue_high_water.host_encode" in counters
    assert any(k.startswith("stream.") for k in exec_mod.stage_stats())
    assert "stream.busy_s:" in exec_mod.stats_summary()


def test_stream_without_gae_or_output(comp_hb):
    comp, hb = comp_hb
    batch = comp.compress(hb, options=_opts(tau=None, chunk=5))
    result = stream_compress(comp, hb, options=_opts(tau=None, chunk=5))
    assert result.bytes_written == 0
    assert archive_io.serialize_archive(result.archive) == \
        archive_io.serialize_archive(batch)


# ---------------------------------------------------------------------------
# streaming archive writer
# ---------------------------------------------------------------------------

def test_writer_out_of_order_appends_finalize_identical(comp_hb, tmp_path):
    comp, hb = comp_hb
    batch = comp.compress(hb, options=_opts())
    out = str(tmp_path / "ooo.rba")
    w, _ = _writer(out, batch)
    for i in (2, 0, 3, 1):                    # scrambled arrival
        w.append(i, batch.chunks[i])
    assert w.appended() == 4
    nbytes = w.finalize()
    blob = archive_io.serialize_archive(batch)
    with open(out, "rb") as f:
        assert f.read() == blob
    assert nbytes == len(blob)


def test_writer_protocol_errors(comp_hb, tmp_path):
    comp, hb = comp_hb
    batch = comp.compress(hb, options=_opts())
    out = str(tmp_path / "proto.rba")
    w, _ = _writer(out, batch)
    w.append(0, batch.chunks[0])
    w.append(0, batch.chunks[0])              # identical re-append: no-op
    assert w.appended() == 1
    tampered = comp.encode_stripe_verbatim(
        batch.chunks[0].hb_start, hb[:batch.chunks[0].n_hyperblocks])
    assert archive_io.pack_chunk_section(tampered) != \
        archive_io.pack_chunk_section(batch.chunks[0])
    with pytest.raises(WriterStateError, match="different bytes"):
        w.append(0, tampered)
    with pytest.raises(WriterStateError, match="span table"):
        w.append(1, batch.chunks[2])
    with pytest.raises(WriterStateError, match="outside"):
        w.append(99, batch.chunks[0])
    with pytest.raises(WriterStateError, match="finalize"):
        w.finalize()
    w.abort()
    with pytest.raises(WriterStateError, match="aborted"):
        w.append(1, batch.chunks[1])
    assert os.path.exists(out + ".partial")


def test_partial_is_salvageable_after_every_append(comp_hb, tmp_path):
    comp, hb = comp_hb
    batch = comp.compress(hb, options=_opts())
    out = str(tmp_path / "salvage.rba")
    w, spans = _writer(out, batch)
    for appended in range(len(spans)):
        with open(out + ".partial", "rb") as f:
            data = f.read()
        with pytest.raises(ChecksumMismatch):
            archive_io.deserialize_archive(data, strict=True)
        salvaged = archive_io.deserialize_archive(data, strict=False)
        good = [i for i, c in enumerate(salvaged.chunks) if c is not None]
        assert good == list(range(appended))
        assert set(salvaged.chunk_errors) == \
            set(range(appended, len(spans)))
        w.append(appended, batch.chunks[appended])
    w.finalize()
    assert archive_io.read_archive(out, strict=True) is not None


# ---------------------------------------------------------------------------
# crash mid-stream
# ---------------------------------------------------------------------------

def test_crash_mid_stream_truncation_salvage(comp_hb, tmp_path):
    comp, hb = comp_hb
    batch = comp.compress(hb, options=_opts())
    out = str(tmp_path / "crash.rba")
    w, spans = _writer(out, batch)
    assert spans == [(0, 7), (7, 7), (14, 7), (21, 3)]
    for i in range(3):                        # chunk 3 never lands
        w.append(i, batch.chunks[i])
    w.abort()
    with open(out + ".partial", "rb") as f:
        partial = f.read()

    names = [archive_io._META_NAME] + [archive_io.chunk_section_name(i)
                                       for i in range(len(spans))]
    head = archive_io.head_size(names)
    meta = archive_io.build_meta_blob(
        n_hyperblocks=batch.n_hyperblocks, n_values=batch.n_values,
        chunk_hyperblocks=batch.chunk_hyperblocks, gae_dim=batch.gae_dim,
        spans=spans)
    cut = (head + len(meta)
           + archive_io.chunk_section_size(batch.chunks[0])
           + archive_io.chunk_section_size(batch.chunks[1])
           + archive_io.chunk_section_size(batch.chunks[2]) // 2)
    salvaged = archive_io.deserialize_archive(partial[:cut], strict=False)
    assert [c is not None for c in salvaged.chunks] == \
        [True, True, False, False]
    recon, report = comp.decompress(salvaged, strict=False)
    assert not report.ok
    assert [(d.chunk, d.hb_start, d.n_hyperblocks) for d in report.damaged] \
        == [(2, 14, 7), (3, 21, 3)]
    errs = np.linalg.norm((hb[:14] - recon[:14]).reshape(-1, 80), axis=1)
    assert float(errs.max()) <= TAU * (1 + 1e-5)

    rng = np.random.default_rng(7)
    for _ in range(24):
        bad = faultinject.corrupt(partial, "truncate", rng)
        try:
            arch = archive_io.deserialize_archive(bad, strict=False)
            comp.decompress(arch, strict=False)
        except archive_io.ArchiveError:
            pass


def test_stream_compress_failure_keeps_salvageable_partial(comp_hb, tmp_path,
                                                           monkeypatch):
    comp, hb = comp_hb
    out = str(tmp_path / "fail.rba")
    real = HierarchicalCompressor.encode_stripe_host

    def failing(self, hb_start, *args, **kwargs):
        if hb_start == 14:                    # chunk 2 of 4 dies
            raise RuntimeError("simulated encoder crash")
        return real(self, hb_start, *args, **kwargs)
    monkeypatch.setattr(HierarchicalCompressor, "encode_stripe_host", failing)
    with pytest.raises(RuntimeError, match="simulated encoder crash"):
        stream_compress(comp, hb, out_path=out, options=_opts())
    monkeypatch.undo()
    assert not os.path.exists(out)
    with open(out + ".partial", "rb") as f:
        salvaged = archive_io.deserialize_archive(f.read(), strict=False)
    good = [i for i, c in enumerate(salvaged.chunks) if c is not None]
    assert good == [0, 1]
    batch = comp.compress(hb, options=_opts())
    for i in good:
        assert archive_io.pack_chunk_section(salvaged.chunks[i]) == \
            archive_io.pack_chunk_section(batch.chunks[i])


# ---------------------------------------------------------------------------
# the port's own surface
# ---------------------------------------------------------------------------

def test_stream_compress_mesh_of_more_shards_than_devices_raises(comp_hb):
    comp, hb = comp_hb
    with pytest.raises(ConfigError, match="wants 2 shards but only 1"):
        stream_compress(comp, hb, options=_opts(mesh=2))


def test_async_split_equals_run_compress_stage(comp_hb):
    comp, hb = comp_hb
    args = (comp.hbae_params, comp._stage_params(), hb[:7],
            comp.cfg.hb_bin, comp.cfg.bae_bin)
    handles = exec_mod.run_compress_stage_async(*args)
    assert handles.done is None               # the CPU finishes in the call
    q_lh, q_lbs, recon = exec_mod.fetch_compress_stage(handles)
    w_lh, w_lbs, w_recon = exec_mod.run_compress_stage(*args)
    np.testing.assert_array_equal(q_lh, w_lh)
    for a, b in zip(q_lbs, w_lbs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(recon, w_recon)
    assert q_lh.dtype == np.int32 and recon.flags.writeable


def test_codec_workers_env(monkeypatch, comp_hb):
    comp, hb = comp_hb
    monkeypatch.setenv("REPRO_CODEC_WORKERS", "3")
    assert exec_mod.codec_workers() == 3
    monkeypatch.setenv("REPRO_CODEC_WORKERS", "junk")
    assert exec_mod.codec_workers() >= 1
    monkeypatch.setenv("REPRO_CODEC_WORKERS", "1")   # the serial path
    assert exec_mod.map_parallel(lambda x: x * 2, [1, 2, 3]) == [2, 4, 6]
    serial = stream_compress(comp, hb, options=_opts()).archive
    monkeypatch.delenv("REPRO_CODEC_WORKERS")
    assert archive_io.serialize_archive(serial) == \
        archive_io.serialize_archive(comp.compress(hb, options=_opts()))


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tau,chunk", [(TAU, 7), (None, 5), (TAU, 64)])
def test_streamed_bytes_equal_jax_stream(pair, tmp_path, tau, chunk):
    jc, tc, hb = pair
    j_out, t_out = str(tmp_path / "j.rba"), str(tmp_path / "t.rba")
    j_stream_compress(jc, hb, out_path=j_out,
                      options=JOptions(tau=tau, chunk_hyperblocks=chunk))
    t = stream_compress(tc, hb, out_path=t_out,
                        options=_opts(tau=tau, chunk=chunk))
    with open(j_out, "rb") as f:
        j_blob = f.read()
    with open(t_out, "rb") as f:
        assert f.read() == j_blob
    assert t.bytes_written == len(j_blob)


def test_streamed_archives_cross_decode_within_tau(pair, tmp_path):
    jc, tc, hb = pair
    j_out, t_out = str(tmp_path / "j.rba"), str(tmp_path / "t.rba")
    j_stream_compress(jc, hb, out_path=j_out, options=JOptions(
        tau=TAU, chunk_hyperblocks=7))
    stream_compress(tc, hb, out_path=t_out, options=_opts())
    for path in (j_out, t_out):
        for recon in (tc.decompress(archive_io.read_archive(path)),
                      jc.decompress(j_io.read_archive(path))):
            errs = np.linalg.norm((hb - recon).reshape(-1, 80), axis=1)
            assert float(errs.max()) <= TAU * (1 + 1e-5)


def test_partial_salvage_matches_jax(pair, tmp_path, monkeypatch):
    """A stream that dies on chunk 2 leaves the same .partial bytes in both
    packages."""
    jc, tc, hb = pair
    partials = []
    for comp_cls, comp, run, opts, name in (
            (JCompressor, jc, j_stream_compress,
             JOptions(tau=TAU, chunk_hyperblocks=7), "j"),
            (HierarchicalCompressor, tc, stream_compress, _opts(), "t")):
        real = comp_cls.encode_stripe_host

        def failing(self, hb_start, *args, _real=real, **kwargs):
            if hb_start == 14:
                raise RuntimeError("crash")
            return _real(self, hb_start, *args, **kwargs)
        monkeypatch.setattr(comp_cls, "encode_stripe_host", failing)
        out = str(tmp_path / f"{name}.rba")
        with pytest.raises(RuntimeError, match="crash"):
            run(comp, hb, out_path=out, options=opts)
        monkeypatch.undo()
        with open(out + ".partial", "rb") as f:
            partials.append(f.read())
    assert partials[0] == partials[1]
