"""The streaming path's device side on the card, without JAX.

``run_compress_stage_async`` / ``fetch_compress_stage`` run on a dispatch
stream ordered after the caller's by ``wait_stream``, upload from and
download into pinned host tensors, and mark the downloads with an event.
These tests hold that against the synchronous batch path on the card
(exactly) and against the same functions on the CPU, and hold
``stream_compress`` on the card to the batch ``compress`` there, with the
fault-tolerance ladder off, armed with a deadline (the dispatch then runs on
a watchdog thread), and under injected chaos (re-fetching after a
``transfer`` retry).

The file imports no JAX, so it runs on a machine with a card and no JAX:
``python -m pytest -m cuda tests/test_torch_stream_cuda.py``.  Every test
skips without a card.

Tolerances: the card's latents within one quantization bin of the CPU
path's on at most 0.1 % of the entries and its reconstruction within 1e-4
(the sums run in another order), as ``chip_smoke.py`` holds the S3D stripe;
the streamed bytes equal the batch bytes on the card exactly.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from repro_torch.core import exec as exec_mod
from repro_torch.core.options import CompressOptions
from repro_torch.core.pipeline import CompressorConfig, HierarchicalCompressor
from repro_torch.runtime import archive_io
from repro_torch.stream import stream_compress

TAU = 0.5
CFG = dict(block_elems=40, k=2, emb=16, hidden=32, hb_latent=8, bae_hidden=32,
           bae_latent=4, gae_block_elems=80, hb_bin=0.01, bae_bin=0.01,
           gae_bin=0.02)
STRIPE = 7


@pytest.fixture(scope="module")
def comps():
    """(compressor on the card, the same weights and basis on the CPU,
    hyper-blocks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    hb = rng.standard_normal((40, 2, 40)).astype(np.float32)
    hb *= 0.1
    cpu = HierarchicalCompressor(CompressorConfig(**CFG),
                                 device="cpu").init_params(0)
    cpu.fit_basis(hb)
    card = HierarchicalCompressor(CompressorConfig(**CFG),
                                  device="cuda").init_params(0)
    card.basis = cpu.basis.copy()
    return card, cpu, hb


def _front_end(comp, stripe):
    return (comp.hbae_params, comp._stage_params(), stripe, comp.cfg.hb_bin,
            comp.cfg.bae_bin)


@pytest.mark.cuda
def test_dispatched_stripes_in_flight_match_the_synchronous_path(comps):
    card, _, hb = comps
    stripes = [hb[s:s + STRIPE] for s in range(0, len(hb), STRIPE)]
    handles = [exec_mod.run_compress_stage_async(*_front_end(card, s))
               for s in stripes]          # all in flight before any fetch
    for stripe, h in zip(stripes, handles):
        got_lh, got_lbs, got_rec = exec_mod.fetch_compress_stage(h)
        want_lh, want_lbs, want_rec = exec_mod.run_compress_stage(
            *_front_end(card, stripe))
        np.testing.assert_array_equal(got_lh, want_lh)
        for g, w in zip(got_lbs, want_lbs):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got_rec, want_rec)


@pytest.mark.cuda
def test_dispatch_on_the_card_matches_the_cpu_path(comps):
    card, cpu, hb = comps
    stripe = hb[:STRIPE]
    g_lh, g_lbs, g_rec = exec_mod.fetch_compress_stage(
        exec_mod.run_compress_stage_async(*_front_end(card, stripe)))
    c_lh, c_lbs, _ = exec_mod.fetch_compress_stage(
        exec_mod.run_compress_stage_async(*_front_end(cpu, stripe)))
    for g, c in zip([g_lh] + g_lbs, [c_lh] + c_lbs):
        diff = np.abs(g.astype(np.int64) - c)
        assert diff.max() <= 1
        assert np.count_nonzero(diff) <= 0.001 * diff.size
    # the CPU's decode of the card's latents gives the card's reconstruction
    c_rec = exec_mod.run_decompress_stage(cpu.hbae_params, cpu.bae_params,
                                          g_lh, g_lbs, cpu.cfg.hb_bin,
                                          cpu.cfg.bae_bin)
    np.testing.assert_allclose(g_rec, c_rec, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [
    dict(queue_depth=2),
    dict(queue_depth=3, retries=1, stage_deadline_s=30.0),
], ids=["plain", "deadline"])
def test_stream_on_the_card_equals_batch_bytes(comps, tmp_path, extra):
    card, cpu, hb = comps
    opts = CompressOptions(tau=TAU, chunk_hyperblocks=STRIPE, **extra)
    batch = card.compress(hb, options=opts)
    out = str(tmp_path / "s.rba")
    result = stream_compress(card, hb, out_path=out, options=opts)
    assert not os.path.exists(out + ".partial")
    with open(out, "rb") as f:
        assert f.read() == archive_io.serialize_archive(batch)
    assert result.quarantined == []
    # the CPU decodes the card's streamed archive within tau
    recon = cpu.decompress(archive_io.read_archive(out))
    errs = np.linalg.norm((hb - recon).reshape(-1, CFG["gae_block_elems"]),
                          axis=1)
    assert errs.max() <= TAU * (1 + 1e-5)


@pytest.mark.cuda
def test_stream_under_chaos_on_the_card(comps, tmp_path):
    card, _, hb = comps
    batch = card.compress(hb, options=CompressOptions(
        tau=TAU, chunk_hyperblocks=STRIPE))
    out = str(tmp_path / "c.rba")
    result = stream_compress(card, hb, out_path=out, options=CompressOptions(
        tau=TAU, chunk_hyperblocks=STRIPE, retries=3, chaos_seed=0))
    assert sum(result.chaos_injected.values()) > 0
    disk = archive_io.read_archive(out, strict=True)
    assert len(disk.chunks) == len(batch.chunks)
    for ci, (got, want) in enumerate(zip(disk.chunks, batch.chunks)):
        if ci in result.quarantined:
            stripe = hb[got.hb_start:got.hb_start + got.n_hyperblocks]
            assert got.verbatim_blob
            np.testing.assert_array_equal(card.decode_stripe_verbatim(got),
                                          stripe)
        else:
            assert (archive_io.pack_chunk_section(got)
                    == archive_io.pack_chunk_section(want))
