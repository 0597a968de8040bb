"""The sharded compress path on the card, without JAX.

A 4-shard compress mesh over ``cuda:0`` repeated (the port's
counterpart of the JAX package's virtual devices) must give the unsharded
archive bytes in batch and in stream, launch the same kernels as often, run
every shard's stage functions on the card, and decode within float32
tolerance of the single decode; a CPU mesh with params on the card is a
``ConfigError``, never a silent move.

The file imports no JAX: ``python -m pytest -m cuda
tests/test_torch_mesh_cuda.py`` on a machine with a card.  Every test skips
without one.

Tolerances: bytes exactly; the sharded decode within rtol 1e-5, atol 1e-6
of the single decode (its shards see other batch shapes), as
``repro_torch.parallel.mesh_check`` holds it.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from repro_torch.core import exec as exec_mod
from repro_torch.core import gae
from repro_torch.core.errors import ConfigError
from repro_torch.core.options import CompressOptions
from repro_torch.core.pipeline import CompressorConfig, HierarchicalCompressor
from repro_torch.kernels.block_attention import ops as ba
from repro_torch.kernels.gae_project import ops as gp
from repro_torch.kernels.quantize import ops as qz
from repro_torch.parallel import mesh_exec
from repro_torch.runtime import archive_io
from repro_torch.stream import stream_compress

TAU = 0.5
CFG = dict(block_elems=40, k=2, emb=16, hidden=32, hb_latent=8, bae_hidden=32,
           bae_latent=4, gae_block_elems=80, hb_bin=0.01, bae_bin=0.01,
           gae_bin=0.02)
CHUNK = 4          # 30 hyper-blocks: 8 stripes, one group of 4 and a tail
SHARDS = 4
COUNTERS = {"quantize": qz.launches, "block_attention": ba.launches,
            "gae_project": gp.launches}


@pytest.fixture(scope="module")
def card_hb():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    hb = (0.1 * rng.standard_normal((30, 2, 40))).astype(np.float32)
    card = HierarchicalCompressor(CompressorConfig(**CFG),
                                  device="cuda").init_params(0)
    card.fit_basis(hb)
    mesh = mesh_exec.make_compress_mesh(devices=["cuda:0"] * SHARDS)
    return card, hb, mesh


def _opts(**kw) -> CompressOptions:
    return CompressOptions(tau=TAU, chunk_hyperblocks=CHUNK, **kw)


def _launches() -> dict:
    return {name: c.value for name, c in COUNTERS.items()}


@pytest.mark.cuda
def test_sharded_batch_on_the_card_equals_unsharded_bytes_and_launches(
        card_hb):
    card, hb, mesh = card_hb
    for c in COUNTERS.values():
        c.reset()
    blob = archive_io.serialize_archive(card.compress(hb, options=_opts()))
    single = _launches()
    for c in COUNTERS.values():
        c.reset()
    exec_mod.reset_stage_stats()
    sharded = card.compress(hb, options=_opts(mesh=mesh))
    assert archive_io.serialize_archive(sharded) == blob
    assert _launches() == single and all(single.values())
    assert exec_mod.counters()["mesh.sharded_groups"] == 1


@pytest.mark.cuda
def test_sharded_stream_on_the_card_equals_unsharded_bytes(card_hb, tmp_path):
    card, hb, mesh = card_hb
    blob = archive_io.serialize_archive(card.compress(hb, options=_opts()))
    out = str(tmp_path / "s.rba")
    result = stream_compress(card, hb, out_path=out,
                             options=_opts(mesh=mesh, retries=1))
    assert result.quarantined == []
    assert archive_io.serialize_archive(result.archive) == blob
    with open(out, "rb") as f:
        assert f.read() == blob
    assert not os.path.exists(out + ".partial")


@pytest.mark.cuda
def test_every_shard_runs_on_the_card(card_hb, monkeypatch):
    card, hb, mesh = card_hb
    seen = []
    frontend = exec_mod._encode_frontend

    def recording(*args):
        q_lh, q_lbs = frontend(*args)
        seen.append({t.device.type for t in [args[2], q_lh, *q_lbs]})
        return q_lh, q_lbs

    monkeypatch.setattr(exec_mod, "_encode_frontend", recording)
    handles = exec_mod.run_compress_stage_sharded_async(
        card.hbae_params, card._stage_params(), hb[:SHARDS * CHUNK],
        card.cfg.hb_bin, card.cfg.bae_bin, mesh)
    assert len(handles) == SHARDS and all(h.done is not None for h in handles)
    assert seen == [{"cuda"}] * SHARDS
    for i, h in enumerate(handles):
        want = exec_mod.run_compress_stage(
            card.hbae_params, card._stage_params(),
            hb[i * CHUNK:(i + 1) * CHUNK], card.cfg.hb_bin, card.cfg.bae_bin)
        got = exec_mod.fetch_compress_stage(h)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.cuda
def test_sharded_decode_and_basis_on_the_card(card_hb):
    card, hb, mesh = card_hb
    archive = card.compress(hb, options=_opts())
    single = card.decompress(archive)
    sharded = card.decompress(archive, mesh=mesh)
    np.testing.assert_allclose(sharded, single, rtol=1e-5, atol=1e-6)
    errs = np.linalg.norm((hb - sharded).reshape(-1, CFG["gae_block_elems"]),
                          axis=1)
    assert errs.max() <= TAU * (1 + 1e-5)
    rng = np.random.default_rng(7)
    resid = (0.1 * rng.standard_normal((401, 80))).astype(np.float32)
    with torch.inference_mode():
        want = gae.fit_pca_basis(torch.from_numpy(resid).cuda()).cpu().numpy()
    got = mesh_exec.fit_pca_basis_sharded(resid, mesh)
    assert np.abs(np.sum(want * got, axis=0)).min() > 1 - 1e-3


@pytest.mark.cuda
def test_mesh_over_distinct_cards_equals_unsharded_bytes(card_hb):
    """Needs two cards or more: the params are copied to every card but the
    first, once, and each shard runs there."""
    card, hb, _ = card_hb
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("needs two cards")
    mesh = mesh_exec.make_compress_mesh(n_cards)
    blob = archive_io.serialize_archive(card.compress(hb, options=_opts()))
    exec_mod.reset_stage_stats()
    sharded = card.compress(hb, options=_opts(mesh=mesh))
    assert archive_io.serialize_archive(sharded) == blob
    assert exec_mod.counters().get("mesh.param_replicas") == n_cards - 1
    result = stream_compress(card, hb, options=_opts(mesh=mesh))
    assert archive_io.serialize_archive(result.archive) == blob
    assert exec_mod.counters().get("mesh.param_replicas") == n_cards - 1
    single = card.decompress(sharded)
    np.testing.assert_allclose(card.decompress(sharded, mesh=mesh), single,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_cpu_mesh_with_params_on_the_card_raises(card_hb):
    card, hb, _ = card_hb
    cpu_mesh = mesh_exec.make_compress_mesh(devices=["cpu"] * SHARDS)
    with pytest.raises(ConfigError, match="device type"):
        card.compress(hb, options=_opts(mesh=cpu_mesh))
    with pytest.raises(ConfigError, match="device type"):
        stream_compress(card, hb, options=_opts(mesh=cpu_mesh))
    with pytest.raises(ConfigError, match="device type"):
        card.fit_basis(hb, mesh=cpu_mesh)
    with pytest.raises(ConfigError):
        exec_mod.replicate_params(card.hbae_params, card.bae_params,
                                  torch.device("cpu"))
