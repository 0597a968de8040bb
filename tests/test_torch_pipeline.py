"""The port's compress -> archive -> decompress path against the JAX package.

Both compressors hold the same weights (JAX ``hbae_init``/``bae_init``,
carried across with ``params_from_jax``) and the same JAX-fitted PCA basis,
because ``eigh`` eigenvector signs are arbitrary.  Archives must cross-decode
in both directions with every GAE block within ``tau + 1e-4``, the slack
``test_pipeline.py`` uses; container bytes and model manifests must pass
between the packages unchanged.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import bae as j_bae
from repro.core import hbae as j_hbae
from repro.core.options import CompressOptions as JOptions
from repro.core.pipeline import CompressorConfig as JConfig
from repro.core.pipeline import HierarchicalCompressor as JCompressor
from repro.runtime import archive_io as j_io
from repro_torch.core import exec as t_exec
from repro_torch.core.errors import ConfigError
from repro_torch.core.options import CompressOptions as TOptions
from repro_torch.core.pipeline import CompressorConfig as TConfig
from repro_torch.core.pipeline import HierarchicalCompressor as TCompressor
from repro_torch.core.pipeline import params_from_jax
from repro_torch.data import blocks as blocks_mod
from repro_torch.data import synthetic
from repro_torch.runtime import archive_io as t_io

TAU = 0.25
D_GAE = 80
CFG = dict(k=2, emb=32, hidden=64, hb_latent=16, bae_latent=8,
           gae_block_elems=D_GAE, hb_bin=0.01, bae_bin=0.01, gae_bin=0.02)


@pytest.fixture(scope="module")
def hb():
    data = synthetic.s3d_like(n_species=8, t=10, h=16, w=16, seed=0)
    data = blocks_mod.Normalizer.fit(data, mode="range", axis=0).forward(data)
    blocks, _ = blocks_mod.block_nd(data, (8, 5, 4, 4))
    return blocks_mod.group_hyperblocks(blocks, k=2)


@pytest.fixture(scope="module")
def pair(hb):
    d = hb.shape[2]
    jc = JCompressor(JConfig(block_elems=d, **CFG))
    kh, kb = jax.random.split(jax.random.PRNGKey(0))
    jc.hbae_params = j_hbae.hbae_init(kh, in_dim=d, k=2, emb=32, hidden=64,
                                      latent=16)
    jc.bae_params = [j_bae.bae_init(kb, in_dim=d, hidden=256, latent=8)]
    jc.fit_basis(hb)
    tc = TCompressor(TConfig(block_elems=d, **CFG), device="cpu")
    tc.hbae_params, tc.bae_params = params_from_jax(
        jax.device_get(jc.hbae_params), jax.device_get(jc.bae_params),
        device="cpu")
    tc.basis = np.array(jc.basis)
    j_arch = jc.compress(hb, options=JOptions(tau=TAU, chunk_hyperblocks=4))
    t_arch = tc.compress(hb, options=TOptions(tau=TAU, chunk_hyperblocks=4))
    return jc, tc, j_io.serialize_archive(j_arch), t_io.serialize_archive(t_arch)


def _gae_errs(hb, recon):
    return np.linalg.norm((hb - recon).reshape(-1, D_GAE), axis=1)


def test_archives_cross_decode(hb, pair):
    jc, tc, j_blob, t_blob = pair
    assert len(t_io.deserialize_archive(t_blob).chunks) == 4
    for blob in (j_blob, t_blob):
        for recon in (tc.decompress(t_io.deserialize_archive(blob)),
                      jc.decompress(j_io.deserialize_archive(blob))):
            assert recon.shape == hb.shape
            assert _gae_errs(hb, recon).max() <= TAU + 1e-4


def test_container_bytes_identical_across_packages(pair):
    _, _, j_blob, t_blob = pair
    assert t_io.serialize_archive(t_io.deserialize_archive(j_blob)) == j_blob
    assert j_io.serialize_archive(j_io.deserialize_archive(t_blob)) == t_blob
    assert t_io.deserialize_archive(j_blob).compressed_bytes() == len(j_blob)


def test_disk_roundtrip_bit_equal(hb, pair, tmp_path):
    _, tc, _, t_blob = pair
    arch = t_io.deserialize_archive(t_blob)
    path = str(tmp_path / "a.rba")
    assert t_io.write_archive(arch, path) == len(t_blob)
    np.testing.assert_array_equal(tc.decompress(t_io.read_archive(path)),
                                  tc.decompress(arch))


def test_jax_save_loads_in_port_and_back(hb, pair, tmp_path):
    jc, tc, j_blob, t_blob = pair
    jc.save(str(tmp_path / "j.npz"))
    loaded = TCompressor.load(str(tmp_path / "j.npz"), device="cpu")
    assert dataclasses.asdict(loaded.cfg) == dataclasses.asdict(tc.cfg)
    np.testing.assert_array_equal(loaded.basis, jc.basis)
    arch = t_io.deserialize_archive(j_blob)
    np.testing.assert_array_equal(loaded.decompress(arch), tc.decompress(arch))
    assert loaded.model_bytes() == jc.model_bytes()

    tc.save(str(tmp_path / "t.npz"))
    back = JCompressor.load(str(tmp_path / "t.npz"))
    jarch = j_io.deserialize_archive(t_blob)
    np.testing.assert_array_equal(back.decompress(jarch), jc.decompress(jarch))
    for a, b in zip(jax.tree.leaves(back.hbae_params),
                    jax.tree.leaves(jc.hbae_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_damage_report_matches_jax(pair):
    jc, tc, j_blob, _ = pair
    pos = int(len(j_blob) * 0.6)
    bad = j_blob[:pos] + b"\x00" * 64 + j_blob[pos + 64:]
    _, t_rep = tc.decompress(t_io.deserialize_archive(bad, strict=False),
                             strict=False)
    _, j_rep = jc.decompress(j_io.deserialize_archive(bad, strict=False),
                             strict=False)
    assert not t_rep.ok
    assert [dataclasses.asdict(d) for d in t_rep.damaged] == \
        [dataclasses.asdict(d) for d in j_rep.damaged]
    assert t_rep.summary() == j_rep.summary()


def test_unported_options_raise(hb, pair):
    _, tc, _, _ = pair
    for opt in (dict(stream=True), dict(mesh=2), dict(retries=1),
                dict(stage_deadline_s=1.0), dict(chaos_seed=0)):
        with pytest.raises(ConfigError):
            tc.compress(hb, options=TOptions(tau=TAU, **opt))


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TCompressor(TConfig(block_elems=640, **CFG))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_exec.resolve_device()


def test_init_params_seeded_and_runs_the_slice(hb):
    def run(seed):
        c = TCompressor(TConfig(block_elems=hb.shape[2], **CFG), device="cpu")
        c.init_params(seed)
        arch = c.compress(hb, options=TOptions(tau=TAU, chunk_hyperblocks=8))
        return c, t_io.serialize_archive(arch)

    t_exec.reset_stage_stats()
    c, blob = run(0)
    stats = t_exec.stage_stats()
    assert {"ae_encode", "gae_encode", "entropy_encode"} <= set(stats)
    assert stats["gae_encode"].calls == 2            # one per stripe
    assert run(0)[1] == blob
    assert _gae_errs(hb, c.decompress(t_io.deserialize_archive(blob))).max() \
        <= TAU * (1 + 1e-5)
