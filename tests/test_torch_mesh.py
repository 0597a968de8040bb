"""The port's sharded compress path (``repro_torch.parallel``) against the JAX
package's (``repro.parallel``), on the CPU.

The JAX mesh is one process over a mesh of devices; its CPU check forces
virtual devices.  The port's counterpart is a 1-D ``Mesh`` that names
one device several times, so four shards run on the host's one CPU here.

* span planning (``plan_shard_groups``, ``group_slice``) and the options'
  mesh validation give the JAX package's results on the same inputs;
* a 4-shard CPU mesh gives the port's unsharded archive bytes, in batch
  and in stream (in memory and on disk, with and without ``retries``), on
  ``test_torch_pipeline.py``'s fixture with the JAX-fitted basis, and those
  archives decode in the JAX package with every GAE block within tau;
* an archive the JAX package sharded over 4 virtual devices (made in a
  subprocess, since the device count is frozen at jax's first import)
  decodes in the port within tau and has the port's section table, and
  the port's sharded archive with the JAX model's basis has its bytes;
* ``fit_pca_basis_sharded`` matches JAX's ``fit_pca_basis`` up to column
  sign (1 - 1e-3), ``decompress(mesh=)`` matches JAX's ``decompress`` at
  rtol 1e-5, atol 1e-6, and ``mesh_check --device cpu`` passes.

Tolerances: GAE blocks within ``tau + 1e-4`` across packages, as
``test_torch_pipeline.py`` holds them.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import bae as j_bae
from repro.core import gae as j_gae
from repro.core import hbae as j_hbae
from repro.core.errors import ConfigError as JConfigError
from repro.core.options import CompressOptions as JOptions
from repro.core.pipeline import CompressorConfig as JConfig
from repro.core.pipeline import HierarchicalCompressor as JCompressor
from repro.parallel import mesh_exec as j_mesh
from repro.runtime import archive_io as j_io
from repro_torch.core import exec as t_exec
from repro_torch.core.errors import ConfigError
from repro_torch.core.options import MESH_AXIS
from repro_torch.core.options import CompressOptions as TOptions
from repro_torch.core.pipeline import CompressorConfig as TConfig
from repro_torch.core.pipeline import HierarchicalCompressor as TCompressor
from repro_torch.core.pipeline import params_from_jax
from repro_torch.data import blocks as blocks_mod
from repro_torch.data import synthetic
from repro_torch.parallel import mesh_exec as t_mesh
from repro_torch.runtime import archive_io as t_io
from repro_torch.stream import stream_compress

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAU = 0.25
D_GAE = 80
SHARDS = 4
CFG = dict(k=2, emb=32, hidden=64, hb_latent=16, bae_latent=8,
           gae_block_elems=D_GAE, hb_bin=0.01, bae_bin=0.01, gae_bin=0.02)
CPU4 = t_mesh.make_compress_mesh(devices=["cpu"] * SHARDS)


# ---------------------------------------------------------------------------
# span planning and option validation, against the JAX package
# ---------------------------------------------------------------------------

def _spans(widths):
    """Consecutive (start, width) spans — the pipeline's stripe tiling."""
    spans, start = [], 0
    for w in widths:
        spans.append((start, w))
        start += w
    return spans


@pytest.mark.parametrize("widths,n_shards", [
    ([4, 4, 4, 4], 2),                  # all aligned
    ([4, 4, 4, 4, 4, 2], 4),            # ragged tail
    ([4, 4, 4, 3, 4, 4], 2),            # unequal widths stop grouping
    ([4, 4], 4),                        # fewer spans than shards
    ([4, 4, 3], 1),                     # n_shards 1
    ([64] * 25, 4),                     # the S3D field of chip_smoke.py
    ([64] * 24 + [1], 4),
    ([5, 5, 5, 5, 5, 5, 5, 2], 3),
    ([], 4),
], ids=["aligned", "ragged-tail", "unequal", "fewer-than-shards", "one-shard",
        "s3d-25", "s3d-tail", "three-shards", "empty"])
def test_plan_shard_groups_matches_jax(widths, n_shards):
    spans = _spans(widths)
    t_groups, t_tail = t_mesh.plan_shard_groups(spans, n_shards)
    j_groups, j_tail = j_mesh.plan_shard_groups(spans, n_shards)
    assert t_groups == j_groups and t_tail == j_tail
    assert [t_mesh.group_slice(g) for g in t_groups] == \
        [j_mesh.group_slice(g) for g in j_groups]


def test_plan_shard_groups_refuses_zero_shards_in_both():
    with pytest.raises(JConfigError):
        j_mesh.plan_shard_groups(_spans([4]), 0)
    with pytest.raises(ConfigError):
        t_mesh.plan_shard_groups(_spans([4]), 0)


class _FakeMesh:
    def __init__(self, axis_names, shape):
        self.axis_names, self.shape = axis_names, shape


@pytest.mark.parametrize("mesh", [
    None, 1, 3, 0, -2, True, "four",
    _FakeMesh(("x",), {"x": 4}),
    _FakeMesh((MESH_AXIS, "model"), {MESH_AXIS: 2, "model": 2}),
    _FakeMesh((MESH_AXIS, "aux"), {MESH_AXIS: 4, "aux": 1}),
    CPU4,
], ids=["none", "one", "three", "zero", "negative", "bool", "str",
        "no-hb-axis", "shards-another-axis", "aux-size-1", "compress-mesh"])
def test_options_mesh_validation_matches_jax(mesh):
    def outcome(options_cls, error_cls):
        try:
            return options_cls(mesh=mesh).mesh_shards()
        except error_cls:
            return "ConfigError"

    want = outcome(JOptions, JConfigError)
    assert outcome(TOptions, ConfigError) == want
    if isinstance(mesh, _FakeMesh) and MESH_AXIS not in mesh.axis_names:
        with pytest.raises(ConfigError, match=MESH_AXIS):
            TOptions(mesh=mesh)


def test_make_compress_mesh_refuses_impossible():
    with pytest.raises(ConfigError, match=">= 1 shard"):
        t_mesh.make_compress_mesh(0)
    with pytest.raises(ConfigError, match="only 1 device"):
        t_mesh.make_compress_mesh(2)
    with pytest.raises(ConfigError):
        t_mesh.make_compress_mesh(devices=[])
    with pytest.raises(ConfigError, match="names 2 device"):
        t_mesh.make_compress_mesh(3, devices=["cpu", "cpu"])
    assert tuple(t_mesh.make_compress_mesh(1).devices) == (
        torch.device("cpu"),)
    assert tuple(t_mesh.make_compress_mesh().devices) == (
        torch.device("cpu"),)
    assert tuple(CPU4.devices) == (torch.device("cpu"),) * SHARDS
    assert CPU4.axis_names == (MESH_AXIS,) and CPU4.shape == {MESH_AXIS: 4}


def test_resolve_mesh_trivial_specs():
    assert t_mesh.resolve_mesh(None) is None
    assert t_mesh.resolve_mesh(1) is None
    assert t_mesh.resolve_mesh(t_mesh.make_compress_mesh(1)) is None
    assert t_mesh.resolve_mesh(CPU4, device="cpu") is CPU4
    assert t_mesh.mesh_shards(None) == 1 and t_mesh.mesh_shards(CPU4) == 4
    with pytest.raises(ConfigError, match="cannot resolve"):
        t_mesh.resolve_mesh(_FakeMesh((MESH_AXIS,), {MESH_AXIS: 2}))
    with pytest.raises(ConfigError, match="device type"):
        t_mesh.resolve_mesh(CPU4, device="cuda")


# ---------------------------------------------------------------------------
# the sharded path on test_torch_pipeline.py's fixture
# ---------------------------------------------------------------------------

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
    return jc, tc


def _gae_errs(hb, recon):
    return np.linalg.norm((hb - recon).reshape(-1, D_GAE), axis=1)


def _table(archive):
    return (archive.n_hyperblocks, archive.chunk_hyperblocks, archive.gae_dim,
            [(c.hb_start, c.n_hyperblocks) for c in archive.chunks])


# chunk 4: 16 hyper-blocks in 4 stripes, one group and no tail; chunk 3: 6
# stripes (5 of 3, 1 of 1), one group and a ragged 2-stripe tail
@pytest.mark.parametrize("chunk", [4, 3])
def test_sharded_batch_bytes_equal_unsharded_and_decode_in_jax(hb, pair,
                                                               chunk):
    jc, tc = pair
    opts = TOptions(tau=TAU, chunk_hyperblocks=chunk)
    t_exec.reset_stage_stats()
    blob = t_io.serialize_archive(tc.compress(hb, options=opts))
    sharded = tc.compress(hb, options=opts.replace(mesh=CPU4))
    assert t_io.serialize_archive(sharded) == blob
    counts = t_exec.counters()
    assert counts["mesh.sharded_groups"] == 1
    assert counts["mesh.shards"] == SHARDS
    assert t_exec.stage_stats()["ae_encode_sharded"].calls == SHARDS
    recon = jc.decompress(j_io.deserialize_archive(blob))
    assert _gae_errs(hb, recon).max() <= TAU + 1e-4


@pytest.mark.parametrize("extra", [{}, {"retries": 1}],
                         ids=["plain", "retries"])
def test_sharded_stream_bytes_equal_unsharded(hb, pair, tmp_path, extra):
    jc, tc = pair
    opts = TOptions(tau=TAU, chunk_hyperblocks=3, **extra)
    blob = t_io.serialize_archive(tc.compress(hb, options=opts))
    out = str(tmp_path / "s.rba")
    result = stream_compress(tc, hb, out_path=out,
                             options=opts.replace(mesh=CPU4))
    assert result.stats.n_items == 3        # one group item, two tail items
    assert result.quarantined == []
    assert t_io.serialize_archive(result.archive) == blob
    with open(out, "rb") as f:
        disk = f.read()
    assert disk == blob and not os.path.exists(out + ".partial")
    recon = jc.decompress(j_io.deserialize_archive(disk))
    assert _gae_errs(hb, recon).max() <= TAU + 1e-4


def test_sharded_stream_quarantines_a_whole_group(hb, pair, monkeypatch):
    """A group item that fails for good becomes one verbatim chunk a
    stripe; the rest of the archive keeps the unsharded bytes."""
    _, tc = pair
    opts = TOptions(tau=TAU, chunk_hyperblocks=3, retries=0)
    batch = tc.compress(hb, options=opts)

    def broken(*args, **kwargs):
        raise RuntimeError("injected group failure")

    monkeypatch.setattr(t_exec, "run_compress_stage_sharded_async", broken)
    result = stream_compress(tc, hb, options=opts.replace(mesh=CPU4))
    assert result.quarantined == [0, 1, 2, 3]
    for ci, chunk in enumerate(result.archive.chunks):
        if ci < SHARDS:
            start, n = chunk.hb_start, chunk.n_hyperblocks
            np.testing.assert_array_equal(tc.decode_stripe_verbatim(chunk),
                                          hb[start:start + n])
        else:
            assert t_io.pack_chunk_section(chunk) == \
                t_io.pack_chunk_section(batch.chunks[ci])


def test_replicas_are_cached_per_params_and_device(pair):
    """``torch.device("cpu", 0)`` is another device object than the
    params' ``cpu``, so it takes the copy path: one replica per (params,
    device), made again when a source tensor changes in place; many threads
    at once make one."""
    import sys
    import threading

    _, tc = pair
    other = torch.device("cpu", 0)
    params = (_clone_tree(tc.hbae_params), [_clone_tree(tc.bae_params[0])])
    t_exec.reset_stage_stats()
    assert t_exec.replicate_params(*params, tc.device)[0] is params[0]
    assert "mesh.param_replicas" not in t_exec.counters()

    results, old = [], sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: results.extend(
            t_exec.replicate_params(*params, other)[0] for _ in range(50)))
            for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(results) == 400 and all(r is results[0] for r in results)
    assert t_exec.counters()["mesh.param_replicas"] == 1

    t_exec._tensor_leaves(params)[0].add_(0.0)      # an in-place change
    assert t_exec.replicate_params(*params, other)[0] is not results[0]
    assert t_exec.counters()["mesh.param_replicas"] == 2


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


_JAX_SHARDED = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import numpy as np
from repro.core import bae, hbae
from repro.core.options import CompressOptions
from repro.core.pipeline import CompressorConfig, HierarchicalCompressor
from repro.runtime import archive_io

hb = np.load(sys.argv[1])
assert len(jax.devices()) == 4, jax.devices()
d = hb.shape[2]
jc = HierarchicalCompressor(CompressorConfig(block_elems=d, **{cfg!r}))
kh, kb = jax.random.split(jax.random.PRNGKey(0))
jc.hbae_params = hbae.hbae_init(kh, in_dim=d, k=2, emb=32, hidden=64,
                                latent=16)
jc.bae_params = [bae.bae_init(kb, in_dim=d, hidden=256, latent=8)]
jc.fit_basis(hb)
archive = jc.compress(hb, options=CompressOptions(
    tau={tau!r}, chunk_hyperblocks=3, mesh=4))
archive_io.write_archive(archive, sys.argv[2])
jc.save(sys.argv[3])
"""


def test_jax_archive_sharded_over_virtual_devices_decodes_in_the_port(
        hb, tmp_path):
    hb_path, rba, model = (str(tmp_path / n)
                           for n in ("hb.npy", "j.rba", "j.npz"))
    np.save(hb_path, hb)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SHARDED.format(cfg=CFG, tau=TAU),
         hb_path, rba, model],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    tc = TCompressor.load(model, device="cpu")
    j_archive = t_io.read_archive(rba)
    recon = tc.decompress(j_archive, mesh=CPU4)
    assert _gae_errs(hb, recon).max() <= TAU + 1e-4
    mine = tc.compress(hb, options=TOptions(tau=TAU, chunk_hyperblocks=3,
                                            mesh=CPU4))
    assert _table(j_archive) == _table(mine)
    with open(rba, "rb") as f:              # with JAX's basis, JAX's bytes
        assert t_io.serialize_archive(mine) == f.read()


@pytest.mark.parametrize("rows", [400, 401], ids=["even", "padded"])
def test_fit_pca_basis_sharded_matches_jax_up_to_sign(rows):
    rng = np.random.default_rng(7)
    resid = rng.standard_normal((rows, 80)).astype(np.float32) * 0.1
    want = np.asarray(j_gae.fit_pca_basis(jax.numpy.asarray(resid)))
    got = t_mesh.fit_pca_basis_sharded(resid, CPU4)
    assert got.shape == want.shape == (80, 80)
    align = np.abs(np.sum(want * got, axis=0))
    assert align.min() > 1 - 1e-3


def test_fit_basis_over_the_mesh_honors_tau(hb, pair):
    _, tc = pair
    fresh = TCompressor(tc.cfg, device="cpu")
    fresh.hbae_params, fresh.bae_params = tc.hbae_params, tc.bae_params
    basis = fresh.fit_basis(hb, mesh=CPU4)
    assert basis.shape == (D_GAE, D_GAE)
    np.testing.assert_allclose(basis.T @ basis, np.eye(D_GAE), atol=1e-5)
    archive = fresh.compress(hb, options=TOptions(tau=TAU,
                                                  chunk_hyperblocks=4))
    assert _gae_errs(hb, fresh.decompress(archive)).max() <= TAU * (1 + 1e-5)


@pytest.mark.parametrize("chunk", [4, 3])
def test_sharded_decompress_matches_jax(hb, pair, chunk):
    jc, tc = pair
    blob = t_io.serialize_archive(
        tc.compress(hb, options=TOptions(tau=TAU, chunk_hyperblocks=chunk)))
    want = jc.decompress(j_io.deserialize_archive(blob))
    got = tc.decompress(t_io.deserialize_archive(blob), mesh=CPU4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert _gae_errs(hb, got).max() <= TAU + 1e-4


def test_mesh_check_cpu_subprocess():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               REPRO_MESH_CHECK_DEVICES="4")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.parallel.mesh_check",
         "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    report = json.loads(proc.stdout)
    assert report["ok"] and report["shards"] == 4
    assert [c["name"] for c in report["checks"]] == [
        "batch_parity", "sharded_groups_ran", "stream_parity",
        "replicas_reused", "psum_basis_consistent",
        "sharded_basis_honors_tau", "sharded_decompress"]
    assert "zero_retraces_after_warmup" in report["detail"]
    assert "options_shim" in report["detail"]
