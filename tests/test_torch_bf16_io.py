"""bf16 across the boundary between the JAX package and the port, and the
port's own bf16 checkpoints, on the CPU.

A JAX bf16 array reaches numpy as ml_dtypes' ``bfloat16`` (kind ``V``, two
bytes), which torch cannot read, and JAX's ``CheckpointManager`` writes it
into its ``.npz`` as ``|V2`` under ``"dtype": "bfloat16"``.  The port takes
those two bytes a value as they are: ``params_from_jax`` and
``train_state_from_jax`` through a uint16 view, its ``CheckpointManager``
and ``save_compressed`` writing the uint16 bits under the same dtype name,
and restoring bf16 from the manifest whichever of the two the file holds.
Every comparison here is bit for bit (the bits as uint16), except the
float32 leaves of a compressed checkpoint, which are held to its ``tau``.

Also here: a saved step's host copies are freed when ``save`` returns,
without the cyclic collector (ROADMAP.md §3 item 13), and ``kv_tau``'s
quantization of a bf16 KV cache, bit for bit the float32 formula's.
"""
from __future__ import annotations

import gc
import json
import os
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import RunConfig as JRunConfig
from repro.models import registry as j_registry
from repro.runtime.checkpoint import CheckpointManager as JManager
from repro.train import loop as j_loop
from repro.train import optim as j_opt
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.models import registry
from repro_torch.runtime import checkpoint
from repro_torch.train import loop
from repro_torch.train import optim as t_opt

ARCH = "qwen2-1.5b"
TAU = 0.05


def _bits(x) -> np.ndarray:
    """A bf16 leaf (tensor or ml_dtypes array) as its uint16 bits; any
    other leaf as numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _assert_same(want_leaves, got_leaves):
    assert len(want_leaves) == len(got_leaves)
    for a, b in zip(want_leaves, got_leaves):
        a, b = np.asarray(a), b
        if a.dtype.name == "bfloat16":
            assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(b), _bits(a))


@pytest.fixture(scope="module")
def j_state():
    """JAX's bf16-param ``TrainState`` (float32 moments), on the host."""
    jcfg = j_registry.reduced_config(j_get_config(ARCH))
    jrun = JRunConfig(param_dtype="bfloat16", gradient_compression="pca_ef")
    state = j_loop.init_train_state(jax.random.PRNGKey(0), jcfg, jrun,
                                    j_opt.adamw(1e-3))
    return jax.device_get(state)


def test_params_and_state_from_jax_take_bf16(j_state):
    params = registry.params_from_jax(j_state.params, "cpu")
    _assert_same(jax.tree.leaves(j_state.params), t_opt.tree_leaves(params))
    state = registry.train_state_from_jax(j_state, "cpu")
    _assert_same(jax.tree.leaves(j_state), t_opt.tree_leaves(list(state)))
    assert {x.dtype for x in t_opt.tree_leaves(state.opt.nu)} \
        == {torch.float32}
    one = registry.params_from_jax(np.asarray(jnp.ones(3, jnp.bfloat16)),
                                   "cpu")
    assert one.dtype == torch.bfloat16 and torch.equal(
        one, torch.ones(3, dtype=torch.bfloat16))


def test_jax_written_bf16_step_restores_as_bf16(j_state, tmp_path):
    """JAX's step directory holds bf16 as ``|V2`` under "bfloat16"; the
    port restores it as ``torch.bfloat16``, bit for bit, hashes checked."""
    JManager(str(tmp_path), async_save=False).save(3, j_state)
    with open(os.path.join(tmp_path, "step_00000003", "manifest.json")) as f:
        dtypes = {t["dtype"] for t in json.load(f)["tensors"]}
    assert "bfloat16" in dtypes
    step, state = checkpoint.CheckpointManager(str(tmp_path),
                                               device="cpu").restore()
    assert step == 3 and isinstance(state, loop.TrainState)
    _assert_same(jax.tree.leaves(j_state), t_opt.tree_leaves(list(state)))


def test_jax_restore_gives_bf16_back_as_void_bytes(j_state, tmp_path):
    """The JAX side's divergence (ROADMAP.md §3, known divergence 11): its
    own ``restore`` hands a bf16 leaf back as ``|V2`` bytes, not bf16; the
    port reads the same file as bf16 (the test above)."""
    mgr = JManager(str(tmp_path), async_save=False)
    mgr.save(0, {"w": j_state.params["embed"]["w"]})
    _, tree = mgr.restore()
    assert tree["w"].dtype.kind == "V" and tree["w"].dtype.itemsize == 2
    np.testing.assert_array_equal(tree["w"].view(np.uint16),
                                  _bits(j_state.params["embed"]["w"]))


def _port_state():
    cfg = registry.reduced_config(get_config(ARCH))
    run = RunConfig(param_dtype="bfloat16", gradient_compression="pca_ef")
    return loop.init_train_state(torch.Generator().manual_seed(0), cfg, run,
                                 t_opt.adamw(1e-3), "cpu")


def test_port_bf16_state_saves_and_restores(tmp_path):
    state = _port_state()
    mgr = checkpoint.CheckpointManager(str(tmp_path), device="cpu",
                                       async_save=False)
    mgr.save(1, state)
    with open(os.path.join(tmp_path, "step_00000001", "manifest.json")) as f:
        tensors = json.load(f)["tensors"]
    bf16 = [t for t in tensors if t["dtype"] == "bfloat16"]
    assert [t["path"] for t in bf16] == [
        t["path"] for t in tensors if t["path"].startswith(".params/")]
    with np.load(os.path.join(tmp_path, "step_00000001", "arrays.npz")) as d:
        assert d[bf16[0]["key"]].dtype == np.uint16
    _, back = mgr.restore()
    assert isinstance(back, loop.TrainState)
    for a, b in zip(t_opt.tree_leaves(list(state)),
                    t_opt.tree_leaves(list(back))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(b), _bits(a))


def test_port_bf16_state_through_the_compressed_checkpoint(tmp_path):
    """bf16 leaves stay raw, as in JAX (``arr.dtype.kind != "f"``), and
    come back bit for bit; a smooth float32 leaf beside them is coded, and
    every block of it comes back within tau."""
    params = _port_state().params
    t = torch.arange(2048 * 256, dtype=torch.float32)
    smooth = torch.sin(t / 50.0).reshape(2048, 256)  # past its basis's bytes
    path = str(tmp_path / "c.npz")
    stats = checkpoint.save_compressed(path, {"params": params,
                                              "smooth": smooth},
                                       tau=TAU, device="cpu")
    with np.load(path) as d:
        manifest = json.loads(d["manifest"].tobytes())
    kinds = {e["path"]: (e["kind"], e["dtype"]) for e in manifest["tensors"]}
    assert {kinds[p] for p in kinds if p.startswith("params/")} \
        == {("raw", "bfloat16")}
    assert kinds["smooth"] == ("gae", "float32")
    assert stats["ratio"] > 1.0
    back = checkpoint.restore_compressed(path, device="cpu")
    for a, b in zip(t_opt.tree_leaves(params),
                    t_opt.tree_leaves(back["params"])):
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(b), _bits(a))
    err = torch.linalg.vector_norm((back["smooth"] - smooth), dim=1)
    assert err.max() <= TAU * (1 + 1e-5)


def test_saved_host_copies_die_with_the_save(tmp_path, monkeypatch):
    """ROADMAP.md §3 item 13: no reference cycle holds a step's host copies
    once ``save`` returns, so they are freed with the collector off."""
    copies = []
    real = checkpoint._to_numpy

    def recording(leaf):
        arr = real(leaf)
        copies.append(weakref.ref(arr))
        return arr

    monkeypatch.setattr(checkpoint, "_to_numpy", recording)
    mgr = checkpoint.CheckpointManager(str(tmp_path), device="cpu")
    tree = {"a": torch.ones(8, 8), "b": [torch.zeros(3), torch.arange(4)],
            "c": torch.ones(5, dtype=torch.bfloat16)}
    was = gc.isenabled()
    gc.disable()
    try:
        mgr.save(0, tree, blocking=True)
        assert len(copies) == 4
        assert all(ref() is None for ref in copies)
    finally:
        if was:
            gc.enable()


def test_kv_quantize_takes_a_bf16_cache_as_it_is():
    """``quantize_kv_bounded`` hands a bf16 cache to the quantize kernel
    without a cast: the same bits as the float32 formula on the cast, and
    each token within tau, where the JAX package's, which divides in bf16
    (8 bits: x / bin past 256 falls on even bins and wider), is not
    (ROADMAP.md §3, known divergence 12)."""
    from repro.runtime.kvcache import quantize_kv_bounded as j_quantize
    from repro_torch.core.quantization import quantize_dequantize
    from repro_torch.runtime.kvcache import quantize_kv_bounded

    tau = 0.05
    rng = np.random.default_rng(0)
    kv = torch.from_numpy(3 * rng.standard_normal((1, 64, 2, 128))
                          .astype(np.float32)).to(torch.bfloat16)
    got = quantize_kv_bounded(kv, tau)
    bin_size = 2.0 * tau / float(np.sqrt(2 * 128))
    want = quantize_dequantize(kv.float(), bin_size).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want))
    x = kv.float().numpy().reshape(64, -1)
    err = np.linalg.norm(got.float().numpy().reshape(64, -1) - x, axis=1)
    assert err.max() <= tau
    j_out, _ = j_quantize(jnp.asarray(_bits(kv)).view(jnp.bfloat16), tau)
    j_err = np.linalg.norm(np.asarray(j_out, np.float32).reshape(64, -1) - x,
                           axis=1)
    assert j_err.max() > tau


def test_bf16_format_both_ways():
    """``core.bf16``, the one module that knows the crossing format: an
    ml_dtypes array from ``jax.device_get`` and a bf16 tensor each go to
    their uint16 bits in a copy of their own, and back, bit for bit."""
    from repro_torch.core import bf16

    rng = np.random.default_rng(0)
    j_arr = jax.device_get(jnp.asarray(rng.standard_normal((3, 5)),
                                       jnp.bfloat16))
    assert j_arr.dtype.kind == "V" and bf16.is_bf16(j_arr)
    bits = bf16.to_bits(j_arr)
    assert bits.dtype == np.uint16 and not np.shares_memory(bits, j_arr)
    t = bf16.from_bits(np.array(j_arr))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(j_arr, np.float32))
    np.testing.assert_array_equal(bf16.to_bits(t), bits)
    assert bf16.is_bf16(t) and not bf16.is_bf16(t.float())
    assert not bf16.is_bf16(np.zeros(2, np.uint16))
    t_bits = bf16.to_bits(t)
    t_bits[0, 0] ^= 1
    assert torch.equal(bf16.from_bits(bits), t)


def test_global_norm_cuts_only_leaves_that_are_not_float32(monkeypatch):
    """A float32 leaf is summed whole, as before bf16 params, so a float32
    clip norm keeps its rounding; a bf16 leaf of more than
    ``GROUP_BYTES // 4`` elements is summed piece by piece in float32."""
    monkeypatch.setattr(t_opt, "GROUP_BYTES", 64)
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal(100).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((10, 10)).astype(np.float32)
                         ).to(torch.bfloat16)
    whole = torch.sqrt(sum(torch.sum(torch.square(x)) for x in [a]))
    assert torch.equal(t_opt.global_norm({"a": a}), whole)
    pieces = [a] + [p.float() for p in b.reshape(-1).split(16)]
    want = torch.sqrt(sum(torch.sum(torch.square(x)) for x in pieces))
    assert torch.equal(t_opt.global_norm({"a": a, "b": b}), want)
