"""The port's gradient compression and error-bounded compressed checkpoints
against the JAX package's, on the CPU.

Inputs are made with numpy from a seed.  Tolerances, each stated where it is
used:

* ``compress_update`` (``pca_ef``): the compressed gradients and the error
  buffers at 1e-5 of the gradient's largest entry (fp32 products in another
  order, and an ``eigh`` basis that agrees up to the columns' signs, which
  ``c @ U.T`` does not see: the inputs' spectra have no ties at the rank
  cut); the ``compression`` statistic exactly (float32 counts);
* ``compress_update`` with quantized coefficients: each block within one
  bin of JAX's (``_close_but_a_bin``);
* ``gae_compress_grads``: JAX's kept coefficients within 1 % of the blocks
  (a block's M moves by one where err^2(M) is within rounding of tau^2),
  every block within ``tau (1 + 1e-4)`` as ``tests/test_grad_compress.py``
  holds JAX's;
* ``save_compressed``/``restore_compressed``: every block within
  ``tau (1 + 1e-5)``, as ``tests/test_checkpoint.py`` holds JAX's; raw
  tensors bit for bit;
* ``quantize``/``dequantize`` at a bin of 1e-4: bit for bit the JAX
  package's, and within ``bin / 2 + np.spacing(|x|)`` (one fp32 rounding of
  ``q * bin``; ROADMAP.md §3, known divergence 6).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as j_quant
from repro.runtime import grad_compress as j_gc
from repro_torch.core import quantization as t_quant
from repro_torch.runtime import checkpoint as t_ckpt
from repro_torch.runtime import grad_compress as t_gc
from repro_torch.train import optim as t_opt

GC_FRAC = 1e-5


def _g(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _grads(seed=0):
    """Two leaves of a structured gradient: low-rank plus noise, so the
    block covariance has a clear spectrum at the rank cut."""
    rng = np.random.default_rng(seed)
    low = (rng.standard_normal((48, 3)) @ rng.standard_normal((3, 64)))
    return {"a": (low + 0.1 * rng.standard_normal((48, 64))).astype(np.float32),
            "b": {"w": rng.standard_normal((40, 32)).astype(np.float32)}}


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch_tree(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _port_state(jstate):
    j = jax.device_get(jstate)
    return t_gc.GradCompressionState(
        basis=torch.from_numpy(np.array(j.basis)),
        error=jax.tree.map(lambda e: torch.from_numpy(np.array(e)), j.error),
        step=torch.from_numpy(np.array(j.step)))


def _close(got, want, scale):
    for a, b in zip(jax.tree.leaves(want), t_opt.tree_leaves(got)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=GC_FRAC * scale)


def _close_but_a_bin(got, want, scale, bin_size, block):
    """Quantized coefficients: a coefficient within fp32 noise of a half-way
    point lands in the other bin in one package, which moves its block by
    ``bin * u_k`` (norm ``bin``: the basis columns are unit vectors).  So
    each block is within ``bin`` of the JAX package's (plus 1e-5 of the
    scale), and at most one block, or 2 % of the blocks, differs beyond 1e-5
    of the scale."""
    for a, b in zip(jax.tree.leaves(want), t_opt.tree_leaves(got)):
        a = np.asarray(a).reshape(-1)
        d = b.numpy().reshape(-1) - a
        d = np.pad(d, (0, -d.size % block)).reshape(-1, block)
        norms = np.linalg.norm(d, axis=1)
        assert norms.max() <= bin_size + GC_FRAC * scale
        moved = np.sum(np.abs(d).max(axis=1) > GC_FRAC * scale)
        assert moved <= max(1, 0.02 * len(d))


# ---------------------------------------------------------------------------
# pca_ef
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("refresh_every,bin_size", [(50, 0.0), (1, 0.0),
                                                    (50, 0.01), (0, 0.0)])
def test_compress_update_matches_jax(refresh_every, bin_size):
    """Step 0 (with its refresh where ``refresh_every`` > 0) and step 1 (a
    refresh only at ``refresh_every`` 1), each package from its own state."""
    g0, g1 = _grads(0), _grads(1)
    scale = max(np.abs(x).max() for x in jax.tree.leaves([g0, g1]))
    j_state = j_gc.init_state(_jax_tree(g0), block=64, rank=8)
    t_state = _port_state(j_state)
    for g in (g0, g1):
        j_hat, j_state, j_stats = j_gc.compress_update(
            _jax_tree(g), j_state, bin_size=bin_size,
            refresh_every=refresh_every)
        t_hat, t_state, t_stats = t_gc.compress_update(
            _torch_tree(g), t_state, bin_size=bin_size,
            refresh_every=refresh_every)
        if bin_size:
            _close_but_a_bin(t_hat, j_hat, scale, bin_size, 64)
            _close_but_a_bin(t_state.error, j_state.error, scale, bin_size,
                             64)
        else:
            _close(t_hat, j_hat, scale)
            _close(t_state.error, j_state.error, scale)
        assert t_stats["compression"] == float(j_stats["compression"])
        assert t_stats["comm_elems"] == float(j_stats["comm_elems"])
        assert int(t_state.step) == int(j_state.step)
    # the basis spans the same space (its columns' signs are arbitrary)
    jb, tb = np.asarray(j_state.basis), t_state.basis.numpy()
    np.testing.assert_allclose(np.abs(jb.T @ tb), np.eye(8), atol=1e-4)


def test_compress_update_leaves_its_state_and_keeps_the_split():
    g = _torch_tree(_grads(2))
    st = t_gc.init_state(g, block=64, rank=8)
    before = [x.clone() for x in t_opt.tree_leaves(st)]
    ghat, st2, _ = t_gc.compress_update(g, st, bin_size=0.01)
    for a, b in zip(before, t_opt.tree_leaves(st)):
        assert torch.equal(a, b)
    # the split ghat + error = g + old error holds with quantization too
    for x, h, e in zip(t_opt.tree_leaves(g), t_opt.tree_leaves(ghat),
                       t_opt.tree_leaves(st2.error)):
        np.testing.assert_allclose((h + e).numpy(), x.numpy(), atol=1e-5)


def test_make_basis_is_orthonormal_and_deterministic():
    u1, u2 = t_gc.make_basis(128, 16, seed=5), t_gc.make_basis(128, 16, seed=5)
    assert torch.equal(u1, u2) and u1.shape == (128, 16)
    np.testing.assert_allclose((u1.T @ u1).numpy(), np.eye(16), atol=1e-5)
    assert not torch.equal(u1, t_gc.make_basis(128, 16, seed=6))


def test_fixed_basis_diverges_and_refresh_bounds_the_error():
    """As tests/test_grad_compress.py shows for JAX: a fixed basis lets the
    error buffer grow, the adaptive refresh keeps it bounded."""
    g = {"w": torch.from_numpy(_g(1, (8, 64)))}
    for refresh, grows in ((0, True), (1, False)):
        st = t_gc.init_state(g, block=64, rank=4)
        for _ in range(30):
            _, st, _ = t_gc.compress_update(g, st, refresh_every=refresh)
        ratio = float(st.error["w"].norm() / g["w"].norm())
        assert (ratio > 5) if grows else (ratio < 1), (refresh, ratio)


def test_axis_name_is_refused():
    """``axis_name`` without a mesh that has the axis is unbound, as JAX's
    ``pmean`` outside ``shard_map``; with one, each shard's gradient and
    state go in, and a shard's share of the mean comes back on each."""
    from repro_torch.launch.mesh import make_mesh

    g = {"w": torch.from_numpy(_g(5, (4, 64)))}
    st = t_gc.init_state(g, block=64, rank=4)
    with pytest.raises(NameError, match="unbound axis name: data"):
        t_gc.compress_update(g, st, axis_name="data")
    mesh = make_mesh((2,), ("data",), ["cpu", "cpu"])
    with pytest.raises(NameError, match="unbound axis name: pod"):
        t_gc.compress_update([g, g], [st, st], axis_name="pod", mesh=mesh)
    ghat, states, _ = t_gc.compress_update([g, g], [st, st],
                                           axis_name="data", mesh=mesh)
    want, want_st, _ = t_gc.compress_update(g, st)
    for s in range(2):
        np.testing.assert_allclose(ghat[s]["w"].numpy(), want["w"].numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(states[s].error["w"].numpy(),
                                   want_st.error["w"].numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# gae
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tau", [0.3, 3.0])
def test_gae_compress_grads_matches_jax_and_bounds_every_block(tau):
    g = {"w": _g(3, (300, 256)), "v": _g(4, (1, 1000))}
    j_out, j_stats = j_gc.gae_compress_grads(_jax_tree(g), tau=tau)
    t_out, t_stats = t_gc.gae_compress_grads(_torch_tree(g), tau=tau)
    # a block's M moves by one where err^2(M) lies within fp32 rounding of
    # tau^2 (the two eigh bases agree to ~1e-6): at most 1 % of the blocks
    n_blocks = j_stats["total_elems"] / 256
    assert abs(float(t_stats["kept_coeffs"]) - float(j_stats["kept_coeffs"])
               ) <= 0.01 * n_blocks
    assert t_stats["total_elems"] == float(j_stats["total_elems"])
    assert int(t_stats["exact_blocks"]) == 0        # no block needed repair
    assert 0.0 < float(t_stats["keep_frac"]) <= 1.0
    for key in g:
        x = np.pad(g[key].reshape(-1), (0, -g[key].size % 256))
        y = np.pad(t_out[key].numpy().reshape(-1), (0, -g[key].size % 256))
        errs = np.linalg.norm((x - y).reshape(-1, 256), axis=1)
        assert errs.max() <= tau * (1 + 1e-4)
        assert t_out[key].shape == g[key].shape


def test_gae_compress_grads_holds_tau_where_the_fp32_selection_cancels():
    """Blocks of norm ~8 against tau 1e-3 (an embedding row's gradient):
    err^2(M) = ||c||^2 - sum c_k^2 + ... cancels in fp32, and the JAX
    package's selection leaves blocks past tau (ROADMAP.md §3, divergence 7,
    open on the JAX side).  The port checks each block's realized error and
    keeps a block past tau exact, so every block is within tau."""
    tau = 1e-3
    g = {"w": 0.5 * _g(6, (64, 256))}
    j_out, _ = j_gc.gae_compress_grads(_jax_tree(g), tau=tau)
    t_out, t_stats = t_gc.gae_compress_grads(_torch_tree(g), tau=tau)
    j_err = np.linalg.norm(g["w"] - np.asarray(j_out["w"]), axis=1)
    t_err = np.linalg.norm(g["w"] - t_out["w"].numpy(), axis=1)
    assert j_err.max() > tau                       # open on the JAX side
    assert t_err.max() <= tau
    n_exact = int(t_stats["exact_blocks"])
    assert n_exact == int(np.sum(t_err == 0)) >= 1
    assert float(t_stats["kept_coeffs"]) >= 256 * n_exact


# ---------------------------------------------------------------------------
# error-bounded compressed checkpoints
# ---------------------------------------------------------------------------

def _lowrank_tree():
    """Trained-net-like weights (low rank + small noise), a small float
    tensor, an int tensor and pure noise (incompressible: stored raw)."""
    rng = np.random.default_rng(0)
    big = (rng.standard_normal((2000, 4)) @ rng.standard_normal((4, 64))
           + 0.01 * rng.standard_normal((2000, 64))).astype(np.float32)
    return {"big": torch.from_numpy(big),
            "noise": torch.from_numpy(_g(5, (64, 64))),
            "small": torch.arange(5, dtype=torch.float32),
            "ints": torch.arange(10, dtype=torch.int32)}


def test_compressed_checkpoint_error_bound(tmp_path):
    path = str(tmp_path / "ck.npz")
    tree = _lowrank_tree()
    tau = 0.5
    stats = t_ckpt.save_compressed(path, tree, tau=tau, bin_size=1e-3,
                                   block=64, min_size=1024, device="cpu")
    back = t_ckpt.restore_compressed(path, device="cpu")
    assert stats["ratio"] > 1.0
    for key in ("ints", "small", "noise"):        # raw: exact
        assert back[key].dtype == tree[key].dtype
        assert torch.equal(back[key], tree[key])
    errs = np.linalg.norm((tree["big"] - back["big"]).numpy().reshape(-1, 64),
                          axis=1)
    assert errs.max() <= tau * (1 + 1e-5)


def test_compressed_checkpoint_of_a_train_state(tmp_path):
    """A TrainState-shaped tree comes back with its NamedTuples, and the
    file holds nothing pickled."""
    from repro_torch.train.loop import TrainState
    from repro_torch.train.optim import AdamState

    big = _lowrank_tree()["big"]
    state = TrainState(params={"w": big}, opt=AdamState(
        step=torch.tensor(3, dtype=torch.int32), mu={"w": big * 0.5},
        nu={"w": big * big}), gc=None, step=torch.tensor(3, dtype=torch.int32))
    path = str(tmp_path / "st.npz")
    t_ckpt.save_compressed(path, state, tau=0.5, bin_size=1e-3, block=64,
                           min_size=1024, device="cpu")
    back = t_ckpt.restore_compressed(path, device="cpu")
    assert type(back) is TrainState and type(back.opt) is AdamState
    assert back.gc is None and int(back.step) == 3
    for got, want in ((back.params["w"], big), (back.opt.nu["w"], big * big)):
        errs = np.linalg.norm((got - want).numpy().reshape(-1, 64), axis=1)
        assert errs.max() <= 0.5 * (1 + 1e-5)
    with np.load(path, allow_pickle=False) as data:
        assert all(data[k].dtype != object for k in data.files)


def test_restore_compressed_refuses_another_file(tmp_path):
    path = str(tmp_path / "x.npz")
    np.savez(path, manifest=np.frombuffer(b'{"format": "other"}', np.uint8))
    with pytest.raises(ValueError, match="not a"):
        t_ckpt.restore_compressed(path, device="cpu")


# ---------------------------------------------------------------------------
# quantize/dequantize at a fine bin (ROADMAP.md §3, known divergence 6)
# ---------------------------------------------------------------------------

def test_quantization_at_a_fine_bin_follows_jax_within_half_bin_and_an_ulp():
    """The falsifying example of ``tests/test_entropy.py::
    test_quantization_error_within_half_bin`` and values with |x| near 100:
    both packages give the same bins and values bit for bit, and the error
    is within bin / 2 plus one fp32 spacing of |x| (the rounding of
    ``q * bin``), which the JAX test's 1e-6 of slack does not cover for
    |x| >= 16."""
    bin_size = 1e-4
    near = np.random.default_rng(0).uniform(96, 100, 12).astype(np.float32)
    x = np.concatenate([[21.65625], near, -near]).astype(np.float32)
    jq = np.asarray(j_quant.quantize(jnp.asarray(x), bin_size))
    jd = np.asarray(j_quant.dequantize(jnp.asarray(jq), bin_size))
    tq = t_quant.quantize(torch.from_numpy(x), bin_size)
    td = t_quant.dequantize(tq, bin_size).numpy()
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(td, jd)
    assert jq[0] == 216562 and td[0] == np.float32(21.656199)
    err = np.abs(td - x)
    assert np.all(err <= bin_size / 2 + np.spacing(np.abs(x)))
    # the example's error is past the JAX test's slack
    assert err[0] > bin_size / 2 + 1e-5 * bin_size + 1e-6


# ---------------------------------------------------------------------------
# the Huffman length cap (ROADMAP.md §3, known divergence 8)
# ---------------------------------------------------------------------------

def test_huffman_book_equals_jax_where_the_jax_cap_finishes():
    from repro.core import entropy as j_entropy
    from repro_torch.core import entropy as t_entropy

    rng = np.random.default_rng(0)
    for values in (np.round(rng.standard_normal(20000) * 30),
                   np.round(rng.standard_normal(200000) * 2000)):
        j_book = j_entropy.build_huffman(values.astype(np.int64))
        t_book = t_entropy.build_huffman(values.astype(np.int64))
        for a, b in zip(j_book, t_book):
            np.testing.assert_array_equal(a, b)


def test_huffman_cap_finishes_where_the_flattening_stops():
    """~30 000 distinct coefficients of a full-width mamba2-370m conv_w
    leaf at bin 1e-4: ceil(f ** 0.9) stops at frequencies up to 6 with
    17-bit codes, where the JAX package's loop never ends; the port's book
    goes flat, keeps every code within 16 bits and round-trips."""
    from repro_torch.core import entropy as t_entropy

    values = np.round(np.random.default_rng(1).standard_normal(700000)
                      * 5000).astype(np.int64)
    freqs = np.unique(values, return_counts=True)[1].astype(np.float64)
    flat = freqs
    for _ in range(100):                     # the JAX package's flattening
        flat = np.ceil(np.power(flat, 0.9))
    assert np.array_equal(np.ceil(np.power(flat, 0.9)), flat)
    assert t_entropy._code_lengths(flat).max() > t_entropy.MAX_CODE_LEN
    stream = t_entropy.huffman_compress(values)
    assert stream.book.lengths.max() <= t_entropy.MAX_CODE_LEN
    np.testing.assert_array_equal(t_entropy.huffman_decompress(stream),
                                  values)
    with pytest.raises(ValueError, match="distinct symbols"):
        t_entropy.build_huffman(np.arange(70000))


def test_compressed_checkpoint_stores_raw_what_a_16_bit_code_cannot_hold(
        tmp_path):
    """Coefficients of ~1e2 at bin 1e-4: more distinct values than 2**16,
    so the tensor is stored raw, exactly."""
    big = torch.from_numpy(100 * _g(7, (400, 256)))
    path = str(tmp_path / "wide.npz")
    stats = t_ckpt.save_compressed(path, {"w": big}, tau=1.0, device="cpu")
    assert stats["compressed_bytes"] == stats["raw_bytes"]
    assert torch.equal(t_ckpt.restore_compressed(path, device="cpu")["w"],
                       big)
