"""The port's modules against the JAX package's, on the CPU.

Inputs are made with numpy from a seed; JAX parameters come from the JAX
``hbae_init``/``bae_init`` and are carried across with ``params_from_jax``.
Tolerances: 1e-5 for the fp32 model functions (sums in another order);
latents may differ by one bin in at most 0.1 % of entries, where the two
packages' sums land on either side of a half-bin boundary.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention as j_attn
from repro.core import bae as j_bae
from repro.core import exec as j_exec
from repro.core import gae as j_gae
from repro.core import hbae as j_hbae
from repro_torch.core import attention as t_attn
from repro_torch.core import bae as t_bae
from repro_torch.core import exec as t_exec
from repro_torch.core import gae as t_gae
from repro_torch.core import hbae as t_hbae
from repro_torch.core.pipeline import params_from_jax

TOL = dict(atol=1e-5, rtol=1e-5)
K, D, EMB, HIDDEN, LATENT = 2, 96, 32, 64, 16


def _jax_params(heads=1, use_attention=True, n_bae=1, seed=0):
    key = jax.random.PRNGKey(seed)
    kh, *kb = jax.random.split(key, 1 + n_bae)
    hbae = j_hbae.hbae_init(kh, in_dim=D, k=K, emb=EMB, hidden=HIDDEN,
                            latent=LATENT, heads=heads,
                            use_attention=use_attention)
    baes = [j_bae.bae_init(k, in_dim=D, hidden=HIDDEN, latent=8) for k in kb]
    return jax.device_get(hbae), jax.device_get(baes)


def _both(heads=1, use_attention=True, n_bae=1):
    hbae, baes = _jax_params(heads, use_attention, n_bae)
    t_hb, t_bs = params_from_jax(hbae, baes, device="cpu")
    return (hbae, baes), (t_hb, t_bs)


def _x(shape, seed=1, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_params_from_jax_keeps_paths_layouts_and_statics():
    (hbae, _), (t_hb, _) = _both(heads=2)
    assert t_hb["enc"]["fc1"]["w"].shape == (D, HIDDEN)        # (d_in, d_out)
    np.testing.assert_array_equal(t_hb["enc_attn"]["attn"]["wq"]["w"].numpy(),
                                  hbae["enc_attn"]["attn"]["wq"]["w"])
    assert t_hb["meta"] == t_hbae.HbaeMeta(k=K, emb=EMB, use_attention=True)
    assert t_hb["enc_attn"]["attn"]["meta"] == t_attn.AttnMeta(heads=2)


def test_layernorm_matches_jax():
    rng = np.random.default_rng(0)
    p = {"scale": rng.uniform(0.5, 2, D).astype(np.float32),
         "bias": rng.standard_normal(D).astype(np.float32)}
    x = _x((12, D), scale=0.01)           # small residual-like values
    want = j_attn.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x))
    got = t_attn.layernorm({k: _t(v) for k, v in p.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("heads", [1, 2])
def test_self_attention_matches_jax(heads):
    (hbae, _), (t_hb, _) = _both(heads=heads)
    x = _x((6, K, EMB))
    want = j_attn.self_attention(hbae["enc_attn"]["attn"], jnp.asarray(x))
    got = t_attn.self_attention(t_hb["enc_attn"]["attn"], _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_blk = j_attn.attention_block(hbae["dec_attn"], jnp.asarray(x))
    got_blk = t_attn.attention_block(t_hb["dec_attn"], _t(x))
    np.testing.assert_allclose(got_blk.numpy(), np.asarray(want_blk), **TOL)


@pytest.mark.parametrize("use_attention", [True, False])
def test_hbae_encode_decode_match_jax(use_attention):
    (hbae, _), (t_hb, _) = _both(use_attention=use_attention)
    x = _x((8, K, D))
    lat = j_hbae.hbae_encode(hbae, jnp.asarray(x))
    np.testing.assert_allclose(t_hbae.hbae_encode(t_hb, _t(x)).numpy(),
                               np.asarray(lat), **TOL)
    y = j_hbae.hbae_decode(hbae, lat)
    np.testing.assert_allclose(t_hbae.hbae_decode(t_hb, _t(lat)).numpy(),
                               np.asarray(y), **TOL)


def test_bae_encode_decode_match_jax():
    (_, baes), (_, t_bs) = _both()
    r = _x((16, D), scale=0.05)
    lb = j_bae.bae_encode(baes[0], jnp.asarray(r))
    np.testing.assert_allclose(t_bae.bae_encode(t_bs[0], _t(r)).numpy(),
                               np.asarray(lb), **TOL)
    np.testing.assert_allclose(
        t_bae.bae_decode(t_bs[0], _t(lb)).numpy(),
        np.asarray(j_bae.bae_decode(baes[0], lb)), **TOL)


@pytest.mark.parametrize("n_bae", [1, 2])
def test_encode_frontend_latents_match_jax(n_bae):
    (hbae, baes), (t_hb, t_bs) = _both(n_bae=n_bae)
    x = _x((64, K, D))
    hb_bin, bae_bin = 0.01, 0.01
    j_lh, j_lbs = j_exec._encode_frontend(hbae, baes, jnp.asarray(x),
                                          hb_bin, bae_bin)
    t_lh, t_lbs = t_exec._encode_frontend(t_hb, t_bs, _t(x), hb_bin, bae_bin)
    for got, want in zip([t_lh] + t_lbs, [j_lh] + list(j_lbs)):
        got, want = got.numpy(), np.asarray(want)
        assert got.dtype == np.int32 and got.shape == want.shape
        diff = np.abs(got.astype(np.int64) - want)
        assert diff.max() <= 1
        assert np.count_nonzero(diff) <= int(0.001 * diff.size)
    # the decode back-end reproduces the JAX reconstruction from the same
    # latents
    q_lh, q_lbs = np.asarray(j_lh), [np.asarray(q) for q in j_lbs]
    want = j_exec._decode_backend(hbae, baes, jnp.asarray(q_lh),
                                  [jnp.asarray(q) for q in q_lbs], hb_bin,
                                  bae_bin)
    got = t_exec.run_decompress_stage(t_hb, t_bs, q_lh, q_lbs, hb_bin, bae_bin)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert got.flags.writeable


def _gae_setup(n=64, d=80, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x_r = x + 0.3 * rng.standard_normal((n, d)).astype(np.float32)
    basis = np.asarray(j_gae.fit_pca_basis(jnp.asarray(x - x_r)))
    return x, x_r, basis


def test_fit_pca_basis_matches_jax_up_to_sign():
    # a spectrum with well-separated eigenvalues, so each eigenvector is
    # defined up to its sign
    rng = np.random.default_rng(0)
    r = (rng.standard_normal((2000, 80)) * 0.9 ** np.arange(80)
         ).astype(np.float32)
    basis = np.asarray(j_gae.fit_pca_basis(jnp.asarray(r)))
    got = t_gae.fit_pca_basis(_t(r)).numpy()
    # eigenvector signs are arbitrary: compare |U_j . V_j| per column
    np.testing.assert_allclose(np.abs(np.sum(got * basis, axis=0)), 1.0,
                               atol=1e-4)


@pytest.mark.parametrize("tau", [0.8, 1.5])
def test_gae_select_matches_select_host_and_jax(tau):
    x, x_r, basis = _gae_setup()
    bin_size = 0.01
    got = t_gae.gae_select(_t(x - x_r), _t(basis), tau, bin_size)
    host = t_gae.select_host(x - x_r, basis, tau, bin_size)
    jsel = jax.device_get(j_gae.gae_select(jnp.asarray(x - x_r),
                                           jnp.asarray(basis), tau, bin_size))
    for want in (host, jsel):
        np.testing.assert_array_equal(got.m.numpy(), np.asarray(want.m))
        np.testing.assert_array_equal(got.ok.numpy(), np.asarray(want.ok))
        np.testing.assert_array_equal(got.q_sorted.numpy(),
                                      np.asarray(want.q_sorted))
        np.testing.assert_allclose(got.err.numpy(), np.asarray(want.err),
                                   atol=1e-5, rtol=1e-5)
    assert 0 < int(got.m.min()) and int(got.m.max()) < x.shape[1]


def test_gae_encode_blocks_matches_reference_loop():
    x, x_r, basis = _gae_setup()
    tau, bin_size = 0.8, 0.01
    out, codes = t_gae.gae_encode_blocks(x, x_r, basis, tau, bin_size,
                                         device="cpu")
    ref_out, ref_ms = t_gae.gae_reference_loop(x, x_r, basis, tau, bin_size)
    _, j_codes = j_gae.gae_encode_blocks(x, x_r, basis, tau, bin_size)
    assert [c.m for c in codes] == ref_ms == [c.m for c in j_codes]
    np.testing.assert_allclose(out, ref_out, atol=1e-4)
    assert np.linalg.norm(x - out, axis=1).max() <= tau
    for c, jc in zip(codes, j_codes):
        np.testing.assert_array_equal(c.indices, jc.indices)
        np.testing.assert_array_equal(c.qcoeffs, jc.qcoeffs)
        assert c.bin_exp == jc.bin_exp
    dec = t_gae.gae_decode_blocks(x_r, basis, codes, bin_size)
    np.testing.assert_allclose(dec, out, atol=1e-5)


def test_gae_encode_blocks_coarse_bin_fallback():
    x, x_r, basis = _gae_setup()
    tau = 0.05
    out, codes = t_gae.gae_encode_blocks(x, x_r, basis, tau, bin_size=10.0,
                                         device="cpu")
    assert np.linalg.norm(x - out, axis=1).max() <= tau
    assert any(c.bin_exp > 0 for c in codes)
