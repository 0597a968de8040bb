"""The port's baselines against the JAX package's, on the CPU.

sz-like and zfp-like are numpy on the port's entropy coder: on the same
field and bound their payloads are the JAX package's byte for byte, and they
decode within the bound (sz-like pointwise, |x - x'| <= eb + 1e-5, the slack
``test_baselines.py`` uses) and to the JAX package's decode exactly.
block_ae trains through the port's Adam: one ``_step`` from the JAX
package's weights matches (the loss at 1e-5 relative, every gradient at
1e-5 of its leaf's largest, the params within the bound of Adam's first
step that ``test_torch_training.py`` states), and the codec round trip
holds.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import block_ae as j_bae
from repro.baselines import szlike as j_sz
from repro.baselines import zfplike as j_zfp
from repro.train import optim as j_opt
from repro_torch.baselines import block_ae as t_bae
from repro_torch.baselines import codec as t_codec
from repro_torch.baselines import szlike as t_sz
from repro_torch.baselines import zfplike as t_zfp
from repro_torch.core.errors import ArchiveError
from repro_torch.data import synthetic
from repro_torch.data.blocks import Normalizer, block_nd, nrmse
from repro_torch.train import optim as t_opt

LR, EPS = 1e-3, 1e-8


@pytest.fixture(scope="module")
def field():
    data = synthetic.e3sm_like(t=24, h=32, w=32, seed=0)
    return Normalizer.fit(data, "zscore").forward(data)


@pytest.mark.parametrize("eb", [0.1, 0.01])
def test_szlike_payload_identical_to_jax_and_within_bound(field, eb):
    t_enc = t_sz.SZLikeCodec().compress(field, eb)
    j_enc = j_sz.SZLikeCodec().compress(field, eb)
    assert t_enc.payload == j_enc.payload
    dec = t_sz.SZLikeCodec().decompress(t_enc)
    assert np.abs(dec - field).max() <= eb + 1e-5
    np.testing.assert_array_equal(dec, j_sz.SZLikeCodec().decompress(j_enc))
    assert t_sz.compress(field, eb)[1] == t_enc.nbytes


@pytest.mark.parametrize("tol", [0.05, 0.01])
def test_zfplike_payload_identical_to_jax(field, tol):
    t_enc = t_zfp.ZFPLikeCodec().compress(field, tol)
    j_enc = j_zfp.ZFPLikeCodec().compress(field, tol)
    assert t_enc.payload == j_enc.payload
    dec = t_zfp.ZFPLikeCodec().decompress(t_enc)
    np.testing.assert_array_equal(dec, j_zfp.ZFPLikeCodec().decompress(j_enc))
    assert nrmse(field, dec) < 0.05


def test_compression_curve_matches_jax(field):
    t_curve = t_codec.compression_curve(t_sz.SZLikeCodec(), field, [0.2, 0.02])
    j_curve = j_sz.compression_curve(field, [0.2, 0.02])
    assert t_curve == j_curve
    assert t_curve[0]["cr"] > t_curve[1]["cr"]


def test_baseline_payloads_refuse_damage(field):
    enc = t_sz.SZLikeCodec().compress(field, 0.1)
    with pytest.raises(ArchiveError):
        t_sz.SZLikeCodec().decompress(t_codec.Encoded(
            codec=enc.codec, payload=b"XXXX" + enc.payload[4:]))
    enc = t_zfp.ZFPLikeCodec().compress(field, 0.1)
    with pytest.raises(ArchiveError):
        t_zfp.ZFPLikeCodec().decompress(t_codec.Encoded(
            codec=enc.codec, payload=enc.payload[:-9]))


def _blocks(field):
    blocks, _ = block_nd(field, (6, 16, 16))
    return blocks


def test_block_ae_one_step_matches_jax(field):
    x = _blocks(field)[:32]
    j_params = jax.device_get(j_bae.block_ae_init(jax.random.PRNGKey(0),
                                                  x.shape[1], 64, 16))
    t_params = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), j_params)
    j_g = jax.jit(jax.grad(j_bae._loss))(jax.tree.map(jnp.asarray, j_params),
                                         jnp.asarray(x))
    leaves = [p.requires_grad_() for p in t_opt.tree_leaves(t_params)]
    t_g = torch.autograd.grad(t_bae._loss(t_params, torch.from_numpy(x)),
                              leaves)
    for a, b in zip(jax.tree.leaves(j_g), t_g):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5 * float(np.abs(a).max()))
    j_o, t_o = j_opt.adam(lr=LR), t_opt.adam(lr=LR)
    j_p = jax.tree.map(jnp.asarray, j_params)
    j_p, _, j_loss = j_bae._step(j_p, j_o.init(j_p), jnp.asarray(x), j_o)
    t_p, _, t_loss = t_bae._step(t_params, t_o.init(t_params),
                                 torch.from_numpy(x), t_o)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    for p0, gj, gt, a, b in zip(jax.tree.leaves(j_params), jax.tree.leaves(j_g),
                                t_g, jax.tree.leaves(j_p),
                                t_opt.tree_leaves(t_p)):
        bound = _adam_first_step_bound(p0, np.asarray(gj), gt.numpy())
        assert np.all(np.abs(b.detach().numpy() - np.asarray(a)) <= bound)


def _adam_first_step_bound(p, gj, gt):
    """``test_torch_training.py``'s bound on two Adam first steps from ``p``
    with gradients ``gj`` and ``gt``."""
    g_min = np.where(np.sign(gj) == np.sign(gt),
                     np.minimum(np.abs(gj), np.abs(gt)), 0.0)
    slope = LR * EPS / (g_min + EPS) ** 2
    return (slope * np.abs(gt.astype(np.float64) - gj)
            + 8 * np.spacing(np.float32(LR)) + 2 * np.spacing(np.abs(p) + LR))


def test_block_ae_trains_and_round_trips(field):
    blocks = _blocks(field)
    base = t_bae.BlockAEBaseline(in_dim=blocks.shape[1], hidden=64, latent=16,
                                 epochs=10, bin_size=0.02, device="cpu")
    base.fit(blocks, seed=0)
    assert not any(p.requires_grad for p in t_opt.tree_leaves(base.params))
    recon, nbytes = base.compress(blocks)
    assert recon.shape == blocks.shape
    assert nbytes < blocks.size * 4
    assert nrmse(blocks, recon) < nrmse(blocks, np.zeros_like(blocks))
    codec = base.codec()
    assert isinstance(codec, t_codec.Codec)
    dec, enc = t_codec.roundtrip(codec, blocks, 0.02)
    np.testing.assert_array_equal(dec, recon)
    unquantized, raw_bytes = base.compress(blocks, quantize_latent=False)
    assert raw_bytes == blocks.shape[0] * 16 * 4
    assert np.abs(unquantized - recon).max() < 1.0
