"""The port's training against the JAX package's, on the CPU.

Inputs are made with numpy from a seed; weights come from the JAX
``hbae_init``/``bae_init`` and are carried across with ``params_from_jax``.
Tolerances, each stated where it is used:

* optimizers and schedules, 5 updates in fp32 on the same trees: 1e-6
  relative and 1e-9 absolute (elementwise arithmetic, one rounding apart);
* the backward of block_attention, flash_attention and ssd_scan: 1e-5 of the
  largest gradient (fp32 sums in another order);
* one HBAE or BAE step: the loss at 1e-5 relative, every gradient at 1e-5 of
  that leaf's largest gradient.  Adam's first update is
  lr * g / (|g| + eps), whose slope in g is lr * eps / (|g| + eps)^2, so
  each param after the step is held to the JAX package's within that slope
  times the two packages' gradient difference for that entry (taken at the
  smaller |g|, or at 0 where the signs differ), plus 8 ulps of lr and 2 ulps
  of the param for the roundings (``_adam_first_step_bound``);
* twenty steps of the ``_minibatches`` order: every loss within 1e-4
  relative;
* ``fit`` end to end, each package from its own seeded init: both models
  within tau, the port's loss falling, the port's compression ratio within
  ``FIT_RATIO_BAND`` (25 %) of the JAX package's.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bae as j_bae
from repro.core import hbae as j_hbae
from repro.core import training as j_tr
from repro.core.options import CompressOptions as JOptions
from repro.core.pipeline import CompressorConfig as JConfig
from repro.core.pipeline import HierarchicalCompressor as JCompressor
from repro.kernels.block_attention.ref import block_attention_ref
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.kernels.ssd_scan.ref import ssd_scan_ref
from repro.runtime import archive_io as j_io
from repro.train import optim as j_opt
from repro_torch.core import training as t_tr
from repro_torch.core.options import CompressOptions as TOptions
from repro_torch.core.pipeline import CompressorConfig as TConfig
from repro_torch.core.pipeline import HierarchicalCompressor as TCompressor
from repro_torch.core.pipeline import params_from_jax
from repro_torch.data import blocks as blocks_mod
from repro_torch.data import synthetic
from repro_torch.kernels.block_attention import ops as t_ba
from repro_torch.kernels.flash_attention import ops as t_fa
from repro_torch.kernels.ssd_scan import ops as t_sd
from repro_torch.runtime import archive_io as t_io
from repro_torch.train import optim as t_opt

K, D, EMB, HIDDEN, LATENT = 4, 96, 32, 64, 16
OPT_TOL = dict(rtol=1e-6, atol=1e-9)
LR, EPS = 1e-3, 1e-8
TRAJ_RTOL = 1e-4
FIT_RATIO_BAND = 0.25


def _x(shape, seed=1, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _t_leaves(tree):
    return [x.detach().float().numpy() for x in t_opt.tree_leaves(tree)]


def _jax_hbae(seed=0):
    return jax.device_get(j_hbae.hbae_init(
        jax.random.PRNGKey(seed), in_dim=D, k=K, emb=EMB, hidden=HIDDEN,
        latent=LATENT))


def _jax_bae(seed=0):
    return jax.device_get(j_bae.bae_init(jax.random.PRNGKey(seed), in_dim=D,
                                         hidden=HIDDEN, latent=8))


def _port(hbae=None, bae=None):
    t_hb, t_bs = params_from_jax(hbae if hbae is not None else {},
                                 [bae] if bae is not None else [],
                                 device="cpu")
    return t_hb if hbae is not None else t_bs[0]


# ---------------------------------------------------------------------------
# optim
# ---------------------------------------------------------------------------

def test_tree_leaves_follow_jax_order_and_keep_statics():
    hbae = _jax_hbae()
    t_hb = _port(hbae=hbae)
    assert [x.shape for x in _np_leaves(hbae)] == \
        [tuple(x.shape) for x in t_opt.tree_leaves(t_hb)]
    for a, b in zip(_np_leaves(hbae), _t_leaves(t_hb)):
        np.testing.assert_array_equal(a, b)
    zeros = t_opt.tree_zeros_like(t_hb)
    assert zeros["meta"] is t_hb["meta"]
    assert zeros["enc_attn"]["attn"]["meta"] is t_hb["enc_attn"]["attn"]["meta"]


OPTIMIZERS = {
    "adam": lambda m: m.adam(lr=1e-3),
    "adamw": lambda m: m.adamw(lr=1e-3, weight_decay=0.01),
    "adamw_clip": lambda m: m.adamw(lr=2e-3, max_grad_norm=0.5),
    "adam_warmup_cosine": lambda m: m.adam(
        lr=m.warmup_cosine_schedule(1e-3, 2, 5)),
    "sgd": lambda m: m.sgd(lr=1e-2),
    "sgd_momentum_clip": lambda m: m.sgd(
        lr=m.linear_decay_schedule(1e-2, 5), momentum=0.9, max_grad_norm=0.1),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_jax_over_five_updates(name):
    hbae = _jax_hbae()
    j_params, t_params = hbae, _port(hbae=hbae)
    j_o, t_o = OPTIMIZERS[name](j_opt), OPTIMIZERS[name](t_opt)
    j_state, t_state = j_o.init(j_params), t_o.init(t_params)
    shapes = [x.shape for x in _np_leaves(hbae)]
    for i in range(5):
        gs = [_x(s, seed=10 + i, scale=0.05) for s in shapes]
        j_g = jax.tree.unflatten(jax.tree.structure(hbae),
                                 [jnp.asarray(g) for g in gs])
        t_g = t_opt.tree_unflatten(t_params, [torch.from_numpy(g) for g in gs])
        j_params, j_state, j_stats = j_o.update(j_g, j_state, j_params)
        t_params, t_state, t_stats = t_o.update(t_g, t_state, t_params)
        for a, b in zip(_np_leaves(j_params), _t_leaves(t_params)):
            np.testing.assert_allclose(b, a, **OPT_TOL)
        for key in j_stats:
            np.testing.assert_allclose(float(t_stats[key]),
                                       float(j_stats[key]), **OPT_TOL)
    assert int(t_state.step) == int(j_state.step) == 5
    for a, b in zip(_np_leaves(j_state.mu), _t_leaves(t_state.mu)):
        np.testing.assert_allclose(b, a, **OPT_TOL)


def test_clip_by_global_norm_matches_jax():
    hbae = _jax_hbae()
    for max_norm in (1e-3, 1e3):
        j_c, j_n = j_opt.clip_by_global_norm(hbae, max_norm)
        t_c, t_n = t_opt.clip_by_global_norm(_port(hbae=hbae), max_norm)
        np.testing.assert_allclose(float(t_n), float(j_n), **OPT_TOL)
        for a, b in zip(_np_leaves(j_c), _t_leaves(t_c)):
            np.testing.assert_allclose(b, a, **OPT_TOL)
    assert float(t_opt.global_norm({})) == float(j_opt.global_norm({})) == 0.0


@pytest.mark.parametrize("name,args", [
    ("constant_schedule", (3e-4,)),
    ("warmup_cosine_schedule", (1e-3, 5, 20)),
    ("warmup_cosine_schedule", (1e-3, 0, 10, 0.2)),
    ("linear_decay_schedule", (1e-3, 20))])
def test_schedules_match_jax(name, args):
    j_s, t_s = getattr(j_opt, name)(*args), getattr(t_opt, name)(*args)
    for step in range(25):
        got = t_s(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(j_s(jnp.int32(step))),
                                   **OPT_TOL)


# ---------------------------------------------------------------------------
# backward of the kernels' plain versions
# ---------------------------------------------------------------------------

def _grad_close(got, want, frac=1e-5):
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0,
                                   atol=frac * scale)


@pytest.mark.parametrize("b,n,d,heads", [(4, 10, 32, 1), (3, 8, 32, 4)])
def test_block_attention_backward_matches_jax_and_autograd(b, n, d, heads):
    q, k, v, w = (_x((b, n, d), seed=s) for s in range(4))
    j_grads = jax.grad(lambda q, k, v: jnp.sum(
        block_attention_ref(q, k, v, heads=heads) * w), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    t_auto = torch.autograd.grad(
        torch.sum(t_ba.block_attention_plain(tq, tk, tv, heads)
                  * torch.from_numpy(w)), (tq, tk, tv))
    got = t_ba.block_attention_backward_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), heads,
        torch.from_numpy(w))
    got = [g.numpy() for g in got]
    _grad_close(got, [np.asarray(g) for g in j_grads])
    _grad_close(got, [g.numpy() for g in t_auto])


@pytest.mark.parametrize("s,t,window", [(16, 16, 0), (16, 16, 4), (8, 16, 0)])
def test_flash_attention_backward_matches_jax(s, t, window):
    q = _x((1, s, 4, 16), seed=0)
    k, v = _x((1, t, 2, 16), seed=1), _x((1, t, 2, 16), seed=2)
    w = _x((1, s, 4, 16), seed=3)
    j_grads = jax.grad(lambda q, k, v: jnp.sum(flash_attention_ref(
        q, k, v, causal=True, window=window) * w), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = t_fa.flash_attention_backward_plain(
        *(torch.from_numpy(a) for a in (q, k, v, w)), causal=True,
        window=window)
    _grad_close([g.numpy() for g in got], [np.asarray(g) for g in j_grads])


def test_flash_attention_backward_drops_rows_no_key_reaches():
    q, w = _x((1, 8, 2, 16), seed=0), _x((1, 8, 2, 16), seed=3)
    k, v = _x((1, 4, 2, 16), seed=1), _x((1, 4, 2, 16), seed=2)
    got = t_fa.flash_attention_backward_plain(
        *(torch.from_numpy(a) for a in (q, k, v, w)), causal=True)
    w[:, :4] = 0            # the kernel's forward gives those rows zeros
    want = t_fa.flash_attention_backward_plain(
        *(torch.from_numpy(a) for a in (q, k, v, w)), causal=True)
    for g, h in zip(got, want):
        torch.testing.assert_close(g, h, rtol=0, atol=0)
    assert not got[0][:, :4].any()


def test_ssd_backward_matches_jax():
    x = _x((1, 64, 2, 8), seed=0)
    dt = np.log1p(np.exp(_x((1, 64, 2), seed=1)))
    a_log = np.random.default_rng(2).random(2).astype(np.float32)
    b, c = _x((1, 64, 1, 8), seed=3), _x((1, 64, 1, 8), seed=4)
    wy, ws = _x((1, 64, 2, 8), seed=5), _x((1, 2, 8, 8), seed=6)

    def loss(*ins):
        y, state = ssd_scan_ref(*ins, chunk=16)
        return jnp.sum(y * wy) + jnp.sum(state * ws)

    ins = (x, dt, a_log, b, c)
    j_grads = jax.grad(loss, argnums=tuple(range(5)))(
        *(jnp.asarray(a) for a in ins))
    got = t_sd.ssd_backward_plain(
        *(torch.from_numpy(a) for a in ins), torch.from_numpy(wy),
        torch.from_numpy(ws), chunk=16)
    _grad_close([g.numpy() for g in got], [np.asarray(g) for g in j_grads])


def test_ssd_backward_finite_where_the_chunk_decay_overflows():
    """At chunk 256 with dt ~ softplus(N(0, 1)) the chunk's cumsum reaches
    about -300; above the diagonal exp(cum_s - cum_t) overflows.  ref.py's
    where-after-exp then gives nan gradients; the plain version masks
    before the exp and gives finite ones, with the same forward values."""
    x = _x((1, 256, 2, 8), seed=0)
    dt = np.log1p(np.exp(_x((1, 256, 2), seed=1)))
    a_log = np.random.default_rng(2).random(2).astype(np.float32)
    b, c = _x((1, 256, 1, 8), seed=3), _x((1, 256, 1, 8), seed=4)
    ins = [torch.from_numpy(a) for a in (x, dt, a_log, b, c)]
    y, state = t_sd.ssd_plain(*ins, chunk=256)
    j_ins = [jnp.asarray(a) for a in (x, dt, a_log, b, c)]
    # the forward at test_torch_lm_kernels.py's SSD tolerance, 3e-4
    for got, want in zip((y, state), ssd_scan_ref(*j_ins, chunk=256)):
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                                   atol=3e-4 * scale)
    got = t_sd.ssd_backward_plain(*ins, torch.ones_like(y),
                                  torch.ones_like(state), chunk=256)
    assert all(torch.isfinite(g).all() for g in got)
    j_grad = jax.grad(lambda dt: jnp.sum(ssd_scan_ref(
        j_ins[0], dt, *j_ins[2:], chunk=256)[0]))(j_ins[1])
    assert np.isnan(np.asarray(j_grad)).any()      # open on the JAX side


# ---------------------------------------------------------------------------
# the training steps
# ---------------------------------------------------------------------------

STEPS = {
    "hbae": (_jax_hbae, j_tr.hbae_loss, j_tr._hbae_step, t_tr.hbae_loss,
             t_tr._hbae_step, (8, K, D)),
    "bae": (_jax_bae, j_tr.bae_loss, j_tr._bae_step, t_tr.bae_loss,
            t_tr._bae_step, (32, D)),
}


def _port_params(which, tree):
    return _port(hbae=tree) if which == "hbae" else _port(bae=tree)


@pytest.mark.parametrize("which", sorted(STEPS))
def test_one_step_matches_jax(which):
    init, j_loss, j_step, t_loss, t_step, shape = STEPS[which]
    tree, x = init(), _x(shape, seed=7)
    # jitted, as inside the JAX step: a tiny gradient entry differs between
    # XLA's fused and op-by-op programs, and Adam's update magnifies it
    j_l, j_g = jax.jit(jax.value_and_grad(j_loss))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    t_params = _port_params(which, tree)
    t_l, t_g = t_tr._value_and_grad(t_loss, t_params, torch.from_numpy(x))
    np.testing.assert_allclose(float(t_l), float(j_l), rtol=1e-5)
    for a, b in zip(_np_leaves(j_g), _t_leaves(t_g)):
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-5 * float(np.abs(a).max()))

    j_o, t_o = j_opt.adam(lr=LR), t_opt.adam(lr=LR)
    j_p = jax.tree.map(jnp.asarray, tree)
    j_p, _, j_l2 = j_step(j_p, j_o.init(j_p), jnp.asarray(x), j_o)
    t_p, t_state, t_l2 = t_step(t_params, t_o.init(t_params),
                                torch.from_numpy(x), t_o)
    np.testing.assert_allclose(float(t_l2), float(j_l2), rtol=1e-5)
    assert int(t_state.step) == 1
    for before, gj, gt, a, b in zip(_np_leaves(tree), _np_leaves(j_g),
                                    _t_leaves(t_g), _np_leaves(j_p),
                                    _t_leaves(t_p)):
        assert np.all(np.abs(b - a) <= _adam_first_step_bound(before, gj, gt))
        assert np.abs(b - before).max() <= LR * (1 + 1e-6)      # at most lr


def _adam_first_step_bound(p, gj, gt):
    """How far two Adam first steps from the same param ``p`` may land
    apart, given the two gradients ``gj`` and ``gt``: the update
    lr * g / (|g| + eps) changes by at most lr * eps / (|g| + eps)^2 per unit
    of g between them, plus the roundings of the update and of the param."""
    g_min = np.where(np.sign(gj) == np.sign(gt),
                     np.minimum(np.abs(gj), np.abs(gt)), 0.0)
    slope = LR * EPS / (g_min + EPS) ** 2
    return (slope * np.abs(gt.astype(np.float64) - gj)
            + 8 * np.spacing(np.float32(LR)) + 2 * np.spacing(np.abs(p) + LR))


@pytest.mark.parametrize("which", sorted(STEPS))
def test_twenty_steps_follow_jax_loss(which):
    init, _, j_step, _, t_step, shape = STEPS[which]
    tree = init()
    data = _x((shape[0] * 5,) + shape[1:], seed=9)
    j_o, t_o = j_opt.adam(lr=LR), t_opt.adam(lr=LR)
    j_p = jax.tree.map(jnp.asarray, tree)
    j_s = j_o.init(j_p)
    t_p = _port_params(which, tree)
    t_s = t_o.init(t_p)
    j_batches = list(j_tr._minibatches(np.random.default_rng(3), len(data),
                                       shape[0], 4))
    t_batches = list(t_tr._minibatches(np.random.default_rng(3), len(data),
                                       shape[0], 4))
    assert len(t_batches) == 20
    j_losses, t_losses = [], []
    for jb, tb in zip(j_batches, t_batches):
        np.testing.assert_array_equal(jb, tb)
        j_p, j_s, j_l = j_step(j_p, j_s, jnp.asarray(data[jb]), j_o)
        t_p, t_s, t_l = t_step(t_p, t_s, torch.from_numpy(data[tb]), t_o)
        j_losses.append(float(j_l))
        t_losses.append(float(t_l))
    np.testing.assert_allclose(t_losses, j_losses, rtol=TRAJ_RTOL)
    assert t_losses[-1] < t_losses[0]


# ---------------------------------------------------------------------------
# fit end to end (the tiny configuration of test_torch_pipeline.py)
# ---------------------------------------------------------------------------

TAU = 0.25
D_GAE = 80
CFG = dict(k=2, emb=32, hidden=64, hb_latent=16, bae_latent=8,
           gae_block_elems=D_GAE, hb_bin=0.01, bae_bin=0.01, gae_bin=0.02)


@pytest.fixture(scope="module")
def fitted():
    data = synthetic.s3d_like(n_species=8, t=10, h=16, w=16, seed=0)
    data = blocks_mod.Normalizer.fit(data, mode="range", axis=0).forward(data)
    blocks, _ = blocks_mod.block_nd(data, (8, 5, 4, 4))
    hb = blocks_mod.group_hyperblocks(blocks, k=2)
    d = hb.shape[2]
    jc = JCompressor(JConfig(block_elems=d, **CFG)).fit(hb, seed=0)
    j_arch = jc.compress(hb, options=JOptions(tau=TAU, chunk_hyperblocks=4))
    logs = []
    tc = TCompressor(TConfig(block_elems=d, **CFG), device="cpu").fit(
        hb, seed=0, log=lambda s, l: logs.append((s, l)))
    t_arch = tc.compress(hb, options=TOptions(tau=TAU, chunk_hyperblocks=4))
    return hb, jc, j_arch, tc, t_arch, logs


def _gae_errs(hb, recon):
    return np.linalg.norm((hb - recon).reshape(-1, D_GAE), axis=1)


def test_fit_both_within_tau_and_port_loss_falls(fitted):
    hb, jc, j_arch, tc, t_arch, logs = fitted
    assert _gae_errs(hb, jc.decompress(j_arch)).max() <= TAU + 1e-4
    assert _gae_errs(hb, tc.decompress(t_arch)).max() <= TAU + 1e-4
    # 30 HBAE steps (one a epoch), then 30 BAE steps: each logs step 0
    assert [s for s, _ in logs] == [0, 0]
    for p in t_opt.tree_leaves([tc.hbae_params, tc.bae_params]):
        assert not p.requires_grad
    with torch.no_grad():
        x = torch.from_numpy(hb)
        last = float(t_tr.hbae_loss(tc.hbae_params, x))
    assert last < logs[0][1]


def test_fit_ratio_within_band_of_jax(fitted):
    _, _, j_arch, _, t_arch, _ = fitted
    j_ratio, t_ratio = j_arch.compression_ratio(), t_arch.compression_ratio()
    assert abs(t_ratio / j_ratio - 1) <= FIT_RATIO_BAND, (t_ratio, j_ratio)


def test_port_fitted_model_decodes_in_jax(fitted, tmp_path):
    hb, _, _, tc, t_arch, _ = fitted
    tc.save(str(tmp_path / "t.npz"))
    jc = JCompressor.load(str(tmp_path / "t.npz"))
    recon = jc.decompress(j_io.deserialize_archive(
        t_io.serialize_archive(t_arch)))
    assert _gae_errs(hb, recon).max() <= TAU + 1e-4
