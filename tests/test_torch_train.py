"""The port's LM training against the JAX package's, on the CPU.

For the reduced configs of qwen2-1.5b (dense, GQA) and mamba2-370m (SSD), the
JAX params and ``TrainState`` are carried across (``params_from_jax``,
``train_state_from_jax``) and the same numpy-made batches go through both
packages.  Tolerances, each stated where it is used:

* ``train_loss``, dense and chunked: 3e-5 relative, as
  ``tests/test_archs.py::test_chunked_ce_matches_dense`` holds the JAX
  package's own chunked loss to its dense one;
* gradients: 1e-5 of each leaf's largest (fp32 sums in another order), as
  ``tests/test_torch_training.py`` holds them;
* one AdamW step (warmup-cosine lr, clipping at 1.0, weight decay 0.01):
  the loss at 1e-5 relative, every param within Adam's first-step bound of
  the JAX package's (``_adam_first_step_bound``, the bound of
  ``tests/test_torch_training.py`` taken at the step's learning rate and
  the clipped gradients);
* five steps: every loss within 1e-4 relative (``TRAJ_RTOL`` of
  ``tests/test_torch_training.py``), every param within 1 % of the summed
  learning rate of the JAX package's (``FIVE_STEP_ATOL``, reasoned there);
* ``microbatches=2`` against one batch: the loss at 1e-6 relative, the
  gradients at 1e-5 of each leaf's largest.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import RunConfig as JRunConfig
from repro.models import registry as j_registry
from repro.train import loop as j_loop
from repro.train import optim as j_opt
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.models import registry
from repro_torch.train import loop
from repro_torch.train import optim as t_opt

ARCHS = ["qwen2-1.5b", "mamba2-370m"]
LOSS_RTOL = 3e-5
GRAD_FRAC = 1e-5
TRAJ_RTOL = 1e-4
PEAK_LR, WARMUP, TOTAL, EPS = 1e-3, 2, 5, 1e-8
B, S = 4, 32


@dataclasses.dataclass
class Pair:
    arch: str
    cfg: object
    jcfg: object
    jparams: dict


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg = j_registry.reduced_config(j_get_config(arch))
    cfg = registry.reduced_config(get_config(arch))
    jparams = jax.device_get(j_registry.get_model(jcfg).init_params(
        jax.random.PRNGKey(0), jcfg, JRunConfig()))
    return Pair(arch, cfg, jcfg, jparams)


def _batch(cfg, seed=0, b=B, s=S):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (b, s + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leaves_j(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _leaves_t(tree):
    return [x.detach().numpy() for x in t_opt.tree_leaves(tree)]


# ---------------------------------------------------------------------------
# train_loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ce_chunk,scan_layers", [(0, True), (8, True),
                                                  (8, False)])
def test_train_loss_matches_jax(pair, ce_chunk, scan_layers):
    batch = _batch(pair.cfg)
    jrun = JRunConfig(ce_chunk=ce_chunk, scan_layers=scan_layers)
    run = RunConfig(ce_chunk=ce_chunk, scan_layers=scan_layers)
    want = j_registry.get_model(pair.jcfg).train_loss(
        jax.tree.map(jnp.asarray, pair.jparams), pair.jcfg, jrun, _j(batch))
    got = registry.get_model(pair.cfg).train_loss(
        registry.params_from_jax(pair.jparams, "cpu"), pair.cfg, run,
        _t(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def test_chunked_loss_equals_dense_with_its_gradients(pair):
    batch = _t(_batch(pair.cfg, seed=1))
    params = registry.params_from_jax(pair.jparams, "cpu")
    dense = loop.value_and_grad(pair.cfg, RunConfig())(params, batch)
    chunked = loop.value_and_grad(pair.cfg, RunConfig(ce_chunk=8))(params,
                                                                  batch)
    np.testing.assert_allclose(float(chunked[0]), float(dense[0]),
                               rtol=LOSS_RTOL)
    for a, b in zip(_leaves_t(dense[1]), _leaves_t(chunked[1])):
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=GRAD_FRAC * np.abs(a).max())


def test_cross_entropy_masks_padding_labels():
    from repro.models.common import cross_entropy_loss as j_ce
    from repro_torch.models.common import chunked_ce_loss, cross_entropy_loss

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 16)).astype(np.float32)
    w = rng.standard_normal((16, 40)).astype(np.float32)
    labels = rng.integers(0, 32, (2, 8)).astype(np.int32)
    labels[0, :3] = 35                    # padding ids >= vocab are masked
    labels[1, 5] = -1
    want = j_ce(jnp.asarray(x @ w), jnp.asarray(labels), 32)
    got = cross_entropy_loss(torch.from_numpy(x @ w),
                             torch.from_numpy(labels), 32)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    chunked = chunked_ce_loss(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(labels), 32, chunk=4)
    np.testing.assert_allclose(float(chunked), float(want), rtol=LOSS_RTOL)
    with pytest.raises(ValueError, match="multiple"):
        chunked_ce_loss(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(labels), 32, chunk=3)


def test_forward_returns_hidden_states(pair):
    batch = _batch(pair.cfg)
    jout = j_registry.get_model(pair.jcfg).forward(
        jax.tree.map(jnp.asarray, pair.jparams), pair.jcfg, JRunConfig(),
        jnp.asarray(batch["tokens"]), return_hidden=True)
    out = registry.get_model(pair.cfg).forward(
        registry.params_from_jax(pair.jparams, "cpu"), pair.cfg, RunConfig(),
        torch.from_numpy(batch["tokens"]), return_hidden=True)
    assert tuple(out.shape) == (B, S, pair.cfg.d_model)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-4,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _optimizers():
    def make(m):
        return m.adamw(m.warmup_cosine_schedule(PEAK_LR, WARMUP, TOTAL),
                       weight_decay=0.01, max_grad_norm=1.0)
    return make(j_opt), make(t_opt)


def _states(pair, mode="none"):
    jrun = JRunConfig(gradient_compression=mode)
    run = RunConfig(gradient_compression=mode)
    j_o, t_o = _optimizers()
    j_state = j_loop.init_train_state(jax.random.PRNGKey(0), pair.jcfg, jrun,
                                      j_o)
    t_state = registry.train_state_from_jax(jax.device_get(j_state), "cpu")
    return jrun, run, j_o, t_o, j_state, t_state


def _clipped(grads):
    """Each leaf of ``grads`` (numpy) scaled as ``clip_by_global_norm(1.0)``
    scales it."""
    norm = np.sqrt(sum(np.sum(np.square(g.astype(np.float64))) for g in grads))
    return [g * min(1.0, 1.0 / (norm + 1e-12)) for g in grads]


def _adam_first_step_bound(p, gj, gt, lr):
    """How far two Adam first steps from the same param ``p`` may land
    apart, given the two gradients ``gj`` and ``gt``: the update
    lr * g / (|g| + eps) changes by at most lr * eps / (|g| + eps)^2 per unit
    of g between them, plus the roundings of the update and of the param."""
    g_min = np.where(np.sign(gj) == np.sign(gt),
                     np.minimum(np.abs(gj), np.abs(gt)), 0.0)
    slope = lr * EPS / (g_min + EPS) ** 2
    return (slope * np.abs(gt.astype(np.float64) - gj)
            + 8 * np.spacing(np.float32(lr)) + 2 * np.spacing(np.abs(p) + lr))


def test_state_carries_across_from_jax(pair):
    _, _, _, _, j_state, t_state = _states(pair, "pca_ef")
    for a, b in zip(jax.tree.leaves(jax.device_get(j_state)),
                    t_opt.tree_leaves(list(t_state))):
        assert b.shape == a.shape and str(b.dtype)[6:] == str(a.dtype)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert t_state.gc.basis.shape == (256, 32)


def test_one_step_matches_jax(pair):
    jrun, run, j_o, t_o, j_state, t_state = _states(pair)
    batch = _batch(pair.cfg, seed=2)
    j_new, j_m = jax.jit(j_loop.make_train_step(pair.jcfg, jrun, j_o))(
        j_state, _j(batch))
    before = _leaves_t(t_state.params)
    t_new, t_m = loop.make_train_step(pair.cfg, run, t_o)(t_state, batch)
    np.testing.assert_allclose(float(t_m["loss"]), float(j_m["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(t_m["grad_norm"]),
                               float(j_m["grad_norm"]), rtol=1e-5)
    assert int(t_new.step) == int(t_new.opt.step) == 1
    # the state the step was given is untouched
    for a, b in zip(before, _leaves_t(t_state.params)):
        np.testing.assert_array_equal(a, b)

    # the gradients, and the params within Adam's first-step bound
    j_l, j_g = jax.jit(jax.value_and_grad(
        lambda p: j_registry.get_model(pair.jcfg).train_loss(
            p, pair.jcfg, jrun, _j(batch))))(j_state.params)
    t_l, t_g = loop.value_and_grad(pair.cfg, run)(t_state.params, _t(batch))
    gj, gt = _leaves_j(j_g), _leaves_t(t_g)
    for a, b in zip(gj, gt):
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=GRAD_FRAC * np.abs(a).max())
    lr = float(t_opt.warmup_cosine_schedule(PEAK_LR, WARMUP, TOTAL)(1))
    for p, a, b, cj, ct in zip(before, _leaves_j(j_new.params),
                               _leaves_t(t_new.params), _clipped(gj),
                               _clipped(gt)):
        assert np.all(np.abs(b - a) <= _adam_first_step_bound(p, cj, ct, lr))


# five steps: Adam moves a param by about lr a step whatever |g| is, and
# where |g| is as small as the two packages' gradient difference (1e-5 of
# the leaf's largest) the two directions can part; each param is held to 1 %
# of the five steps' summed learning rate (2.7e-5; the largest difference
# measured on these configs is 1.14e-5), each first moment to 1e-4 of its
# leaf's largest
FIVE_STEP_ATOL = 0.01 * sum(
    float(t_opt.warmup_cosine_schedule(PEAK_LR, WARMUP, TOTAL)(i))
    for i in range(1, 6))


def test_five_steps_follow_jax(pair):
    jrun, run, j_o, t_o, j_state, t_state = _states(pair)
    j_step = jax.jit(j_loop.make_train_step(pair.jcfg, jrun, j_o))
    t_step = loop.make_train_step(pair.cfg, run, t_o)
    j_losses, t_losses = [], []
    for i in range(5):
        batch = _batch(pair.cfg, seed=10 + i)
        j_state, j_m = j_step(j_state, _j(batch))
        t_state, t_m = t_step(t_state, batch)
        j_losses.append(float(j_m["loss"]))
        t_losses.append(float(t_m["loss"]))
    np.testing.assert_allclose(t_losses, j_losses, rtol=TRAJ_RTOL)
    for a, b in zip(_leaves_j(j_state.params), _leaves_t(t_state.params)):
        np.testing.assert_allclose(b, a, rtol=0, atol=FIVE_STEP_ATOL)
    for a, b in zip(_leaves_j(j_state.opt.mu), _leaves_t(t_state.opt.mu)):
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-4 * max(np.abs(a).max(), 1e-30))
    assert int(t_state.step) == 5


def test_microbatches_accumulate_as_one_batch(pair):
    _, run, _, t_o, _, t_state = _states(pair)
    batch = _t(_batch(pair.cfg, seed=3))
    l1, g1 = loop.value_and_grad(pair.cfg, run)(t_state.params, batch)
    l2, g2 = loop.value_and_grad(pair.cfg, run, microbatches=2)(
        t_state.params, batch)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    for a, b in zip(_leaves_t(g1), _leaves_t(g2)):
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=GRAD_FRAC * np.abs(a).max())
    _, m2 = loop.make_train_step(pair.cfg, run, t_o, microbatches=2)(
        t_state, batch)
    np.testing.assert_allclose(float(m2["loss"]), float(l1), rtol=1e-6)
    with pytest.raises(ValueError, match="microbatches"):
        loop.make_train_step(pair.cfg, run, t_o, microbatches=3)(t_state,
                                                                 batch)


def test_eval_step_matches_train_loss(pair):
    _, run, _, _, j_state, t_state = _states(pair)
    batch = _batch(pair.cfg, seed=4)
    want = j_loop.make_eval_step(pair.jcfg, JRunConfig())(
        j_state.params, _j(batch))["loss"]
    got = loop.make_eval_step(pair.cfg, run)(t_state.params, batch)["loss"]
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    assert not got.requires_grad


def test_axis_name_and_unknown_modes_are_refused(pair):
    """``axis_name`` needs a mesh with that axis (``NameError``, as JAX's
    ``pmean`` outside ``shard_map``); under it only ``pca_ef`` reduces
    anything, so ``none`` and ``gae`` are refused (ROADMAP.md §3,
    divergence 9); an unknown mode is refused."""
    from repro_torch.launch.mesh import make_mesh

    t_o = _optimizers()[1]
    with pytest.raises(NameError, match="unbound axis name: data"):
        loop.make_train_step(pair.cfg, RunConfig(), t_o, axis_name="data")
    mesh = make_mesh((2,), ("data",), ["cpu", "cpu"])
    for mode in ("none", "gae"):
        with pytest.raises(ValueError, match="GSPMD mode"):
            loop.make_train_step(pair.cfg,
                                 RunConfig(gradient_compression=mode), t_o,
                                 mesh=mesh, axis_name="data")
    with pytest.raises(ValueError, match="gradient_compression"):
        loop.make_train_step(pair.cfg,
                             RunConfig(gradient_compression="topk"), t_o)
