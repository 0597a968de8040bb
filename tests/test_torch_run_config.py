"""The dry-run's run configs in the port against the JAX package, on the CPU:
``RunConfig.remat``, ``param_dtype`` (with ``cast_params``) and
``cast_params_early``, and three small helpers.

For the reduced config of one arch of every family (dense qwen2-1.5b, moe
granite-moe-3b-a800m, ssm mamba2-370m, hybrid recurrentgemma-9b, vlm
llama-3.2-vision-11b with nonzero tanh gates, audio whisper-medium with its
biases and layer norms seeded away from their init), the JAX params and
``TrainState`` are carried across (``train_state_from_jax``) and the same
numpy-made batches go through both packages.  Tolerances, each stated where
it is used:

* ``remat=True`` against ``jax.jit(make_train_step)`` with the same
  ``RunConfig``, fp32: the loss at 1e-5 relative, every new param within
  Adam's first-step bound of JAX's (``_adam_first_step_bound`` of
  ``tests/test_torch_train.py``, from the two sides' clipped gradients);
* remat against no remat in the port: bit for bit (the same operations on
  the same inputs, recomputed);
* bf16 compute (``param_dtype="bfloat16"``, or ``cast_params_early``):
  the loss at ``BF16_LOSS_RTOL`` (reasoned there), every new param within
  the first-step bound with the rounding of the param's own dtype
  (``_bf16_step_bound``);
* the GSPMD step over two shards of ``cpu`` against the one-device step:
  the loss at 1e-5 relative, every new param within the first-step bound;
* ``cast_params`` and the three helpers: bit for bit, or equal floats.
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
from repro.models import transformer as j_transformer
from repro.train import loop as j_loop
from repro.train import optim as j_opt
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import registry, transformer
from repro_torch.train import loop
from repro_torch.train import optim as t_opt
from test_torch_train import (PEAK_LR, TOTAL, WARMUP, _adam_first_step_bound,
                              _clipped)
from test_torch_whisper import _seed_zero_init

FAMILIES = {"dense": "qwen2-1.5b", "moe": "granite-moe-3b-a800m",
            "ssm": "mamba2-370m", "hybrid": "recurrentgemma-9b",
            "vlm": "llama-3.2-vision-11b", "audio": "whisper-medium"}
B, S = 2, 32
LOSS_RTOL = 1e-5
# bf16 compute: the two packages round each matmul's bf16 result (an
# 8-bit mantissa, a relative step of 2^-8 = 3.9e-3) after sums in other
# orders, and the loss's mean over B x S tokens averages those roundings
# down; held at a quarter of the step (measured over the six families:
# 8.4e-6 to 4.2e-4, the hybrid the largest)
BF16_LOSS_RTOL = 1e-3


@dataclasses.dataclass
class Pair:
    family: str
    cfg: object
    jcfg: object
    jparams: dict


def _jparams(family, jcfg):
    p = jax.device_get(j_registry.get_model(jcfg).init_params(
        jax.random.PRNGKey(0), jcfg, JRunConfig()))
    rng = np.random.default_rng(11)
    if family == "vlm":                      # tanh(0) gates hide the cross
        cross = p["groups"]["cross"]
        for gate in ("gate_attn", "gate_mlp"):
            cross[gate] = rng.uniform(0.3, 1.0,
                                      cross[gate].shape).astype(np.float32)
    if family == "audio":
        _seed_zero_init(p, rng)
    return p


@pytest.fixture(scope="module", params=list(FAMILIES))
def pair(request):
    arch = FAMILIES[request.param]
    jcfg = j_registry.reduced_config(j_get_config(arch))
    cfg = registry.reduced_config(get_config(arch))
    return Pair(request.param, cfg, jcfg, _jparams(request.param, jcfg))


def _batch(pair, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, pair.cfg.vocab, (B, S + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    if pair.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (B, pair.cfg.n_vision_tokens, pair.cfg.d_model)).astype(np.float32)
    if pair.family == "audio":
        batch["frames"] = rng.standard_normal(
            (B, pair.cfg.n_frames, pair.cfg.d_model)).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _f32(tree):
    """Leaves as float32 numpy (bf16 ones exactly)."""
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _f32_t(tree):
    return [x.detach().float().numpy() for x in t_opt.tree_leaves(tree)]


def _optimizers():
    def make(m):
        return m.adamw(m.warmup_cosine_schedule(PEAK_LR, WARMUP, TOTAL),
                       weight_decay=0.01, max_grad_norm=1.0)
    return make(j_opt), make(t_opt)


def _lr():
    return float(t_opt.warmup_cosine_schedule(PEAK_LR, WARMUP, TOTAL)(1))


def _states(pair, jrun):
    """JAX's ``TrainState`` for ``jrun`` with the pair's params (cast to
    ``param_dtype`` as ``init_train_state`` casts them), and the port's
    carried across."""
    j_o, t_o = _optimizers()
    params = jax.tree.map(jnp.asarray, pair.jparams)
    if jrun.param_dtype != "float32":
        params = j_transformer.cast_params(params, jnp.dtype(jrun.param_dtype))
    j_state = j_loop.init_train_state(jax.random.PRNGKey(0), pair.jcfg, jrun,
                                      j_o)._replace(params=params)
    j_state = j_state._replace(opt=j_o.init(params))
    t_state = registry.train_state_from_jax(jax.device_get(j_state), "cpu")
    return j_o, t_o, j_state, t_state


def _jax_grads(pair, jrun, params, batch):
    """JAX's gradient of ``make_train_step``'s loss (the cast inside it
    with ``cast_params_early``)."""
    def loss(p):
        if jrun.cast_params_early and jrun.compute_dtype != jrun.param_dtype:
            p = j_transformer.cast_params(p, jnp.dtype(jrun.compute_dtype))
        return j_registry.get_model(pair.jcfg).train_loss(p, pair.jcfg, jrun,
                                                          _j(batch))
    return jax.jit(jax.value_and_grad(loss))(params)


def _bf16_step_bound(p, gj, gt, lr, param_dtype):
    """Adam's first-step bound (``_adam_first_step_bound``) where the new
    param is rounded to ``param_dtype``: for bf16, two of its spacings at
    |p| + lr in place of float32's (an 8-bit mantissa: 2^-7 of the
    value's power of two)."""
    bound = _adam_first_step_bound(p, gj, gt, lr)
    if param_dtype == "bfloat16":
        top = np.abs(p.astype(np.float64)) + lr
        bound = bound + 2 * np.exp2(np.floor(np.log2(top)) - 7)
    return bound


def _one_step_against_jax(pair, jrun, run, loss_rtol):
    j_o, t_o, j_state, t_state = _states(pair, jrun)
    batch = _batch(pair, seed=2)
    j_new, j_m = jax.jit(j_loop.make_train_step(pair.jcfg, jrun, j_o))(
        j_state, _j(batch))
    t_new, t_m = loop.make_train_step(pair.cfg, run, t_o)(t_state, batch)
    np.testing.assert_allclose(float(t_m["loss"]), float(j_m["loss"]),
                               rtol=loss_rtol)
    _, j_g = _jax_grads(pair, jrun, j_state.params, batch)
    _, t_g = loop.value_and_grad(pair.cfg, run)(t_state.params, _t(batch))
    for p, a, b, cj, ct in zip(_f32(j_state.params), _f32(j_new.params),
                               _f32_t(t_new.params), _clipped(_f32(j_g)),
                               _clipped(_f32_t(t_g))):
        bound = _bf16_step_bound(p, cj, ct, _lr(), run.param_dtype)
        assert np.all(np.abs(b - a) <= bound)
    return t_new


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def test_remat_step_matches_jax(pair):
    jrun, run = JRunConfig(remat=True), RunConfig(remat=True)
    _one_step_against_jax(pair, jrun, run, LOSS_RTOL)


def test_remat_equals_no_remat_bit_for_bit(pair):
    params = registry.params_from_jax(pair.jparams, "cpu")
    batch = _t(_batch(pair, seed=3))
    l0, g0 = loop.value_and_grad(pair.cfg, RunConfig())(params, batch)
    l1, g1 = loop.value_and_grad(pair.cfg, RunConfig(remat=True))(params,
                                                                  batch)
    assert torch.equal(l0, l1)
    for a, b in zip(t_opt.tree_leaves(g0), t_opt.tree_leaves(g1)):
        assert torch.equal(a, b)


def _saved_bytes(pair, run, params, batch) -> int:
    """The bytes autograd saves for the backward of one train loss."""
    total = 0

    def pack(t):
        nonlocal total
        total += t.numel() * t.element_size()
        return t

    leaves = [p.detach().requires_grad_() for p in t_opt.tree_leaves(params)]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = registry.get_model(pair.cfg).train_loss(
            t_opt.tree_unflatten(params, leaves), pair.cfg, run, batch)
    torch.autograd.grad(loss, leaves)
    return total


def test_remat_saves_fewer_bytes(pair):
    """The wrapper is no flag that changes nothing: under remat, autograd
    keeps less for the backward (the layers' activations are recomputed)."""
    params = registry.params_from_jax(pair.jparams, "cpu")
    batch = _t(_batch(pair, seed=4))
    full = _saved_bytes(pair, RunConfig(), params, batch)
    kept = _saved_bytes(pair, RunConfig(remat=True), params, batch)
    assert kept < full / 2, (kept, full)


def test_remat_changes_nothing_without_autograd(pair):
    params = registry.params_from_jax(pair.jparams, "cpu")
    batch = _t(_batch(pair, seed=5))
    api = registry.get_model(pair.cfg)
    with torch.no_grad():
        a = api.train_loss(params, pair.cfg, RunConfig(), batch)
        b = api.train_loss(params, pair.cfg, RunConfig(remat=True), batch)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# param_dtype, cast_params, cast_params_early
# ---------------------------------------------------------------------------

def _dtypes(leaves):
    return [str(x.dtype).replace("torch.", "") for x in leaves]


@pytest.mark.parametrize("mode", ["none", "pca_ef"])
def test_bf16_params_init_train_state_matches_jax_dtypes(pair, mode):
    """bf16 params, float32 Adam moments (``mu_dtype``) and step counters:
    JAX's dtype tree, leaf for leaf."""
    jrun = JRunConfig(param_dtype="bfloat16", gradient_compression=mode)
    run = RunConfig(param_dtype="bfloat16", gradient_compression=mode)
    j_o, t_o = _optimizers()
    j_state = jax.eval_shape(lambda: j_loop.init_train_state(
        jax.random.PRNGKey(0), pair.jcfg, jrun, j_o))
    t_state = loop.init_train_state(torch.Generator().manual_seed(0),
                                    pair.cfg, run, t_o, "cpu")
    want = jax.tree.leaves(j_state)
    got = t_opt.tree_leaves(list(t_state))
    assert [tuple(x.shape) for x in got] == [x.shape for x in want]
    assert _dtypes(got) == [str(x.dtype) for x in want]
    assert {str(x.dtype) for x in jax.tree.leaves(j_state.params)} \
        == {"bfloat16"}


def test_cast_params_matches_jax_bit_for_bit(pair):
    """Every floating leaf rounded to nearest even, as JAX's; an int leaf
    kept."""
    tree = {**pair.jparams, "count": np.arange(5, dtype=np.int32)}
    want = jax.device_get(j_transformer.cast_params(
        jax.tree.map(jnp.asarray, tree), jnp.bfloat16))
    got = transformer.cast_params(registry.params_from_jax(tree, "cpu"),
                                  "bfloat16")
    w_leaves, g_leaves = jax.tree.leaves(want), t_opt.tree_leaves(got)
    assert _dtypes(g_leaves) == [str(x.dtype) for x in w_leaves]
    for a, b in zip(w_leaves, g_leaves):
        if b.dtype == torch.bfloat16:
            b = b.view(torch.int16).numpy().view(np.uint16)
            a = np.asarray(a).view(np.uint16)
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    same = transformer.cast_params(got, torch.bfloat16)
    assert all(x is y for x, y in zip(t_opt.tree_leaves(same), g_leaves))


def test_bf16_params_step_matches_jax(pair):
    """The serve-style params in a train step: bf16 params and compute,
    float32 moments; the params' own rounding in the bound."""
    jrun = JRunConfig(param_dtype="bfloat16", compute_dtype="bfloat16")
    run = RunConfig(param_dtype="bfloat16", compute_dtype="bfloat16")
    new = _one_step_against_jax(pair, jrun, run, BF16_LOSS_RTOL)
    assert {x.dtype for x in t_opt.tree_leaves(new.params)} \
        == {torch.bfloat16}
    assert {x.dtype for x in t_opt.tree_leaves(new.opt.mu)} \
        == {torch.float32}


def test_cast_params_early_step_matches_jax(pair):
    """float32 masters cast to bf16 inside the loss: the gradients come
    back float32 through the cast."""
    jrun = JRunConfig(compute_dtype="bfloat16", cast_params_early=True)
    run = RunConfig(compute_dtype="bfloat16", cast_params_early=True)
    new = _one_step_against_jax(pair, jrun, run, BF16_LOSS_RTOL)
    assert {x.dtype for x in t_opt.tree_leaves(new.params)} \
        == {torch.float32}


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-370m"])
def test_cast_params_early_gspmd_step_matches_one_device(arch):
    """The GSPMD step over two shards of ``cpu`` goes through the same
    ``value_and_grad``, so it casts too: its loss and new params against
    the one-device step's."""
    cfg = registry.reduced_config(get_config(arch))
    run = RunConfig(compute_dtype="bfloat16", cast_params_early=True,
                    remat=True)
    _, t_o = _optimizers()
    state = loop.init_train_state(torch.Generator().manual_seed(0), cfg,
                                  run, t_o, "cpu")
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (4, S + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    mesh = make_mesh((2, 1), ("data", "model"), ["cpu", "cpu"])
    dp_new, dp_m = loop.make_train_step(cfg, run, t_o, mesh=mesh)(state,
                                                                  batch)
    one_new, one_m = loop.make_train_step(cfg, run, t_o)(state, batch)
    np.testing.assert_allclose(float(dp_m["loss"]), float(one_m["loss"]),
                               rtol=LOSS_RTOL)
    (_, g_dp), = loop.data_parallel_value_and_grad(
        cfg, run, mesh)(state.params, batch).values()
    _, g_one = loop.value_and_grad(cfg, run)(state.params, batch)
    assert {x.dtype for x in t_opt.tree_leaves(g_dp)} == {torch.float32}
    for p, a, b, ga, gb in zip(_f32_t(state.params), _f32_t(one_new.params),
                               _f32_t(dp_new.params), _clipped(_f32_t(g_one)),
                               _clipped(_f32_t(g_dp))):
        assert np.all(np.abs(b - a) <= _adam_first_step_bound(p, ga, gb,
                                                              _lr()))


# ---------------------------------------------------------------------------
# the three helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bin_size,n", [(1e-3, 80), (0.37, 1), (2.5e-5, 4096)])
def test_quantization_error_bound_matches_jax(bin_size, n):
    from repro.core.quantization import quantization_error_bound as want
    from repro_torch.core.quantization import quantization_error_bound as got
    assert got(bin_size, n) == want(bin_size, n)


@pytest.mark.parametrize("tau,page_elems,n_pages",
                         [(0.05, 16 * 2 * 64, 8), (1e-3, 256, 1), (0.5, 80, 37)])
def test_attention_perturbation_bound_matches_jax(tau, page_elems, n_pages):
    from repro.runtime.kvcache import attention_perturbation_bound as want
    from repro_torch.runtime.kvcache import attention_perturbation_bound as got
    assert got(tau, page_elems, n_pages) == want(tau, page_elems, n_pages)


def test_gae_apply_matches_jax():
    """x^G = x^R + the corrected residual, with the selection's fields:
    each block within tau of x, M and the kept coefficients as JAX's."""
    from repro.core import gae as j_gae
    from repro_torch.core import gae as t_gae

    rng = np.random.default_rng(7)
    n, d, tau, bin_size = 64, 80, 0.05, 1e-3
    x = rng.standard_normal((n, d)).astype(np.float32)
    x_r = x + 0.02 * rng.standard_normal((n, d)).astype(np.float32)
    basis = np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32)
    want, j_sel = j_gae.gae_apply(jnp.asarray(x), jnp.asarray(x_r),
                                  jnp.asarray(basis), tau, bin_size)
    got, t_sel = t_gae.gae_apply(torch.from_numpy(x), torch.from_numpy(x_r),
                                 torch.from_numpy(basis), tau, bin_size)
    np.testing.assert_array_equal(t_sel.m.numpy(), np.asarray(j_sel.m))
    np.testing.assert_array_equal(t_sel.ok.numpy(), np.asarray(j_sel.ok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    err = np.linalg.norm(x - got.numpy(), axis=-1)
    assert np.all(err <= tau * (1 + 1e-5))
