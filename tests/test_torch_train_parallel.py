"""The port's data-parallel train steps against the JAX package's, on the
CPU.

For the reduced configs of qwen2-1.5b (dense, GQA) and mamba2-370m (SSD),
the JAX ``TrainState`` is carried across (``train_state_from_jax``) and
the same numpy-made batches go through both packages.  JAX's sharded
steps need two devices, which JAX fixes at its first import, so they run
in two subprocesses at once (``_JAX_STEPS``, one an arch), each with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``: ``jax.jit(make_train_step)`` with the batch sharded over
a 2-device ``"data"`` mesh (the GSPMD mode) for ``none``, ``pca_ef`` and
``gae``, and ``jax.shard_map(make_train_step(..., axis_name="data"))``
for ``pca_ef`` from a replicated state at a refresh step and at a step
without one.  The port runs over a 2-shard data mesh of ``cpu`` repeated.
Tolerances, as ``tests/test_torch_train.py`` states them:

* losses: 1e-5 relative;
* one step: every param within Adam's first-step bound
  (``_adam_first_step_bound``) of the other side's, from the gradients
  each side's optimizer took (the compressed ones, clipped at 1.0);
  against JAX's, widened to any gradient within 1e-5 of the leaf's
  largest of the port's (``_within_first_step``);
* three steps: every loss within 1e-4 relative (``TRAJ_RTOL``), every
  param within 1 % of the summed learning rate (``THREE_STEP_ATOL``), as
  ``test_five_steps_follow_jax`` holds five (``pca_ef``: twice that);
  under ``gae``, whose trajectories part element by element after the
  first step, the losses within 1e-2, and at most 60 % of the param
  elements past ``THREE_STEP_ATOL`` (``GAE_PARTED_FRAC``; no per-element
  tolerance holds there: ``_trajectory_close`` says what this share
  catches);
* the ``shard_map`` step's error feedback: each shard's at 1e-5 of its
  gradient's largest entry (``GC_FRAC`` of
  ``tests/test_torch_train_compress.py``).
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import jax
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
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import registry
from repro_torch.parallel import collectives
from repro_torch.runtime import grad_compress as t_gc
from repro_torch.train import loop
from repro_torch.train import optim as t_opt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["qwen2-1.5b", "mamba2-370m"]
MODES = ["none", "pca_ef", "gae"]
PEAK_LR, WARMUP, TOTAL, EPS = 1e-3, 2, 5, 1e-8
B, S, STEPS = 4, 32, 3
GRAD_FRAC, GC_FRAC, TRAJ_RTOL = 1e-5, 1e-5, 1e-4
GAE_TAU = 1e-3


def _lr(step):
    return float(t_opt.warmup_cosine_schedule(PEAK_LR, WARMUP, TOTAL)(step))


THREE_STEP_ATOL = 0.01 * sum(_lr(i) for i in range(1, STEPS + 1))
GAE_PARTED_FRAC = 0.6


def _optimizer(m):
    return m.adamw(m.warmup_cosine_schedule(PEAK_LR, WARMUP, TOTAL),
                   weight_decay=0.01, max_grad_norm=1.0)


def _batch(vocab, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


_JAX_STEPS = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
sys.path.insert(0, {tests!r})
from test_torch_train_parallel import MODES, GAE_TAU, STEPS, _batch, _optimizer
from repro.configs import get_config
from repro.configs.base import RunConfig
from repro.models import registry
from repro.runtime import grad_compress as gc_mod
from repro.train import loop, optim

mesh = jax.make_mesh((2,), ("data",), devices=jax.devices()[:2],
                     axis_types=(jax.sharding.AxisType.Auto,))
rep = NamedSharding(mesh, P())
rows = NamedSharding(mesh, P("data"))
out = {{}}
leaves = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]
for arch in sys.argv[2:]:
    cfg = registry.reduced_config(get_config(arch))
    loss_of = lambda p, b: registry.get_model(cfg).train_loss(
        p, cfg, RunConfig(), b)
    sharded_grad_fn = jax.jit(jax.value_and_grad(loss_of),
                              in_shardings=(rep, rows))
    for mode in MODES:
        run = RunConfig(gradient_compression=mode)
        opt = _optimizer(optim)
        state = loop.init_train_state(jax.random.PRNGKey(0), cfg, run, opt)
        step = jax.jit(loop.make_train_step(cfg, run, opt),
                       in_shardings=(rep, {{"tokens": rows, "labels": rows}}),
                       out_shardings=(rep, None))
        if mode == "gae":
            # the gradient the optimizer takes at step 0: the whole batch's,
            # reduced over the shards as the sharded step reduces it
            b0 = {{k: jnp.asarray(v)
                  for k, v in _batch(cfg.vocab, 0).items()}}
            g = gc_mod.gae_compress_grads(
                sharded_grad_fn(state.params, b0)[1], tau=GAE_TAU)[0]
            for i, x in enumerate(leaves(g)):
                out[f"{{arch}}/{{mode}}/ghat/{{i}}"] = x
        for s in range(STEPS):
            batch = {{k: jax.device_put(jnp.asarray(v), rows)
                     for k, v in _batch(cfg.vocab, s).items()}}
            state, m = step(state, batch)
            out[f"{{arch}}/{{mode}}/loss/{{s}}"] = np.asarray(m["loss"])
            if s in (0, STEPS - 1):
                for i, x in enumerate(leaves(state.params)):
                    out[f"{{arch}}/{{mode}}/params{{s}}/{{i}}"] = x

    # shard_map over "data": each shard its own pca_ef error feedback
    run = RunConfig(gradient_compression="pca_ef")
    opt = _optimizer(optim)
    inner = loop.make_train_step(cfg, run, opt, axis_name="data")

    def per_shard(state, batch):
        gc = state.gc._replace(error=jax.tree.map(lambda e: e[0],
                                                  state.gc.error))
        new, m = inner(state._replace(gc=gc), batch)
        gc = new.gc._replace(error=jax.tree.map(lambda e: e[None],
                                                new.gc.error))
        return new._replace(gc=gc), (m["loss"][None],
                                     m["grad_compression"][None])

    def specs(state):
        return jax.tree.map(lambda _: P(), state)._replace(
            gc=gc_mod.GradCompressionState(
                basis=P(), error=jax.tree.map(lambda _: P("data"),
                                              state.gc.error), step=P()))

    fn = None
    for gc_step in (0, 1):
        state = loop.init_train_state(jax.random.PRNGKey(0), cfg, run, opt)
        state = state._replace(gc=state.gc._replace(
            error=jax.tree.map(lambda e: jnp.stack([e, e]), state.gc.error),
            step=jnp.int32(gc_step)))
        sp = specs(state)
        fn = fn or jax.jit(jax.shard_map(
            per_shard, mesh=mesh, in_specs=(sp, P("data")),
            out_specs=(sp, P("data")), check_vma=False))
        batch = {{k: jnp.asarray(v) for k, v in _batch(cfg.vocab, 5).items()}}
        new, (loss, ratio) = fn(state, batch)
        key = f"{{arch}}/shard_map{{gc_step}}"
        out[key + "/loss"] = np.asarray(loss)
        out[key + "/ratio"] = np.asarray(ratio)
        for i, x in enumerate(leaves(new.params)):
            out[f"{{key}}/params/{{i}}"] = x
        for i, x in enumerate(leaves(new.gc.error)):
            out[f"{{key}}/error/{{i}}"] = x
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    """JAX's results, one subprocess an arch, the two at once, each at a
    niceness of 10."""
    root = tmp_path_factory.mktemp("jax_steps")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    script = _JAX_STEPS.format(tests=os.path.join(REPO, "tests"))
    paths = [str(root / f"{i}.npz") for i in range(len(ARCHS))]
    # at a lower priority: other tests' stage deadlines keep the CPU
    procs = [subprocess.Popen(["nice", "-n", "10", sys.executable, "-c",
                               script, path, arch],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=REPO)
             for path, arch in zip(paths, ARCHS)]
    try:
        errs = [proc.communicate(timeout=600)[1] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = {}
    for proc, err, path in zip(procs, errs, paths):
        assert proc.returncode == 0, err[-3000:]
        with np.load(path) as f:
            out.update(f)
    return out


@dataclasses.dataclass
class Pair:
    arch: str
    cfg: object
    jcfg: object


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    return Pair(arch, registry.reduced_config(get_config(arch)),
                j_registry.reduced_config(j_get_config(arch)))


def _state(pair, mode):
    """The JAX package's seeded ``TrainState``, carried across."""
    jrun = JRunConfig(gradient_compression=mode)
    j_state = j_loop.init_train_state(jax.random.PRNGKey(0), pair.jcfg, jrun,
                                      _optimizer(j_opt))
    return registry.train_state_from_jax(jax.device_get(j_state), "cpu")


def _mesh():
    return make_mesh((2, 1), ("data", "model"), ["cpu", "cpu"])


def _leaves(tree):
    return [x.detach().numpy() for x in t_opt.tree_leaves(tree)]


def _saved(out, prefix, n):
    return [out[f"{prefix}/{i}"] for i in range(n)]


def _clipped(grads):
    norm = np.sqrt(sum(np.sum(np.square(g.astype(np.float64)))
                       for g in grads))
    return [g * min(1.0, 1.0 / (norm + 1e-12)) for g in grads]


def _adam_first_step_bound(p, gj, gt, lr):
    """``tests/test_torch_train.py``'s: how far two Adam first steps from
    ``p`` may land apart with gradients ``gj`` and ``gt``."""
    g_min = np.where(np.sign(gj) == np.sign(gt),
                     np.minimum(np.abs(gj), np.abs(gt)), 0.0)
    slope = lr * EPS / (g_min + EPS) ** 2
    return (slope * np.abs(gt.astype(np.float64) - gj)
            + 8 * np.spacing(np.float32(lr)) + 2 * np.spacing(np.abs(p) + lr))


def _widened_bound(p, g, frac, lr):
    """How far an Adam first step from ``p`` with any gradient within
    ``frac`` of the leaf's largest of ``g`` may land from the step with
    ``g``: the slope lr * eps / (|g'| + eps)^2 at the smallest |g'| in
    reach, plus the roundings."""
    delta = frac * np.abs(g).max()
    g_min = np.maximum(np.abs(g) - delta, 0.0)
    return (lr * EPS / (g_min + EPS) ** 2 * delta
            + 8 * np.spacing(np.float32(lr)) + 2 * np.spacing(np.abs(p) + lr))


def _within_first_step(before, a_params, b_params, ga, gb, widen=0.0):
    """Every param of the two first steps within Adam's first-step bound
    from the gradients ``ga`` and ``gb`` the two sides' optimizers took;
    with ``widen``, or within the bound of any gradient within ``widen`` of
    the leaf's largest of ``gb``: JAX's gradient is known only to that
    (``ga`` None), or computed outside its jitted step, whose fusion rounds
    a projection otherwise, and Adam's first step is steep where |g| is
    near eps."""
    ga = [None] * len(gb) if ga is None else _clipped(ga)
    for p, a, b, x, y in zip(before, a_params, b_params, ga, _clipped(gb)):
        bound = _widened_bound(p, y, widen, _lr(1)) if widen else 0.0
        if x is not None:
            bound = np.maximum(bound, _adam_first_step_bound(p, x, y, _lr(1)))
        assert np.all(np.abs(b - a) <= bound)


def _compressed(run, state, grads):
    """The gradients the optimizer takes: ``grads`` after the step's
    compression."""
    if run.gradient_compression == "pca_ef":
        return t_gc.compress_update(grads, state.gc)[0]
    if run.gradient_compression == "gae":
        return t_gc.gae_compress_grads(grads, tau=GAE_TAU)[0]
    return grads


def _trajectory_close(a_params, b_params, mode):
    """``none``: within ``THREE_STEP_ATOL``; ``pca_ef``: twice that, as
    its step-0 basis is an ``eigh`` whose columns near the rank cut turn
    with the gradient's rounding (the largest measured: 1.10x on
    mamba2-370m, GSPMD against one device).  ``gae`` fits a PCA basis and
    picks M per block from each step's gradient, both by thresholds, and
    Adam scales each element's difference up to the learning rate, so
    after one step the two sides' trajectories part element by element:
    no per-element tolerance holds them.  What is held instead is the
    share of elements past ``THREE_STEP_ATOL``, at most
    ``GAE_PARTED_FRAC`` (measured: 0.34-0.51 against JAX and one device;
    a trajectory a step short parts 0.97 of them, one updated with the
    uncompressed gradient 0.63-0.64, one at tau 2e-3 0.65-0.74), and
    every element within Adam's reach, twice the summed learning rate
    (with weight decay), which only a runaway update passes."""
    if mode == "gae":
        reach = 2 * sum(_lr(i) for i in range(1, STEPS + 1))
        parted = total = 0
        for a, b in zip(a_params, b_params):
            d = np.abs(b - a)
            assert np.all(d <= reach * (1 + 0.01 * np.abs(a)) + 1e-7)
            parted += int(np.count_nonzero(d > THREE_STEP_ATOL))
            total += d.size
        assert parted <= GAE_PARTED_FRAC * total, parted / total
        return
    for a, b in zip(a_params, b_params):
        assert np.abs(b - a).max() <= THREE_STEP_ATOL * (
            2 if mode == "pca_ef" else 1)


@pytest.mark.parametrize("mode", MODES)
def test_gspmd_step_matches_jax_sharded_jit_and_one_device(pair, mode,
                                                           jax_steps):
    run = RunConfig(gradient_compression=mode)
    opt = _optimizer(t_opt)
    state = _state(pair, mode)
    mesh = _mesh()
    dp_step = loop.make_train_step(pair.cfg, run, opt, mesh=mesh)
    one_step = loop.make_train_step(pair.cfg, run, opt)
    key = f"{pair.arch}/{mode}"
    n = len(t_opt.tree_leaves(state.params))
    before = _leaves(state.params)

    collectives.LOG.reset()
    b0 = _batch(pair.cfg.vocab, 0)
    dp_new, dp_m = dp_step(state, b0)
    grad_bytes = sum(x.nbytes for x in before)
    assert collectives.LOG.summary() == {
        "bytes": {"all-reduce": grad_bytes + 4},
        "counts": {"all-reduce": 1}, "total_bytes": grad_bytes + 4}
    one_new, one_m = one_step(state, b0)
    np.testing.assert_allclose(float(dp_m["loss"]), float(one_m["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(dp_m["loss"]),
                               float(jax_steps[key + "/loss/0"]), rtol=1e-5)
    # the gradients each side's optimizer took
    (_, g_dp), = loop.data_parallel_value_and_grad(
        pair.cfg, run, mesh)(state.params, b0).values()
    _, g_one = loop.value_and_grad(pair.cfg, run)(state.params, b0)
    for a, b in zip(_leaves(g_one), _leaves(g_dp)):
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=GRAD_FRAC * np.abs(a).max())
    gh_dp = _leaves(_compressed(run, state, g_dp))
    gh_one = _leaves(_compressed(run, state, g_one))
    _within_first_step(before, _leaves(one_new.params),
                       _leaves(dp_new.params), gh_one, gh_dp)
    _within_first_step(before, _saved(jax_steps, key + "/params0", n),
                       _leaves(dp_new.params),
                       _saved(jax_steps, key + "/ghat", n)
                       if mode == "gae" else None, gh_dp, widen=GC_FRAC)

    one_state, dp_state = one_new, dp_new
    dp_losses, one_losses = [float(dp_m["loss"])], [float(one_m["loss"])]
    for s in range(1, STEPS):
        batch = _batch(pair.cfg.vocab, s)
        dp_state, m = dp_step(dp_state, batch)
        dp_losses.append(float(m["loss"]))
        one_state, m = one_step(one_state, batch)
        one_losses.append(float(m["loss"]))
    j_losses = [float(jax_steps[f"{key}/loss/{s}"]) for s in range(STEPS)]
    rtol = 1e-2 if mode == "gae" else TRAJ_RTOL
    np.testing.assert_allclose(dp_losses, j_losses, rtol=rtol)
    np.testing.assert_allclose(dp_losses, one_losses, rtol=rtol)
    _trajectory_close(_saved(jax_steps, f"{key}/params{STEPS - 1}", n),
                      _leaves(dp_state.params), mode)
    _trajectory_close(_leaves(one_state.params), _leaves(dp_state.params),
                      mode)
    assert int(dp_state.step) == int(dp_state.opt.step) == STEPS


def test_gspmd_weighs_shards_by_their_counted_labels(pair):
    """Padding labels (ids past the vocab) all in one shard: the mean over
    shards is still the whole batch's loss and gradient."""
    run = RunConfig()
    state = _state(pair, "none")
    batch = _batch(pair.cfg.vocab, 9)
    batch["labels"][:2, : S // 2] = pair.cfg.vocab + 3
    mesh = _mesh()
    for m in (1, 2):
        (l_dp, g_dp), = loop.data_parallel_value_and_grad(
            pair.cfg, run, mesh, microbatches=m)(state.params,
                                                 batch).values()
        l_one, g_one = loop.value_and_grad(pair.cfg, run, m)(state.params,
                                                              batch)
        np.testing.assert_allclose(float(l_dp), float(l_one), rtol=1e-5)
        for a, b in zip(_leaves(g_one), _leaves(g_dp)):
            np.testing.assert_allclose(b, a, rtol=0,
                                       atol=GRAD_FRAC * np.abs(a).max())


def test_gspmd_keeps_replicas_on_a_second_device(pair):
    """Over ``cpu`` and ``cpu:0`` (a second device object: the copy path)
    the step equals the repeated-device one, and the second device's
    replica is made once and then updated in place of a copy."""
    run = RunConfig(gradient_compression="pca_ef")
    opt = _optimizer(t_opt)
    state = _state(pair, "pca_ef")
    same = loop.make_train_step(pair.cfg, run, opt, mesh=_mesh())
    two = loop.make_train_step(pair.cfg, run, opt, mesh=make_mesh(
        (2, 1), ("data", "model"), ["cpu", "cpu:0"]))
    a, b = state, state
    for s in range(2):
        a, _ = same(a, _batch(pair.cfg.vocab, s))
        b, _ = two(b, _batch(pair.cfg.vocab, s))
        for x, y in zip(_leaves(a), _leaves(b)):
            np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("gc_step", [0, 1], ids=["refresh", "no_refresh"])
def test_shard_map_pca_ef_step_matches_jax(pair, gc_step, jax_steps):
    run = RunConfig(gradient_compression="pca_ef")
    opt = _optimizer(t_opt)
    state = _state(pair, "pca_ef")
    state = state._replace(gc=state.gc._replace(
        step=torch.tensor(gc_step, dtype=torch.int32)))
    mesh = _mesh()
    states = loop.per_shard_states(state, mesh)
    assert states[0].params is states[1].params
    assert states[0].gc.error is not states[1].gc.error
    step = loop.make_train_step(pair.cfg, run, opt, mesh=mesh,
                                axis_name="data")
    batch = _batch(pair.cfg.vocab, 5)
    collectives.LOG.reset()
    new, metrics = step(states, batch)
    key = f"{pair.arch}/shard_map{gc_step}"
    n = len(t_opt.tree_leaves(state.params))
    before = _leaves(state.params)

    # only the coefficients, and the covariance at a refresh, are reduced
    cq = sum(-(-x.size // 256) * 32 for x in before)
    want = 4 * (cq + (256 * 256 if gc_step == 0 else 0))
    assert collectives.LOG.summary()["bytes"] == {"all-reduce": want}
    np.testing.assert_allclose([float(m["loss"]) for m in metrics],
                               jax_steps[key + "/loss"], rtol=1e-5)
    assert metrics[0]["grad_compression"] == pytest.approx(
        float(jax_steps[key + "/ratio"][0]), rel=1e-6)
    assert new[0].params is new[1].params
    assert all(int(st.step) == 1 and int(st.gc.step) == gc_step + 1
               for st in new)

    # each shard's error feedback, stacked on a leading axis as JAX's
    j_err = _saved(jax_steps, key + "/error", n)
    grads = []
    for s in range(2):
        half = {k: v[s * B // 2:(s + 1) * B // 2] for k, v in batch.items()}
        g = _leaves(loop.value_and_grad(pair.cfg, run)(state.params,
                                                       half)[1])
        grads.append(g)
        scale = max(np.abs(x).max() for x in g)
        for a, b in zip(j_err, _leaves(new[s].gc.error)):
            np.testing.assert_allclose(b, a[s], rtol=0, atol=GC_FRAC * scale)
    # the params, from the approx gradient the port's shards reduced to:
    # the mean over shards of (g + 0 - new error)
    gh_t = [np.mean([grads[s][i] - _leaves(new[s].gc.error)[i]
                     for s in range(2)], axis=0) for i in range(n)]
    _within_first_step(before, _saved(jax_steps, key + "/params", n),
                       _leaves(new[0].params), None, gh_t, widen=GC_FRAC)


def test_axis_name_modes_and_binding(pair):
    opt = _optimizer(t_opt)
    mesh = _mesh()
    with pytest.raises(NameError, match="unbound axis name: data"):
        loop.make_train_step(pair.cfg, RunConfig(
            gradient_compression="pca_ef"), opt, axis_name="data")
    with pytest.raises(NameError, match="unbound axis name: pod"):
        loop.make_train_step(pair.cfg, RunConfig(
            gradient_compression="pca_ef"), opt, mesh=mesh, axis_name="pod")
    for mode in ("none", "gae"):
        with pytest.raises(ValueError, match="GSPMD mode"):
            loop.make_train_step(pair.cfg, RunConfig(
                gradient_compression=mode), opt, mesh=mesh, axis_name="data")
    step = loop.make_train_step(pair.cfg, RunConfig(
        gradient_compression="pca_ef"), opt, mesh=mesh, axis_name="data")
    state = _state(pair, "pca_ef")
    with pytest.raises(ValueError, match="1 states for the 2 shards"):
        step([state], _batch(pair.cfg.vocab, 0))
    elsewhere = make_mesh((2, 1), ("data", "model"), ["cpu:0", "cpu"])
    with pytest.raises(ValueError, match="not on the mesh's first"):
        loop.per_shard_states(state, elsewhere)
    with pytest.raises(ValueError, match="not on the mesh's first"):
        loop.make_train_step(pair.cfg, RunConfig(), opt, mesh=elsewhere)(
            state, _batch(pair.cfg.vocab, 0))
    with pytest.raises(ValueError, match="RunConfig.tp=1 but the mesh's "
                                         "model axis has 2 shards"):
        loop.make_train_step(pair.cfg, RunConfig(), opt, mesh=make_mesh(
            (1, 2), ("data", "model"), ["cpu"] * 2))


def test_gspmd_refuses_the_moe_family_over_two_shards(capsys):
    """The moe family's routing caps each expert's tokens by the batch it
    is given, so a data shard would route its rows apart from JAX's GSPMD
    step, which routes the whole batch (ROADMAP.md §3, divergence 10): two
    shards are refused, in the step and in the launcher; one data shard
    is the one-device step."""
    from repro_torch.launch import train as t_train

    cfg = registry.reduced_config(get_config("granite-moe-3b-a800m"))
    run, opt = RunConfig(), _optimizer(t_opt)
    with pytest.raises(ValueError, match="divergence 10"):
        loop.make_train_step(cfg, run, opt, mesh=_mesh())
    with pytest.raises(ValueError, match="divergence 10"):
        loop.data_parallel_value_and_grad(cfg, run, _mesh())
    state = loop.init_train_state(torch.Generator().manual_seed(0), cfg, run,
                                  opt, "cpu")
    batch = _batch(cfg.vocab, 0)
    one = make_mesh((1, 1), ("data", "model"), ["cpu"])
    a, _ = loop.make_train_step(cfg, run, opt, mesh=one)(state, batch)
    b, _ = loop.make_train_step(cfg, run, opt)(state, batch)
    for x, y in zip(_leaves(a.params), _leaves(b.params)):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(SystemExit) as exc:
        t_train.main(["--arch", "granite-moe-3b-a800m", "--reduced",
                      "--steps", "1", "--batch", "4", "--device", "cpu,cpu"])
    assert exc.value.code == 2
    assert "divergence 10" in capsys.readouterr().err


def test_launcher_refuses_a_batch_the_data_shards_do_not_split():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-1.5b", "--reduced", "--steps", "1", "--batch", "3",
         "--device", "cpu,cpu"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 2
    assert "--batch 3 does not split over the 2 data shards" in proc.stderr
