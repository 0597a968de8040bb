"""The port's FSDP train step (``make_train_step(mesh=, shardings=)`` with
``sharding.train_state_specs(..., fsdp=True)``) against the JAX package's
jitted GSPMD step with the FSDP ``in_shardings``, on the CPU, and what FSDP
keeps: the nested stacks against the port's own tensor-parallel step, the
gradient pieces' storage, the gathered weights' lifetime, the logged
reduce-scatter and the refusals.

The port's seeded ``TrainState`` at ``RunConfig(tp=N)``, its
constant-init leaves perturbed as ``tests/test_torch_tp_families.py``
perturbs JAX's, is handed to JAX (its leaves into the structure of JAX's
``TrainState``), and the same numpy-made batches (whisper's with frames)
go through both packages.  JAX's steps run in ONE subprocess
(``_JAX_FSDP_STEPS``, which imports nothing of the port) with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` on meshes of
``AxisType.Auto`` axes (ROADMAP.md §3 divergence 13), at the tests' own
priority: ``jax.jit`` of the step alone (JAX's clipped gradient is read from its
first step's moment, ``mu = (1 - b1) g``: one compile a case),
``in_shardings`` from ``param_partition_specs(..., fsdp_axis="data",
fsdp_size=dp, tp_size=tp, min_fsdp_elems=MIN_FSDP)``, small enough that
the reduced models' leaves really are cut.  Cases (``CASES``): reduced
qwen2-1.5b on ``(2, 1)`` and on ``(2, 2)`` with ``sp`` and remat, reduced
mamba2-370m on ``(2, 2)``, reduced whisper-medium on ``(2, 1)`` (its
leaves outside the stacks, the row-split ``pos_embed`` among them).  The
port runs over ``["cpu"] * (dp * tp)``.  Tolerances, as
``tests/test_torch_train_tp.py`` states them: each leaf's gradient
(clipped by the global norm, as both steps clip it) at 1e-5 of its
largest entry of JAX's (whisper's key biases ``bk``, whose gradient is 0
in exact arithmetic, below 1e-6 of the largest gradient, as
``tests/test_torch_train_tp_families.py`` holds them); losses 1e-5
relative; after one step every param within Adam's first-step bound of
JAX's from the two sides' gradients, with 1 % of the learning rate beside
it (JAX's step differentiates inside its own program, whose rounding can
differ from the gradient the bound is read from: reduced qwen2-1.5b's
``wq`` at ``(2, 2)`` with ``sp`` and remat lands 1.95e-05 lr past the
bound, mamba2-370m's ``unembed/w`` 7.6e-05 lr); after two steps within 1 %
of the summed learning rate of what the first step put between them.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import weakref

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.launch.mesh import make_mesh, shard_grid
from repro_torch.models import registry
from repro_torch.parallel import collectives, fsdp, sharding
from repro_torch.parallel.tensor import Shards
from repro_torch.train import loop
from repro_torch.train import optim as t_opt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_tp_families import _extra, _perturbed  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_LR, WARMUP, TOTAL, EPS = 1e-3, 2, 5, 1e-8
B, S, STEPS = 4, 16, 2
MIN_FSDP = 1024
GRAD_FRAC, ZERO_GRAD_FRAC = 1e-5, 1e-6
# (name, arch, data shards, model shards, sp, remat)
CASES = [("qwen2_2x1", "qwen2-1.5b", 2, 1, False, False),
         ("qwen2_2x2_sp_remat", "qwen2-1.5b", 2, 2, True, True),
         ("mamba2_2x2", "mamba2-370m", 2, 2, False, False),
         ("whisper_2x1", "whisper-medium", 2, 1, False, False)]


def _lr(step):
    return float(t_opt.warmup_cosine_schedule(PEAK_LR, WARMUP, TOTAL)(step))


TWO_STEP_ATOL = 0.01 * sum(_lr(i) for i in range(1, STEPS + 1))
FIRST_STEP_ATOL = 0.01 * _lr(1)


def _optimizer(m):
    return m.adamw(m.warmup_cosine_schedule(PEAK_LR, WARMUP, TOTAL),
                   weight_decay=0.01, max_grad_norm=1.0)


def _batch(cfg, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32), **_extra(cfg, B)}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


def _state(arch, tp):
    """The port's seeded ``TrainState`` at ``tp``, every param leaf that
    its init makes constant perturbed as ``tests/test_torch_tp_families.py``
    perturbs JAX's; JAX's step starts from these same numbers."""
    state = loop.init_train_state(torch.Generator().manual_seed(0),
                                  _cfg(arch), RunConfig(tp=tp),
                                  _optimizer(t_opt), "cpu")
    return state._replace(params=registry.params_from_jax(
        _perturbed(_numpy(state.params)), "cpu"))


_JAX_FSDP_STEPS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.configs.base import RunConfig
from repro.models import registry
from repro.parallel import sharding as shd
from repro.train import loop, optim

(peak, warmup, total, min_fsdp, steps), cases = json.loads(sys.argv[3])
given = np.load(sys.argv[2])
out = {}
leaves = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]
for name, arch, dp, tp, sp, remat in cases:
    cfg = registry.reduced_config(get_config(arch))
    run = RunConfig(tp=tp, sp=sp, remat=remat)
    opt = optim.adamw(optim.warmup_cosine_schedule(peak, warmup, total),
                      weight_decay=0.01, max_grad_norm=1.0)
    # the state the test carried across, into the structure of JAX's own
    tree = jax.tree.structure(jax.eval_shape(
        lambda: loop.init_train_state(jax.random.PRNGKey(0), cfg, run, opt)))
    state = jax.tree.unflatten(tree, [
        jnp.asarray(given[f"{name}/state/{i}"])
        for i in range(tree.num_leaves)])
    batches = [{k: jnp.asarray(given[f"{name}/batch{s}/{k}"])
                for k in ("tokens", "labels", "frames")
                if f"{name}/batch{s}/{k}" in given}
               for s in range(steps)]
    mesh = jax.make_mesh((dp, tp), ("data", "model"),
                         devices=jax.devices()[:dp * tp],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    pspecs = shd.param_partition_specs(
        state.params, fsdp_axis="data", fsdp_size=dp, tp_size=tp,
        min_fsdp_elems=min_fsdp)
    specs = loop.TrainState(params=pspecs, opt=type(state.opt)(
        step=P(), mu=pspecs, nu=pspecs), gc=None, step=P())
    shards = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                    is_leaf=lambda s: isinstance(s, P))
    bspecs = {k: P(("data",), *([None] * (v.ndim - 1)))
              for k, v in batches[0].items()}
    rules = shd.activation_rules(False, sp=True) if sp else None
    with mesh, shd.activation_sharding(rules):
        step = jax.jit(loop.make_train_step(cfg, run, opt),
                       in_shardings=(shards(specs), shards(bspecs)),
                       out_shardings=(shards(specs), None))
        state = jax.device_put(state, shards(specs))
        for s, batch in enumerate(batches):
            state, m = step(state, batch)
            if s == 0:
                # the first step's moment is (1 - b1) x the clipped gradient
                for i, x in enumerate(leaves(state.opt.mu)):
                    out[f"{name}/grad/{i}"] = x / (1 - 0.9)
            out[f"{name}/loss/{s}"] = np.asarray(m["loss"])
            for i, x in enumerate(leaves(state.params)):
                out[f"{name}/params{s}/{i}"] = x
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the reduced models' ops gain
    nothing from more, and the whole suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    """JAX's gradients, losses and params of every case, in one
    subprocess, from the states and batches the tests use (``_state``,
    ``_batch``; the state's leaves in ``jax.tree.leaves`` order)."""
    tmp = tmp_path_factory.mktemp("jax_fsdp_steps")
    given = {}
    for name, arch, dp, tp, sp, remat in CASES:
        cfg = _cfg(arch)
        for i, x in enumerate(t_opt.tree_leaves(_state(arch, tp))):
            given[f"{name}/state/{i}"] = x.numpy()
        for s in range(STEPS):
            for k, v in _batch(cfg, s).items():
                given[f"{name}/batch{s}/{k}"] = v
    np.savez(tmp / "given.npz", **given)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        # at the tests' own priority: ~20 s of work, one thread, which at
        # niceness 10 waited ~270 s under the whole suite's load
        [sys.executable, "-c", _JAX_FSDP_STEPS,
         str(tmp / "out.npz"), str(tmp / "given.npz"),
         json.dumps([[PEAK_LR, WARMUP, TOTAL, MIN_FSDP, STEPS], CASES])],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(tmp / "out.npz") as f:
        return dict(f)


def _cfg(arch):
    return registry.reduced_config(get_config(arch))


def _mesh(dp, tp, devices=None):
    return make_mesh((dp, tp), ("data", "model"),
                     devices or ["cpu"] * (dp * tp))


def _paths(tree, prefix=""):
    """Each leaf's path, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def _spec_leaves(tree):
    """A spec tree's specs, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    return [tree]


def _whole(tree):
    return [x.detach().float().numpy()
            for x in t_opt.tree_leaves(sharding.unshard_params(tree))]


def _clipped(grads):
    norm = np.sqrt(sum(np.sum(np.square(g.astype(np.float64)))
                       for g in grads))
    return [g * min(1.0, 1.0 / (norm + 1e-12)) for g in grads]


def _first_step_bound(p, gj, gt, lr):
    """``tests/test_torch_train.py``'s: how far two Adam first steps from
    ``p`` may land apart with gradients ``gj`` and ``gt``."""
    g_min = np.where(np.sign(gj) == np.sign(gt),
                     np.minimum(np.abs(gj), np.abs(gt)), 0.0)
    slope = lr * EPS / (g_min + EPS) ** 2
    return (slope * np.abs(gt.astype(np.float64) - gj)
            + 8 * np.spacing(np.float32(lr)) + 2 * np.spacing(np.abs(p) + lr))


def _fsdp(state, mesh, min_elems=MIN_FSDP):
    specs = sharding.train_state_specs(state, mesh, fsdp=True,
                                       min_fsdp_elems=min_elems)
    assert fsdp.cuts_data(specs, mesh)
    return specs


# ---------------------------------------------------------------------------
# the step against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,arch,dp,tp,sp,remat", CASES,
                         ids=[c[0] for c in CASES])
def test_fsdp_step_matches_jax_gspmd_step(jax_steps, name, arch, dp, tp, sp,
                                          remat):
    """The gradient of each leaf, then two steps, against JAX's jitted
    step with the FSDP ``in_shardings``."""
    cfg = _cfg(arch)
    run = RunConfig(tp=tp, sp=sp, remat=remat)
    opt = _optimizer(t_opt)
    state = _state(arch, tp)
    before = [x.numpy() for x in t_opt.tree_leaves(state.params)]
    paths = _paths(state.params)
    mesh = _mesh(dp, tp)
    specs = _fsdp(state, mesh)
    placed = loop.shard_train_state(state, mesh, specs)
    _, g = loop.tensor_parallel_value_and_grad(cfg, run, mesh)(
        placed.params, _batch(cfg, 0))
    g_port = _clipped(_whole(g))
    g_jax = [jax_steps[f"{name}/grad/{i}"] for i in range(len(before))]
    top = max(np.abs(x).max() for x in g_jax)
    zero = {p for p in paths if cfg.family == "audio" and p.endswith("/bk")}
    for path, a, b in zip(paths, g_port, g_jax):
        if path in zero:
            assert np.abs(a).max() <= ZERO_GRAD_FRAC * top, path
            continue
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=GRAD_FRAC * np.abs(b).max(),
                                   err_msg=path)
    step = loop.make_train_step(cfg, run, opt, mesh=mesh, shardings=specs)
    for s in range(STEPS):
        state, m = step(state, _batch(cfg, s))
        np.testing.assert_allclose(float(m["loss"]),
                                   jax_steps[f"{name}/loss/{s}"], rtol=1e-5)
        got = _whole(state.params)
        want = [jax_steps[f"{name}/params{s}/{i}"]
                for i in range(len(before))]
        if s == 0:
            for path, p, a, b, x, y in zip(paths, before, got, want, g_jax,
                                           g_port):
                if path in zero:
                    assert np.all(np.abs(a - b) <= 2 * _lr(1)), path
                    continue
                assert np.all(np.abs(a - b) <= _first_step_bound(
                    p, x, y, _lr(1)) + FIRST_STEP_ATOL), path
            first = (got, want)
        else:
            for path, a, b, a1, b1 in zip(paths, got, want, *first):
                if path in zero:
                    assert np.all(np.abs(a - b) <= 2 * sum(
                        _lr(i) for i in range(1, STEPS + 1))), path
                    continue
                assert np.all(np.abs(a - b)
                              <= np.abs(a1 - b1) + TWO_STEP_ATOL), path
    # the state kept its FSDP placement
    assert any(fsdp.cut_dim(sh) is not None
               for sh in sharding.sharded_leaves(state.params))


# ---------------------------------------------------------------------------
# the port's own: nested stacks, storage, lifetime, the log, refusals
# ---------------------------------------------------------------------------

def _port_state(cfg, run):
    return loop.init_train_state(torch.Generator().manual_seed(0), cfg, run,
                                 _optimizer(t_opt), "cpu")


def _gathers_by_path(monkeypatch):
    """Record each ``RowView`` gather: (its stacked index, a weakref of the
    gathered tensor)."""
    seen = []
    real = fsdp.RowView.gather

    def gather(view):
        out = real(view)
        seen.append((view.index, weakref.ref(out)))
        return out
    monkeypatch.setattr(fsdp.RowView, "gather", gather)
    return seen


# arch, the mesh's devices, RunConfig fields: the VLM's model shards on
# distinct device objects, so that its model-replicated ``vision_proj/w``
# (cut over "data") sums two copies' parts over the model axis; the dense
# family with ``cast_params_early`` (the layers' views cast at use)
NESTED = {"vlm": ("llama-3.2-vision-11b", ["cpu", "cpu:0"] * 2, {}),
          "hybrid": ("recurrentgemma-9b", None, {}),
          "dense_cast_early": ("qwen2-1.5b", None, dict(
              compute_dtype="bfloat16", cast_params_early=True))}


@pytest.mark.parametrize("family", list(NESTED))
def test_nested_stacks_under_fsdp_equal_the_tp_step(family, monkeypatch):
    """The VLM's ``groups`` -> ``selfs`` and the hybrid's ``triples`` and
    ``tail`` under FSDP on ``(2, 2)``, and the dense family with
    ``cast_params_early``: the loss, every leaf's gradient and one step's
    params within 1e-5 of the port's tensor-parallel step without the cut;
    each cut leaf gathered once per layer that uses it (a ``selfs`` leaf
    per self layer, ``groups/cross`` per group), once per row's forward
    outside the stacks."""
    arch, devices, fields = NESTED[family]
    cfg = _cfg(arch)
    run = RunConfig(tp=2, **fields)
    state = _port_state(cfg, run)
    mesh = _mesh(2, 2, devices)
    specs = _fsdp(state, mesh)
    batch = _batch(cfg, 0)
    vg = loop.tensor_parallel_value_and_grad(cfg, run, mesh)
    l_tp, g_tp = vg(loop.shard_train_state(state, mesh).params, batch)
    seen = _gathers_by_path(monkeypatch)
    l_f, g_f = vg(loop.shard_train_state(state, mesh, specs).params, batch)
    np.testing.assert_allclose(float(l_f), float(l_tp), rtol=1e-5)
    for path, a, b in zip(_paths(state.params), _whole(g_f), _whole(g_tp)):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=GRAD_FRAC * np.abs(b).max(),
                                   err_msg=path)
    # reckon the gathers of one row's shard from the specs
    want = 0
    for path, spec, leaf in zip(_paths(state.params),
                                _spec_leaves(specs.params),
                                t_opt.tree_leaves(state.params)):
        if "data" in sharding.spec_axes(spec):
            depth = sharding.stack_depth(path)
            want += int(np.prod(leaf.shape[:depth]))
    assert len(seen) == 2 * 2 * want
    if family == "vlm":
        n_groups = cfg.n_layers // cfg.cross_period
        idx = {i for i, _ in seen}
        assert {(g, j) for g in range(n_groups)
                for j in range(cfg.cross_period - 1)} <= idx
        assert {(g,) for g in range(n_groups)} <= idx
    step = loop.make_train_step(cfg, run, _optimizer(t_opt), mesh=mesh)
    a, _ = step(state, batch)
    b, _ = loop.make_train_step(cfg, run, _optimizer(t_opt), mesh=mesh,
                                shardings=specs)(state, batch)
    for path, x, y in zip(_paths(state.params), _whole(a.params),
                          _whole(b.params)):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-5, err_msg=path)


def test_cut_gradients_live_as_cuts_and_reduce_scatter():
    """Every gradient piece of a cut leaf has storage of its cut's bytes,
    not of a whole leaf, and the data axis's mean of the cut leaves is
    logged as one reduce-scatter of one shard's slice per leaf and model
    column, while the all-reduces carry only the uncut leaves and the
    loss."""
    cfg = _cfg("qwen2-1.5b")
    run = RunConfig(tp=2)
    state = _port_state(cfg, run)
    mesh = _mesh(2, 2)
    params = loop.shard_train_state(state, mesh, _fsdp(state, mesh)).params
    vg = loop.tensor_parallel_value_and_grad(cfg, run, mesh)
    collectives.LOG.reset()
    vg(loop.shard_train_state(state, mesh).params, _batch(cfg, 0))
    log_tp = collectives.LOG.summary()
    collectives.LOG.reset()
    _, g = vg(params, _batch(cfg, 0))
    log = collectives.LOG.summary()
    cut_bytes = n_cut = 0
    for sh, gs in zip(sharding.sharded_leaves(params),
                      sharding.sharded_leaves(g)):
        piece = sh.pieces.flat[0]
        if fsdp.cut_dim(sh) is None:
            continue
        n_cut += 1
        cut_bytes += 2 * piece.numel() * 4          # two model columns
        whole = int(np.prod(sh.shape)) * 4
        for coord in np.ndindex(gs.pieces.shape):
            p = gs.pieces[coord]
            assert p.untyped_storage().nbytes() == piece.numel() * 4 \
                < whole
        assert len({id(p) for p in gs.pieces.flat}) == 4
    assert n_cut
    assert log["counts"]["reduce-scatter"] == 2 * n_cut
    assert log["bytes"]["reduce-scatter"] == cut_bytes
    assert "reduce-scatter" not in log_tp["counts"]
    # the same all-reduces as the tensor-parallel step's, less the cut
    # leaves' pieces (each of the two model shards' tensor-parallel piece,
    # twice a data piece)
    assert log["counts"]["all-reduce"] == log_tp["counts"]["all-reduce"]
    assert (log_tp["bytes"]["all-reduce"] - log["bytes"]["all-reduce"]
            == 2 * cut_bytes)


def test_gathered_layer_weights_die_after_their_layer(monkeypatch):
    """Under remat a layer's gathered weights are gone once its forward is
    done (the checkpoint keeps none for the backward) and gathered again
    by the backward's recompute, then gone; the leaves outside the stacks
    are gathered once per row's forward and live until its backward."""
    cfg = _cfg("qwen2-1.5b")
    run = RunConfig(tp=2, remat=True)
    state = _port_state(cfg, run)
    mesh = _mesh(2, 2)
    params = loop.shard_train_state(state, mesh, _fsdp(state, mesh)).params
    cuts = fsdp.CutGrads(sharding.sharded_leaves(params))
    seen = _gathers_by_path(monkeypatch)
    trees = fsdp.row_trees(params, mesh, 0, grads=cuts)
    devs = [mesh.devices[c] for c in shard_grid(mesh)[0]]
    batch = {k: torch.as_tensor(v[:B // 2])
             for k, v in _batch(cfg, 0).items()}
    loss = registry.get_model(cfg).train_loss(Shards(trees, None, devs),
                                              cfg, run, batch)
    outside = [r for i, r in seen if not i]
    layers = [r for i, r in seen if i]
    assert outside and layers
    assert all(r() is not None for r in outside)
    assert all(r() is None for r in layers)
    n = len(layers)
    torch.autograd.grad(loss, cuts.take_anchors(), allow_unused=True)
    again = [r for i, r in seen if i][n:]
    assert len(again) == n                # the recompute gathers again
    assert all(r() is None for r in again)
    del loss, trees
    assert all(r() is None for r in outside)
    assert any(float(s.abs().max()) > 0 for s in cuts.sums.values())


@pytest.mark.parametrize("devices", [["cpu"] * 4, ["cpu", "cpu:0"] * 2],
                         ids=["one_device", "model_copies"])
def test_sharded_leaf_cut_over_data_and_model(devices):
    """``Sharded`` for a leaf with one dim cut over ``"data"`` and another
    over ``"model"``: the whole shape, each piece's slice key (its data
    and model index), one owner a piece, the split dims, ``host`` the
    whole tensor, and no piece a view of it; a leaf the model axis
    replicates has one slice a data index, held once a device."""
    mesh = _mesh(2, 2, devices)
    t = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    sh = sharding.shard_leaf(t, sharding.P(None, "data", "model"), mesh)
    assert sh.shape == (4, 6, 8) and sh.split_dims() == [1, 2]
    assert fsdp.cut_dim(sh) == 1
    for d in range(2):
        for s in range(2):
            p = sh.pieces[d, s]
            assert sh.slice_key((d, s)) == (d, s)
            assert torch.equal(p, t[:, 3 * d:3 * d + 3, 4 * s:4 * s + 4])
            assert p.untyped_storage().data_ptr() \
                != t.untyped_storage().data_ptr()
    assert len(sh.owners()) == 4
    assert torch.equal(sh.host(), t)
    rep = sharding.shard_leaf(t, sharding.P(None, "data", None), mesh)
    assert [rep.slice_key(c) for c, _ in rep.owners()] == \
        ([(0,), (0,), (1,), (1,)] if devices[1] == "cpu:0"
         else [(0,), (1,)])
    assert torch.equal(rep.host(), t)


@pytest.mark.parametrize("arch,mode,dp,error,says", [
    ("qwen2-1.5b", "pca_ef", 2, NotImplementedError, "ROADMAP.md §1"),
    ("qwen2-1.5b", "gae", 2, NotImplementedError, "_fill_rows"),
    ("granite-moe-3b-a800m", "none", 2, ValueError, "divergence 10")],
    ids=["pca_ef", "gae", "moe"])
def test_fsdp_refusals_name_their_reason(arch, mode, dp, error, says):
    cfg = _cfg(arch)
    run = RunConfig(tp=1, gradient_compression=mode)
    state = _port_state(cfg, RunConfig(tp=1))
    mesh = _mesh(dp, 1)
    with pytest.raises(error, match=says):
        loop.make_train_step(cfg, run, _optimizer(t_opt), mesh=mesh,
                             shardings=_fsdp(state, mesh))
