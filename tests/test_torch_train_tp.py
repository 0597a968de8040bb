"""The port's tensor-parallel train step against the JAX package's
launcher-style jitted step, on the CPU, and what the step keeps: the run
configs (remat, bf16, ``cast_params_early``, microbatches) against the
one-device step, the replicated leaves' gradients, the one-shard path, the
checkpoints and the launcher.

The JAX ``TrainState`` at ``RunConfig(tp=N)`` is carried across
(``train_state_from_jax``), and the same numpy-made batches go through both
packages.  JAX's step runs in ONE subprocess (``_JAX_TP_STEPS``) with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``, at niceness 10, as
``src/repro/launch/train.py`` builds it: ``jax.jit(make_train_step)`` with
``in_shardings`` from the params' ``param_partition_specs(tp_size=N)`` (and
Adam's moments with them), the batch over ``"data"`` (``MESHES``): reduced
qwen2-1.5b on a ``(1, 2)`` and a ``(2, 2)`` host mesh, the ``(2, 2)`` one
also with ``sp`` (JAX under
``activation_sharding(activation_rules(False, sp=True))``); reduced
granite-moe-3b-a800m on ``(1, 2)`` (expert parallelism, 2 of its 4 experts
a shard) and ``(1, 8)`` (8 does not divide 4 experts: each expert's F is
split), each with ``sp`` off and on (the moe family trains over one data
shard).  The port runs over ``["cpu"] * (dp * N)``.  Tolerances, as
``tests/test_torch_train_parallel.py`` states them: losses 1e-5 relative;
after one step every param within Adam's first-step bound of JAX's from the
two sides' gradients (the port's at 1e-5 of each leaf's largest of JAX's);
after two steps within 1 % of the summed learning rate.
"""
from __future__ import annotations

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
from repro.runtime.checkpoint import CheckpointManager as JCheckpointManager
from repro.train import loop as j_loop
from repro.train import optim as j_opt
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import registry
from repro_torch.parallel import collectives, sharding
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.train import loop
from repro_torch.train import optim as t_opt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, MOE, TP = "qwen2-1.5b", "granite-moe-3b-a800m", 2
PEAK_LR, WARMUP, TOTAL, EPS = 1e-3, 2, 5, 1e-8
B, S, STEPS = 4, 16, 2
GRAD_FRAC = 1e-5
# (name, arch, data shards, model shards, sp)
MESHES = [("1x2", ARCH, 1, TP, False), ("2x2", ARCH, 2, TP, False),
          ("2x2_sp", ARCH, 2, TP, True),
          ("moe_1x2", MOE, 1, 2, False), ("moe_1x2_sp", MOE, 1, 2, True),
          ("moe_1x8", MOE, 1, 8, False), ("moe_1x8_sp", MOE, 1, 8, True)]


def _lr(step):
    return float(t_opt.warmup_cosine_schedule(PEAK_LR, WARMUP, TOTAL)(step))


TWO_STEP_ATOL = 0.01 * sum(_lr(i) for i in range(1, STEPS + 1))


def _optimizer(m):
    return m.adamw(m.warmup_cosine_schedule(PEAK_LR, WARMUP, TOTAL),
                   weight_decay=0.01, max_grad_norm=1.0)


def _batch(vocab, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


_JAX_TP_STEPS = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
sys.path.insert(0, {tests!r})
from test_torch_train_tp import MESHES, STEPS, _batch, _optimizer
from repro.configs import get_config
from repro.configs.base import RunConfig
from repro.models import registry
from repro.parallel import sharding as shd
from repro.train import loop, optim

out = {{}}
leaves = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]
for name, arch, dp, tp, sp in MESHES:
    cfg = registry.reduced_config(get_config(arch))
    run = RunConfig(tp=tp, sp=sp)
    opt = _optimizer(optim)
    state = loop.init_train_state(jax.random.PRNGKey(0), cfg, run, opt)
    mesh = jax.make_mesh((dp, tp), ("data", "model"),
                         devices=jax.devices()[:dp * tp],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    pspecs = shd.param_partition_specs(state.params, tp_size=tp)
    specs = loop.TrainState(params=pspecs, opt=type(state.opt)(
        step=P(), mu=pspecs, nu=pspecs), gc=None, step=P())
    shards = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                    is_leaf=lambda s: isinstance(s, P))
    bspecs = {{"tokens": P(("data",), None), "labels": P(("data",), None)}}
    rules = shd.activation_rules(False, sp=True) if sp else None
    with mesh, shd.activation_sharding(rules):
        step = jax.jit(loop.make_train_step(cfg, run, opt),
                       in_shardings=(shards(specs), shards(bspecs)),
                       out_shardings=(shards(specs), None))
        grad = jax.jit(jax.grad(lambda p, b: registry.get_model(
            cfg).train_loss(p, cfg, run, b)),
            in_shardings=(shards(pspecs), shards(bspecs)))
        state = jax.device_put(state, shards(specs))
        b0 = {{k: jnp.asarray(v) for k, v in _batch(cfg.vocab, 0).items()}}
        for i, g in enumerate(leaves(grad(state.params, b0))):
            out[f"{{name}}/grad/{{i}}"] = g
        for s in range(STEPS):
            batch = {{k: jnp.asarray(v)
                     for k, v in _batch(cfg.vocab, s).items()}}
            state, m = step(state, batch)
            out[f"{{name}}/loss/{{s}}"] = np.asarray(m["loss"])
            for i, x in enumerate(leaves(state.params)):
                out[f"{{name}}/params{{s}}/{{i}}"] = x
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_tp_steps") / "out.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        # at a lower priority: other tests' stage deadlines keep the CPU
        ["nice", "-n", "10", sys.executable, "-c",
         _JAX_TP_STEPS.format(tests=os.path.join(REPO, "tests")), path],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(path) as f:
        return dict(f)


def _cfg(arch=ARCH):
    return registry.reduced_config(get_config(arch))


@pytest.fixture(scope="module")
def cfg():
    return _cfg()


def _state(sp=False, arch=ARCH, tp=TP):
    """The JAX package's seeded ``TrainState`` at ``tp``, carried
    across."""
    jcfg = j_registry.reduced_config(j_get_config(arch))
    j_state = j_loop.init_train_state(jax.random.PRNGKey(0), jcfg,
                                      JRunConfig(tp=tp, sp=sp),
                                      _optimizer(j_opt))
    return registry.train_state_from_jax(jax.device_get(j_state), "cpu")


def _mesh(dp, devices=None, tp=TP):
    return make_mesh((dp, tp), ("data", "model"),
                     devices or ["cpu"] * (dp * tp))


def _paths(tree, prefix=""):
    """Each leaf's path, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def _leaves(tree):
    return [x.detach().numpy() for x in t_opt.tree_leaves(tree)]


def _whole(tree):
    return _leaves(sharding.unshard_params(tree))


def _saved(out, prefix, n):
    return [out[f"{prefix}/{i}"] for i in range(n)]


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


# ---------------------------------------------------------------------------
# the step against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,arch,dp,tp,sp", MESHES,
                         ids=[m[0] for m in MESHES])
def test_tp_step_matches_jax_launcher_step(jax_steps, name, arch, dp, tp, sp):
    """The gradient of each leaf (the moe family's router, replicated, and
    its experts, split by expert or by F, among them) at 1e-5 of its
    largest entry, then two steps, against JAX's."""
    cfg = _cfg(arch)
    run = RunConfig(tp=tp, sp=sp)
    opt = _optimizer(t_opt)
    state = _state(sp, arch, tp)
    before = _leaves(state.params)
    paths = _paths(state.params)
    mesh = _mesh(dp, tp=tp)
    step = loop.make_train_step(cfg, run, opt, mesh=mesh)
    sharded = loop.shard_train_state(state, mesh)
    _, g = loop.tensor_parallel_value_and_grad(cfg, run, mesh)(
        sharded.params, _batch(cfg.vocab, 0))
    g_tp = _whole(g)
    g_jax = _saved(jax_steps, f"{name}/grad", len(before))
    if arch == MOE:
        assert {"layers/moe/router", "layers/moe/w_gate"} <= set(paths)
    for path, a, b in zip(paths, g_tp, g_jax):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=GRAD_FRAC * np.abs(b).max(),
                                   err_msg=path)
    for s in range(STEPS):
        state, m = step(state, _batch(cfg.vocab, s))
        assert loop.is_sharded(state.params)
        np.testing.assert_allclose(float(m["loss"]),
                                   jax_steps[f"{name}/loss/{s}"], rtol=1e-5)
        got = _whole(state.params)
        want = _saved(jax_steps, f"{name}/params{s}", len(before))
        if s == 0:
            for path, p, a, b, x, y in zip(paths, before, got, want,
                                           _clipped(g_jax), _clipped(g_tp)):
                assert np.all(np.abs(a - b) <= _first_step_bound(
                    p, x, y, _lr(1))), path
        else:
            # the later steps add at most TWO_STEP_ATOL to what the first
            # step put between the two sides (a gradient entry near Adam's
            # eps moves its param by up to lr either way, within the first
            # step's bound)
            for path, a, b, a1, b1 in zip(paths, got, want, first_got,
                                          first_want):
                assert np.all(np.abs(a - b)
                              <= np.abs(a1 - b1) + TWO_STEP_ATOL), path
        if s == 0:
            first_got, first_want = got, want


def test_one_model_shard_is_the_one_device_step_bit_for_bit(cfg):
    run, opt = RunConfig(), _optimizer(t_opt)
    state = registry.train_state_from_jax(jax.device_get(
        j_loop.init_train_state(jax.random.PRNGKey(0), j_registry.
                                reduced_config(j_get_config(ARCH)),
                                JRunConfig(), _optimizer(j_opt))), "cpu")
    a = b = state
    mesh = make_mesh((1, 1), ("data", "model"), ["cpu"])
    for s in range(STEPS):
        a, ma = loop.make_train_step(cfg, run, opt, mesh=mesh)(
            a, _batch(cfg.vocab, s))
        b, mb = loop.make_train_step(cfg, run, opt)(b, _batch(cfg.vocab, s))
        assert torch.equal(ma["loss"], mb["loss"])
    for x, y in zip(_leaves(a), _leaves(b)):
        np.testing.assert_array_equal(x, y)


# the run configs under TP, each against the one-device step of the same
# RunConfig: (fields, microbatches)
RUN_CASES = {"remat": (dict(remat=True), 1),
             "bf16_remat": (dict(compute_dtype="bfloat16", remat=True), 1),
             "bf16_params_early": (dict(param_dtype="bfloat16",
                                        compute_dtype="bfloat16",
                                        cast_params_early=True), 1),
             "microbatches": ({}, 2)}
# bf16 compute: each matmul's bf16 result rounds after sums in another
# order (the shards' partial sums), and the mean over B x S tokens averages
# the roundings down: a quarter of bf16's relative step of 2^-8, as
# tests/test_torch_run_config.py holds bf16 against JAX
BF16_LOSS_RTOL = 1e-3


@pytest.mark.parametrize("name", list(RUN_CASES))
def test_run_configs_keep_their_meaning_under_tp(cfg, name):
    """``remat``, bf16 compute, bf16 params with ``cast_params_early`` and
    ``microbatches`` under TP: one step against the one-device step of the
    same ``RunConfig``, the loss at 1e-5 relative (fp32) or
    ``BF16_LOSS_RTOL``, every new param within Adam's first-step bound from
    the two sides' gradients, with two spacings of the param's own dtype
    (a bf16 param rounds to 8 bits)."""
    fields, micro = RUN_CASES[name]
    run, opt = RunConfig(tp=TP, **fields), _optimizer(t_opt)
    state = loop.init_train_state(torch.Generator().manual_seed(0), cfg, run,
                                  opt, "cpu")
    batch = _batch(cfg.vocab, 0)
    mesh = _mesh(1)
    one, m_one = loop.make_train_step(cfg, run, opt, microbatches=micro)(
        state, batch)
    tp_new, m_tp = loop.make_train_step(cfg, run, opt, microbatches=micro,
                                        mesh=mesh)(state, batch)
    np.testing.assert_allclose(
        float(m_tp["loss"]), float(m_one["loss"]),
        rtol=BF16_LOSS_RTOL if run.compute_dtype == "bfloat16" else 1e-5)
    _, g_one = loop.value_and_grad(cfg, run, micro)(state.params, batch)
    _, g_tp = loop.tensor_parallel_value_and_grad(cfg, run, mesh, micro)(
        loop.shard_train_state(state, mesh).params, batch)
    f32 = [x.float().numpy() for x in t_opt.tree_leaves(state.params)]
    for p, a, b, gj, gt in zip(
            f32, [x.float().numpy() for x in t_opt.tree_leaves(one.params)],
            [x.float().numpy() for x in t_opt.tree_leaves(
                sharding.unshard_params(tp_new.params))],
            _clipped([x.float().numpy() for x in t_opt.tree_leaves(g_one)]),
            _clipped([x.float().numpy() for x in t_opt.tree_leaves(
                sharding.unshard_params(g_tp))])):
        bound = _first_step_bound(p, gj, gt, _lr(1))
        if run.param_dtype == "bfloat16":
            top = np.abs(p.astype(np.float64)) + _lr(1)
            bound = bound + 2 * np.exp2(np.floor(np.log2(top)) - 7)
        assert np.all(np.abs(b - a) <= bound)


# ---------------------------------------------------------------------------
# replicated leaves
# ---------------------------------------------------------------------------

# (id, arch, model shards, sp, devices): the row's shards hold a replicated
# leaf as one tensor ("cpu" repeated) or as distinct copies ("cpu" and
# "cpu:0", two device objects of the one CPU)
REPLICATED_CASES = [
    ("one_tensor", ARCH, TP, False, ["cpu"] * 2),
    ("distinct_copies", ARCH, TP, False, ["cpu", "cpu:0"]),
    ("moe_1x2", MOE, 2, False, ["cpu"] * 2),
    ("moe_1x2_sp_distinct", MOE, 2, True, ["cpu", "cpu:0"]),
    ("moe_1x8_distinct", MOE, 8, False, ["cpu", "cpu:0"] * 4),
    ("moe_1x8_sp", MOE, 8, True, ["cpu"] * 8),
]


@pytest.mark.parametrize("arch,tp,sp,devices",
                         [c[1:] for c in REPLICATED_CASES],
                         ids=[c[0] for c in REPLICATED_CASES])
def test_replicated_leaf_gets_every_shards_part(arch, tp, sp, devices):
    """``ln1``'s scale (and the moe family's router) is replicated over the
    model axis: its gradient is the sum of every shard's part (autograd's
    where the shards hold one tensor, the model-axis all-reduce where they
    hold copies), the one-device gradient; one shard's part alone is not.
    The all-reduces logged are the forward's and, with distinct copies,
    one model-axis sum for each replicated leaf."""
    cfg = _cfg(arch)
    run = RunConfig(tp=tp, sp=sp)
    state = _state(sp, arch, tp)
    batch = _batch(cfg.vocab, 0)
    _, g_one = loop.value_and_grad(cfg, run)(state.params, batch)
    mesh = make_mesh((1, tp), ("data", "model"), devices)
    sharded = loop.shard_train_state(state, mesh)
    collectives.LOG.reset()
    with torch.no_grad():
        registry.get_model(cfg).train_loss(
            loop.model_shards(sharded.params, mesh), cfg, run,
            {k: torch.as_tensor(v) for k, v in batch.items()})
    forward = collectives.LOG.summary()["counts"].get("all-reduce", 0)
    collectives.LOG.reset()
    _, g = loop.tensor_parallel_value_and_grad(cfg, run, mesh)(
        sharded.params, batch)
    reduced = collectives.LOG.summary()["counts"].get("all-reduce", 0)
    names = [("layers", "ln1", "scale")]
    if arch == MOE:
        names.append(("layers", "moe", "router"))
    for name in names:
        leaf, want = g, g_one
        for k in name:
            leaf, want = leaf[k], want[k]
        owners = leaf.owners()
        assert len(owners) == len(set(devices))
        want = want.numpy()
        for _, piece in owners:
            np.testing.assert_allclose(piece.numpy(), want, rtol=0,
                                       atol=GRAD_FRAC * np.abs(want).max(),
                                       err_msg="/".join(name))
    specs = sharding.param_partition_specs(state.params, tp_size=tp)
    replicated = sum("model" not in tuple(sp) for sp in
                     _spec_leaves(specs))
    assert reduced == forward + (replicated if len(set(devices)) > 1 else 0)
    if not sp:
        # the embedding, 2 a layer, the CE's 2
        assert forward == 1 + 2 * cfg.n_layers + 2


def _spec_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    return [tree]


def test_data_axis_mean_reduces_each_slice_once(cfg):
    """Over a (2, 2) mesh of one device the rows' gradients are averaged
    once for each slice: the logged all-reduces are each row's forward's,
    then one for each model shard, of the params' bytes (every sharded
    leaf's slices and every replicated leaf once) and the loss's."""
    run = RunConfig(tp=TP)
    state = _state()
    batch = _batch(cfg.vocab, 0)
    mesh = _mesh(2)
    sharded = loop.shard_train_state(state, mesh)
    collectives.LOG.reset()
    with torch.no_grad():
        for r in range(2):
            registry.get_model(cfg).train_loss(
                loop.model_shards(sharded.params, mesh, r), cfg, run,
                {k: torch.as_tensor(v[r * B // 2:(r + 1) * B // 2])
                 for k, v in batch.items()})
    forward = collectives.LOG.summary()
    collectives.LOG.reset()
    loop.tensor_parallel_value_and_grad(cfg, run, mesh)(sharded.params, batch)
    logged = collectives.LOG.summary()
    param_bytes = sum(x.numel() * x.element_size()
                      for x in t_opt.tree_leaves(state.params))
    assert logged["counts"]["all-reduce"] == (
        forward["counts"]["all-reduce"] + TP)
    assert logged["bytes"]["all-reduce"] == (
        forward["bytes"]["all-reduce"] + param_bytes + 4)


def test_global_norm_counts_each_slice_once(cfg):
    """The step clips by the norm of every sharded leaf's pieces and every
    replicated leaf once, whatever the copies: the one-device norm."""
    run, opt = RunConfig(tp=TP), _optimizer(t_opt)
    state = _state()
    batch = _batch(cfg.vocab, 0)
    _, m_one = loop.make_train_step(cfg, run, opt)(state, batch)
    for devices in (["cpu"] * 4, ["cpu", "cpu:0", "cpu", "cpu:0"]):
        _, m = loop.make_train_step(cfg, run, opt, mesh=_mesh(2, devices))(
            state, batch)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(m_one["grad_norm"]), rtol=1e-5)


# ---------------------------------------------------------------------------
# checkpoints and the launcher
# ---------------------------------------------------------------------------

def test_checkpoints_cross_between_tp_and_one_device(cfg, tmp_path):
    """A TP state saves whole arrays (npz-v1), which restore one-device;
    a one-device and a JAX-written step restore into a TP run, which then
    steps as the TP run that never stopped."""
    run, opt = RunConfig(tp=TP), _optimizer(t_opt)
    mesh = _mesh(1)
    step = loop.make_train_step(cfg, run, opt, mesh=mesh)
    state = _state()
    tp_state, _ = step(state, _batch(cfg.vocab, 0))
    ck = CheckpointManager(str(tmp_path / "tp"), device="cpu")
    ck.save(1, tp_state, blocking=True)
    _, restored = ck.restore()
    assert not loop.is_sharded(restored.params)
    whole = loop.unshard_train_state(tp_state)
    for x, y in zip(_leaves(restored), _leaves(whole)):
        np.testing.assert_array_equal(x, y)
    want, _ = step(tp_state, _batch(cfg.vocab, 1))
    again, _ = step(loop.shard_train_state(restored, mesh),
                    _batch(cfg.vocab, 1))
    for x, y in zip(_whole(again.params), _whole(want.params)):
        np.testing.assert_array_equal(x, y)
    # one-device and JAX-written steps restore into the TP run
    ck1 = CheckpointManager(str(tmp_path / "one"), device="cpu")
    ck1.save(0, state, blocking=True)
    jcfg = j_registry.reduced_config(j_get_config(ARCH))
    j_state = j_loop.init_train_state(jax.random.PRNGKey(0), jcfg,
                                      JRunConfig(tp=TP), _optimizer(j_opt))
    JCheckpointManager(str(tmp_path / "jax")).save(0, j_state,
                                                   blocking=True)
    first = _whole(tp_state.params)
    for d in ("one", "jax"):
        _, st = CheckpointManager(str(tmp_path / d), device="cpu").restore()
        got, _ = step(loop.shard_train_state(st, mesh), _batch(cfg.vocab, 0))
        for x, y in zip(_whole(got.params), first):
            np.testing.assert_array_equal(x, y)


def _cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=timeout)


def test_launcher_trains_with_tp_and_resumes_one_device(tmp_path):
    out = _cli("--arch", "qwen2-1.5b", "--reduced", "--tp", "2", "--device",
               "cpu,cpu", "--steps", "2", "--batch", "4", "--seq", "32",
               "--ckpt", str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert "done: steps 0->2" in out.stdout
    again = _cli("--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
                 "--steps", "1", "--batch", "4", "--seq", "32", "--ckpt",
                 str(tmp_path), "--resume")
    assert again.returncode == 0, again.stderr
    assert "resumed at step 2" in again.stdout


def test_launcher_trains_moe_with_tp(tmp_path):
    """Expert parallelism through the launcher: reduced granite over two
    model shards on the CPU (each 2 of the 4 experts)."""
    out = _cli("--arch", "granite-moe-3b-a800m", "--reduced", "--tp", "2",
               "--device", "cpu,cpu", "--steps", "2", "--batch", "4",
               "--seq", "32", "--ckpt", str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert "done: steps 0->2" in out.stdout


# gradient compression under --tp, on each family the launcher trains
# (tests/test_torch_train_tp_compress.py holds the step to JAX's)
@pytest.mark.parametrize("arch,mode", [("mamba2-370m", "gae"),
                                       ("recurrentgemma-9b", "pca_ef"),
                                       ("qwen2-1.5b", "pca_ef")],
                         ids=["ssm_gae", "hybrid_pca_ef", "dense_pca_ef"])
def test_launcher_compresses_under_tp_and_resumes(arch, mode, tmp_path):
    """``--tp 2 --grad-compression`` trains, and a run cut at step 2 and
    resumed ends at step 4 with the uninterrupted run's state, bit for
    bit: params, Adam's moments and the compression state (the warmup
    of 20 steps makes the learning rate the same whatever ``--steps``)."""
    # one thread each: two runs at once beside the suite's workers, whose
    # threads would otherwise spin against each other in gae's eigh
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
            "--reduced", "--tp", "2", "--device", "cpu,cpu", "--batch", "2",
            "--seq", "32", "--grad-compression", mode]
    procs = [subprocess.Popen(args + ["--steps", str(n), "--ckpt",
                                      str(tmp_path / d)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=REPO)
             for n, d in ((4, "whole"), (2, "cut"))]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert "done: steps 0->4" in outs[0][0]
    again = subprocess.run(args + ["--steps", "2", "--ckpt",
                                   str(tmp_path / "cut"), "--resume"],
                           capture_output=True, text=True, env=env, cwd=REPO,
                           timeout=300)
    assert again.returncode == 0, again.stderr
    assert "resumed at step 2" in again.stdout
    assert "done: steps 2->4" in again.stdout
    (s_a, a), (s_b, b) = (CheckpointManager(str(tmp_path / d),
                                            device="cpu").restore()
                          for d in ("whole", "cut"))
    assert s_a == s_b == 4
    assert a.gc is not None if mode == "pca_ef" else a.gc is None
    for x, y in zip(_leaves(a), _leaves(b)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("args,says", [
    (("--arch", "granite-moe-3b-a800m", "--tp", "2", "--device",
      "cpu,cpu,cpu,cpu"), "divergence 10"),
], ids=["moe_2x2"])
def test_launcher_refusals_under_tp_name_the_roadmap(args, says):
    out = _cli(*args, "--reduced", "--steps", "1", "--batch", "4", "--seq",
               "16", timeout=120)
    assert out.returncode == 2
    assert says in out.stderr and "ROADMAP.md" in out.stderr
