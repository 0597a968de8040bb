"""The port's tensor-parallel train step of the ssm, hybrid, vlm and audio
families against the JAX package's launcher-style jitted step, on the CPU,
and what goes with it: the replicated leaves' gradients, ``remat`` under
TP, that ``check_tensor_parallel`` takes every family, and the launcher.

The JAX ``TrainState`` at ``RunConfig(tp=N)``, its params perturbed as
``tests/test_torch_tp_families.py`` perturbs them (every leaf whose init is
a constant), is carried across (``train_state_from_jax``), and the same
numpy-made batches (with the vlm's vision embeddings and whisper's frames)
go through both packages.  JAX's steps run in two subprocesses at once
(``_JAX_TP_STEPS``, half the cases each) with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``, at niceness 10, as
``src/repro/launch/train.py`` builds the step: ``jax.jit(make_train_step)``
with ``in_shardings`` from the params' ``param_partition_specs(tp_size=N)``
(and Adam's moments with them) on a ``(1, N)`` host mesh, for reduced
mamba2-370m at tp 2 and 4, recurrentgemma-9b, llama-3.2-vision-11b and
whisper-medium at tp 2, each with ``sp`` off and on.  Tolerances, as
``tests/test_torch_train_tp.py`` states them: the gradient of each leaf
within 1e-5 of its largest entry of JAX's (the replicated leaves, whose
gradient is a sum over the shards, and the B and C columns of
``ssd/in_proj`` named); losses 1e-5 relative; after one step every param
within Adam's first-step bound of the port's one-device step (from the two
steps' own gradients), and of JAX's step with 1 % of the learning rate
beside it (JAX's step differentiates inside its own jit, whose rounding
can differ from the separately jitted gradient the bound is read from, and
where a gradient entry is near Adam's eps a step moves with it at up to
lr / eps); after two steps within 1 % of the summed learning rate.
whisper's key biases ``bk`` have a gradient of 0 in exact arithmetic
(``tests/test_torch_whisper.py``): held below 1e-6 of the largest
gradient, and after two steps within the summed learning rate.
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
from repro.train import loop as j_loop
from repro.train import optim as j_opt
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import registry, ssd
from repro_torch.parallel import sharding
from repro_torch.train import loop
from repro_torch.train import optim as t_opt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_tp_families import _extra, _perturbed  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_LR, WARMUP, TOTAL, EPS = 1e-3, 2, 5, 1e-8
B, S, STEPS = 2, 16, 2
GRAD_FRAC, ZERO_GRAD_FRAC = 1e-5, 1e-6
# (name, arch, model shards, sp)
CASES = [(f"{a}-tp{t}{'-sp' if sp else ''}", a, t, sp)
         for a, t in (("mamba2-370m", 2), ("mamba2-370m", 4),
                      ("recurrentgemma-9b", 2), ("llama-3.2-vision-11b", 2),
                      ("whisper-medium", 2))
         for sp in (False, True)]
# replicated over the model axis, each gradient a sum of every shard's part
REPLICATED = {
    "ssm": ["layers/ssd/conv_b", "layers/ln/scale", "final_norm/scale"],
    "hybrid": ["triples/rec1/lru/alpha", "triples/rec2/conv/b",
               "tail/conv/b", "tail/lru/alpha", "triples/attn_layer/ln2/scale"],
    "vlm": ["groups/cross/gate_attn", "groups/cross/gate_mlp",
            "groups/selfs/ln1/scale", "vision_proj/w"],
    "audio": ["dec_layers/mlp/b_in", "dec_layers/mlp/b_out",
              "enc_layers/mlp/b_in", "enc_layers/mlp/b_out",
              "dec_layers/ln3/bias", "enc_final_ln/scale"]}


def _lr(step):
    return float(t_opt.warmup_cosine_schedule(PEAK_LR, WARMUP, TOTAL)(step))


SUMMED_LR = sum(_lr(i) for i in range(1, STEPS + 1))
TWO_STEP_ATOL = 0.01 * SUMMED_LR
FIRST_STEP_ATOL = 0.01 * _lr(1)


def _optimizer(m):
    return m.adamw(m.warmup_cosine_schedule(PEAK_LR, WARMUP, TOTAL),
                   weight_decay=0.01, max_grad_norm=1.0)


def _batch(cfg, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32), **_extra(cfg, B)}


def _j_state(arch, tp, sp):
    """The JAX package's seeded ``TrainState`` at ``tp``, its params
    perturbed (numpy leaves)."""
    jcfg = j_registry.reduced_config(j_get_config(arch))
    state = jax.device_get(j_loop.init_train_state(
        jax.random.PRNGKey(0), jcfg, JRunConfig(tp=tp, sp=sp),
        _optimizer(j_opt)))
    return state._replace(params=_perturbed(state.params))


_JAX_TP_STEPS = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
sys.path.insert(0, {tests!r})
from test_torch_train_tp_families import (CASES, STEPS, _batch, _j_state,
                                          _optimizer)
from repro.configs import get_config
from repro.configs.base import RunConfig
from repro.models import registry
from repro.parallel import sharding as shd
from repro.train import loop, optim

out = {{}}
leaves = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]
for name, arch, tp, sp in (c for c in CASES if c[0] in sys.argv[2:]):
    cfg = registry.reduced_config(get_config(arch))
    run = RunConfig(tp=tp, sp=sp)
    opt = _optimizer(optim)
    state = jax.tree.map(jnp.asarray, _j_state(arch, tp, sp))
    mesh = jax.make_mesh((1, tp), ("data", "model"),
                         devices=jax.devices()[:tp],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    pspecs = shd.param_partition_specs(state.params, tp_size=tp)
    specs = loop.TrainState(params=pspecs, opt=type(state.opt)(
        step=P(), mu=pspecs, nu=pspecs), gc=None, step=P())
    shards = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                    is_leaf=lambda s: isinstance(s, P))
    bspecs = {{k: P(("data",), *([None] * (v.ndim - 1)))
              for k, v in _batch(cfg, 0).items()}}
    rules = shd.activation_rules(False, sp=True) if sp else None
    train_step = loop.make_train_step(cfg, run, opt)
    grad = jax.grad(lambda p, b: registry.get_model(cfg).train_loss(
        p, cfg, run, b))
    with mesh, shd.activation_sharding(rules):
        # the step and the gradient of its batch in one program: one compile
        step = jax.jit(lambda st, b: (*train_step(st, b), grad(st.params, b)),
                       in_shardings=(shards(specs), shards(bspecs)),
                       out_shardings=(shards(specs), None, None))
        state = jax.device_put(state, shards(specs))
        for s in range(STEPS):
            batch = {{k: jnp.asarray(v) for k, v in _batch(cfg, s).items()}}
            state, m, g = step(state, batch)
            if s == 0:
                for i, x in enumerate(leaves(g)):
                    out[f"{{name}}/grad/{{i}}"] = x
            out[f"{{name}}/loss/{{s}}"] = np.asarray(m["loss"])
            for i, x in enumerate(leaves(state.params)):
                out[f"{{name}}/params{{s}}/{{i}}"] = x
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    """JAX's gradients, losses and params of every case, in two
    subprocesses at once (recurrentgemma-9b's compile is a third of the
    whole)."""
    tmp = tmp_path_factory.mktemp("jax_tp_family_steps")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    halves = [[c[0] for c in CASES if c[1] in ("recurrentgemma-9b",)
               or c[0].startswith("mamba2-370m-tp2")],
              [c[0] for c in CASES if c[1] in ("llama-3.2-vision-11b",
                                               "whisper-medium")
               or c[0].startswith("mamba2-370m-tp4")]]
    procs = [subprocess.Popen(
        # at a lower priority: other tests' stage deadlines keep the CPU
        ["nice", "-n", "10", sys.executable, "-c",
         _JAX_TP_STEPS.format(tests=os.path.join(REPO, "tests")),
         str(tmp / f"{i}.npz"), *names], stderr=subprocess.PIPE, text=True,
        env=env, cwd=REPO) for i, names in enumerate(halves)]
    out = {}
    try:
        for i, proc in enumerate(procs):
            err = proc.communicate(timeout=900)[1]
            assert proc.returncode == 0, err[-3000:]
            with np.load(tmp / f"{i}.npz") as f:
                out.update(f)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _cfg(arch):
    return registry.reduced_config(get_config(arch))


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


def _mesh(tp):
    return make_mesh((1, tp), ("data", "model"), ["cpu"] * tp)


# ---------------------------------------------------------------------------
# the step against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,arch,tp,sp", CASES, ids=[c[0] for c in CASES])
def test_tp_step_matches_jax_launcher_step(jax_steps, name, arch, tp, sp):
    cfg = _cfg(arch)
    run = RunConfig(tp=tp, sp=sp)
    state = registry.train_state_from_jax(_j_state(arch, tp, sp), "cpu")
    before = _leaves(state.params)
    paths = _paths(state.params)
    mesh = _mesh(tp)
    sharded = loop.shard_train_state(state, mesh)
    specs = sharding.param_partition_specs(state.params, tp_size=tp)
    for path in REPLICATED[cfg.family]:
        spec = specs
        for k in path.split("/"):
            spec = spec[k]
        assert path in paths and "model" not in tuple(spec), path
    _, g = loop.tensor_parallel_value_and_grad(cfg, run, mesh)(
        sharded.params, _batch(cfg, 0))
    g_tp = _whole(g)
    g_jax = _saved(jax_steps, f"{name}/grad", len(before))
    largest = max(np.abs(b).max() for b in g_jax)
    for path, a, b in zip(paths, g_tp, g_jax):
        if path.endswith("/bk"):
            assert max(np.abs(a).max(), np.abs(b).max()) \
                <= ZERO_GRAD_FRAC * largest, path
            continue
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=GRAD_FRAC * np.abs(b).max(),
                                   err_msg=path)
    if cfg.family == "ssm":
        # the columns of the one group's B and C, which every shard reads
        dm = ssd._dims(cfg)
        bc = slice(2 * dm["d_inner"],
                   2 * dm["d_inner"] + 2 * dm["G"] * dm["N"])
        a, b = (x[..., bc] for x in (g_tp[paths.index("layers/ssd/in_proj")],
                                     g_jax[paths.index("layers/ssd/in_proj")]))
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=GRAD_FRAC * np.abs(b).max())
    _, g_one = loop.value_and_grad(cfg, run)(state.params, _batch(cfg, 0))
    one, _ = loop.make_train_step(cfg, run, _optimizer(t_opt))(
        state, _batch(cfg, 0))
    step = loop.make_train_step(cfg, run, _optimizer(t_opt), mesh=mesh)
    for s in range(STEPS):
        state, m = step(state, _batch(cfg, s))
        assert loop.is_sharded(state.params)
        np.testing.assert_allclose(float(m["loss"]),
                                   jax_steps[f"{name}/loss/{s}"], rtol=1e-5)
        got = _whole(state.params)
        want = _saved(jax_steps, f"{name}/params{s}", len(before))
        if s == 0:
            for path, p, a, b, c, x, y, z in zip(
                    paths, before, got, want, _leaves(one.params),
                    _clipped(g_jax), _clipped(g_tp),
                    _clipped(_leaves(g_one))):
                assert np.all(np.abs(a - c) <= _first_step_bound(
                    p, z, y, _lr(1))), path
                assert np.all(np.abs(a - b) <= _first_step_bound(
                    p, x, y, _lr(1)) + FIRST_STEP_ATOL), path
            first_got, first_want = got, want
        else:
            for path, a, b, a1, b1 in zip(paths, got, want, first_got,
                                          first_want):
                bound = (SUMMED_LR if path.endswith("/bk")
                         else np.abs(a1 - b1) + TWO_STEP_ATOL)
                assert np.all(np.abs(a - b) <= bound), path


ONE_A_FAMILY = ["mamba2-370m", "recurrentgemma-9b", "llama-3.2-vision-11b",
                "whisper-medium"]


@pytest.mark.parametrize("arch", ONE_A_FAMILY)
def test_remat_is_bit_for_bit_under_tp(arch):
    """``remat`` recomputes each layer in the backward under the forward's
    activation rules: the TP loss and every gradient piece equal those of
    the TP step without it, bit for bit."""
    cfg = _cfg(arch)
    state = registry.train_state_from_jax(_j_state(arch, 2, True), "cpu")
    mesh = _mesh(2)
    params = loop.shard_train_state(state, mesh).params
    out = [loop.tensor_parallel_value_and_grad(
        cfg, RunConfig(tp=2, sp=True, remat=remat), mesh)(
            params, _batch(cfg, 0)) for remat in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(_whole(out[0][1]), _whole(out[1][1])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "whisper-medium"])
def test_replicated_leaves_over_distinct_copies(arch):
    """Over two device objects of the one CPU (``cpu``, ``cpu:0``) each
    shard holds its own copy of a replicated leaf, and the model-axis
    all-reduce sums their parts: the sliced ``alpha`` and ``conv/b``, and
    whisper's ``b_out``, which only shard 0 adds (the other copy's part is
    0), give one device's gradient."""
    cfg = _cfg(arch)
    run = RunConfig(tp=2)
    state = registry.train_state_from_jax(_j_state(arch, 2, False), "cpu")
    _, g_one = loop.value_and_grad(cfg, run)(state.params, _batch(cfg, 0))
    mesh = make_mesh((1, 2), ("data", "model"), ["cpu", "cpu:0"])
    _, g = loop.tensor_parallel_value_and_grad(cfg, run, mesh)(
        loop.shard_train_state(state, mesh).params, _batch(cfg, 0))
    paths = _paths(state.params)
    for path in REPLICATED[cfg.family]:
        leaf = g
        for k in path.split("/"):
            leaf = leaf[k]
        assert len(leaf.owners()) == 2, path
    g_one = _leaves(g_one)
    largest = max(np.abs(b).max() for b in g_one)
    for path, a, b in zip(paths, _whole(g), g_one):
        if path.endswith("/bk"):
            assert max(np.abs(a).max(), np.abs(b).max()) \
                <= ZERO_GRAD_FRAC * largest, path
            continue
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=GRAD_FRAC * np.abs(b).max(),
                                   err_msg=path)


def test_every_family_is_tensor_parallel():
    """``check_tensor_parallel`` takes every family at tp 2, with each
    gradient compression too."""
    for arch in ("qwen2-1.5b", "granite-moe-3b-a800m", *ONE_A_FAMILY):
        cfg = get_config(arch)
        registry.check_tensor_parallel(cfg, 2)
        for mode in ("none", "pca_ef", "gae"):
            loop.check_tensor_parallel(cfg, RunConfig(
                tp=2, gradient_compression=mode))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=timeout)


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_launcher_trains_with_tp_and_resumes_one_device(arch, tmp_path):
    """``--tp 2 --device cpu,cpu`` trains the reduced ssm and hybrid
    models; its checkpoint holds whole arrays and resumes on one device."""
    out = _cli("--arch", arch, "--reduced", "--tp", "2", "--device",
               "cpu,cpu", "--steps", "2", "--batch", "2", "--seq", "32",
               "--ckpt", str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert "done: steps 0->2" in out.stdout
    again = _cli("--arch", arch, "--reduced", "--device", "cpu", "--steps",
                 "1", "--batch", "2", "--seq", "32", "--ckpt", str(tmp_path),
                 "--resume")
    assert again.returncode == 0, again.stderr
    assert "resumed at step 2" in again.stdout
    assert "done: steps 2->3" in again.stdout


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-medium"])
def test_launcher_refuses_the_frontend_families_under_tp(arch):
    """The vlm and audio families' batches need a frontend the token
    pipeline does not make, with or without ``--tp``: exit 2."""
    out = _cli("--arch", arch, "--reduced", "--tp", "2", "--device",
               "cpu,cpu", "--steps", "1", timeout=120)
    assert out.returncode == 2
    assert "frontend" in out.stderr
