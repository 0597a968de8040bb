"""Gradient compression (``pca_ef``, ``gae``) under tensor parallelism: the
port's TP step against the JAX package's launcher-style jitted step, on the
CPU, and what goes with it: which leaves' blocks lie inside their pieces,
each slice in the covariance once, the checkpoints with the compression
state, the launcher.

The JAX ``TrainState`` at ``RunConfig(tp=N, gradient_compression=mode)``
(its ``pca_ef`` basis JAX's ``make_basis``), its params perturbed as
``tests/test_torch_tp_families.py`` perturbs them, is carried across
(``train_state_from_jax``), and the same numpy-made batches (with the
vlm's vision embeddings and whisper's frames) go through both packages.
JAX's steps run in three subprocesses at once (``_JAX_STEPS``), each with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` and at niceness 10,
as ``src/repro/launch/train.py`` builds the step: ``jax.jit(
make_train_step)`` with ``in_shardings`` from ``param_partition_specs(
tp_size=N)``, Adam's moments with them and the compression state
replicated, on a host mesh with ``AxisType.Auto`` axes (``CASES``):
reduced qwen2-1.5b on ``(1, 2)``, ``(2, 2)`` and ``(2, 2)`` with ``sp``,
reduced granite-moe-3b-a800m on ``(1, 2)`` and ``(1, 8)``, and reduced
mamba2-370m, recurrentgemma-9b, llama-3.2-vision-11b and whisper-medium on
``(1, 2)``, each with ``pca_ef`` and ``gae``.  Step 0 refreshes the
``pca_ef`` basis; step 1 does not.  The port runs over ``["cpu"] * (dp *
N)``.  Tolerances, as ``tests/test_torch_train_parallel.py`` states them
for each mode:

* the loss of step 0 at 1e-5 relative; of step 1 at 1e-4 (``pca_ef``) or
  1e-2 (``gae``, whose trajectories part after the first step);
* ``grad_compression`` at 1e-6 relative of JAX's (the whole leaves'
  counts in float32); ``grad_keep_frac`` at 1e-2;
* after one step every param within Adam's first-step bound of JAX's from
  the two sides' compressed gradients (JAX's computed in the same program
  as its step, from a separately taken gradient), or within the bound of
  any gradient within 1e-5 of the leaf's largest of the port's;
* ``pca_ef``'s error buffers after step 0 at 1e-5 of the gradient's
  largest entry of JAX's;
* after two steps, ``pca_ef``: every param within twice 1 % of the summed
  learning rate of JAX's beyond what the first step put between them;
  ``gae``: at most 60 % of the param elements past 1 % of the summed
  learning rate, every one within Adam's reach;
* ``gae``: every block of the compressed gradient within ``tau`` of the
  gradient (the realized-error check).
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
from repro_torch.models import registry, ssd
from repro_torch.parallel import collectives, sharding
from repro_torch.runtime import grad_compress as t_gc
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.train import loop
from repro_torch.train import optim as t_opt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_tp_families import _extra, _perturbed  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_LR, WARMUP, TOTAL, EPS = 1e-3, 2, 5, 1e-8
B, S, STEPS = 2, 16, 2
GC_FRAC, GAE_TAU, GAE_PARTED_FRAC, ZERO_GRAD_FRAC = 1e-5, 1e-3, 0.6, 1e-6
# pca_ef after two steps: the share of elements allowed past twice 1 % of
# the summed learning rate (beyond the first step's distance), where a
# compressed gradient entry near Adam's eps moves its param by up to lr
# either way; the port's one-device step parts from JAX's as far (at most
# 1.198e-03 on recurrentgemma-9b's embedding, 1e-4 of the elements)
PCA_PARTED_FRAC = 1e-3
# gae's kept coefficients, the selection's share of them (ROADMAP.md §3,
# divergence 7 aside)
GAE_KEEP_RTOL = 1e-2
# (name, arch, data shards, model shards, sp, mode): both modes on the
# dense (1, 2) mesh, one mode on each other mesh, so that each mode meets
# every kind of mesh and more than one family
CASES = [
    ("qwen-1x2-pca_ef", "qwen2-1.5b", 1, 2, False, "pca_ef"),
    ("qwen-1x2-gae", "qwen2-1.5b", 1, 2, False, "gae"),
    ("qwen-2x2-pca_ef", "qwen2-1.5b", 2, 2, False, "pca_ef"),
    ("qwen-2x2-sp-gae", "qwen2-1.5b", 2, 2, True, "gae"),
    ("moe-1x2-gae", "granite-moe-3b-a800m", 1, 2, False, "gae"),
    ("moe-1x8-pca_ef", "granite-moe-3b-a800m", 1, 8, False, "pca_ef"),
    ("ssm-1x2-gae", "mamba2-370m", 1, 2, False, "gae"),
    ("hybrid-1x2-pca_ef", "recurrentgemma-9b", 1, 2, False, "pca_ef"),
    ("vlm-1x2-gae", "llama-3.2-vision-11b", 1, 2, False, "gae"),
    ("audio-1x2-pca_ef", "whisper-medium", 1, 2, False, "pca_ef")]
# JAX's subprocesses, the cases each runs (recurrentgemma-9b's compile is
# the largest)
GROUPS = (("hybrid-1x2-pca_ef", "qwen-1x2-pca_ef", "moe-1x2-gae"),
          ("vlm-1x2-gae", "audio-1x2-pca_ef", "qwen-2x2-pca_ef"),
          ("ssm-1x2-gae", "moe-1x8-pca_ef", "qwen-2x2-sp-gae",
           "qwen-1x2-gae"))


def _lr(step):
    return float(t_opt.warmup_cosine_schedule(PEAK_LR, WARMUP, TOTAL)(step))


SUMMED_LR = sum(_lr(i) for i in range(1, STEPS + 1))
TWO_STEP_ATOL = 0.01 * SUMMED_LR


def _optimizer(m):
    return m.adamw(m.warmup_cosine_schedule(PEAK_LR, WARMUP, TOTAL),
                   weight_decay=0.01, max_grad_norm=1.0)


def _batch(cfg, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32), **_extra(cfg, B)}


def _j_state(arch, tp, sp, mode):
    """The JAX package's seeded ``TrainState`` at ``tp`` with ``mode``'s
    compression state, its params perturbed (numpy leaves)."""
    jcfg = j_registry.reduced_config(j_get_config(arch))
    state = jax.device_get(j_loop.init_train_state(
        jax.random.PRNGKey(0), jcfg,
        JRunConfig(tp=tp, sp=sp, gradient_compression=mode),
        _optimizer(j_opt)))
    return state._replace(params=_perturbed(state.params))


_JAX_STEPS = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
sys.path.insert(0, {tests!r})
from test_torch_train_tp_compress import (CASES, STEPS, _batch, _j_state,
                                          _optimizer)
from repro.configs import get_config
from repro.configs.base import RunConfig
from repro.models import registry
from repro.parallel import sharding as shd
from repro.train import loop, optim

out = {{}}
leaves = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]
for name, arch, dp, tp, sp, mode in (c for c in CASES
                                     if c[0] in sys.argv[2:]):
    cfg = registry.reduced_config(get_config(arch))
    run = RunConfig(tp=tp, sp=sp, gradient_compression=mode)
    opt = _optimizer(optim)
    state = jax.tree.map(jnp.asarray, _j_state(arch, tp, sp, mode))
    mesh = jax.make_mesh((dp, tp), ("data", "model"),
                         devices=jax.devices()[:dp * tp],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    pspecs = shd.param_partition_specs(state.params, tp_size=tp)
    specs = loop.TrainState(params=pspecs, opt=type(state.opt)(
        step=P(), mu=pspecs, nu=pspecs),
        gc=None if state.gc is None else jax.tree.map(lambda _: P(),
                                                      state.gc),
        step=P())
    shards = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                    is_leaf=lambda s: isinstance(s, P))
    bspecs = {{k: P(("data",), *([None] * (v.ndim - 1)))
              for k, v in _batch(cfg, 0).items()}}
    rules = shd.activation_rules(False, sp=True) if sp else None
    with mesh, shd.activation_sharding(rules):
        step = jax.jit(loop.make_train_step(cfg, run, opt),
                       in_shardings=(shards(specs), shards(bspecs)),
                       out_shardings=(shards(specs), None))
        state = jax.device_put(state, shards(specs))
        for s in range(STEPS):
            batch = {{k: jnp.asarray(v) for k, v in _batch(cfg, s).items()}}
            state, m = step(state, batch)
            key = "grad_compression" if mode == "pca_ef" else "grad_keep_frac"
            out[f"{{name}}/metric/{{s}}"] = np.asarray(m[key])
            out[f"{{name}}/loss/{{s}}"] = np.asarray(m["loss"])
            for i, x in enumerate(leaves(state.params)):
                out[f"{{name}}/params{{s}}/{{i}}"] = x
            if s == 0 and mode == "pca_ef":
                for i, x in enumerate(leaves(state.gc.error)):
                    out[f"{{name}}/error/{{i}}"] = x
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    """JAX's results of every case, in three subprocesses at once."""
    tmp = tmp_path_factory.mktemp("jax_tp_compress_steps")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    assert sorted(n for g in GROUPS for n in g) == sorted(c[0] for c in CASES)
    procs = [subprocess.Popen(
        # at a lower priority: other tests' stage deadlines keep the CPU
        ["nice", "-n", "10", sys.executable, "-c",
         _JAX_STEPS.format(tests=os.path.join(REPO, "tests")),
         str(tmp / f"{i}.npz"), *names], stderr=subprocess.PIPE, text=True,
        env=env, cwd=REPO) for i, names in enumerate(GROUPS)]
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


def _widened_bound(p, g, frac, lr):
    """``tests/test_torch_train_parallel.py``'s: how far an Adam first
    step from ``p`` with any gradient within ``frac`` of the leaf's
    largest of ``g`` may land from the step with ``g``."""
    delta = frac * np.abs(g).max()
    g_min = np.maximum(np.abs(g) - delta, 0.0)
    return (lr * EPS / (g_min + EPS) ** 2 * delta
            + 8 * np.spacing(np.float32(lr)) + 2 * np.spacing(np.abs(p) + lr))


def _block_errs(g, gh, block=256):
    d = (gh.astype(np.float64) - g).reshape(-1)
    return np.linalg.norm(np.pad(d, (0, -d.size % block)).reshape(-1, block),
                          axis=1)


def _mesh(dp, tp, devices=None):
    return make_mesh((dp, tp), ("data", "model"),
                     devices or ["cpu"] * (dp * tp))


def _compressed(run, state, grads):
    """The gradients the optimizer takes (and the stats): ``grads``
    after the step's compression."""
    if run.gradient_compression == "pca_ef":
        gh, _, stats = t_gc.compress_update(grads, state.gc)
        return gh, stats
    return t_gc.gae_compress_grads(grads, tau=GAE_TAU)


# ---------------------------------------------------------------------------
# the step against JAX's
# ---------------------------------------------------------------------------

def _within_first_step(before, a_params, b_params, ga, gb, widen=0.0,
                       zero=()):
    """Every param of the two first steps within Adam's first-step bound
    from the compressed gradients ``ga`` and ``gb`` the two sides took, or
    with ``widen``, within the bound of any gradient within ``widen`` of
    the leaf's largest of ``gb`` (``ga`` None: not known); a leaf in
    ``zero`` (a gradient of 0 in exact arithmetic) within a step's
    reach."""
    ga = [None] * len(gb) if ga is None else _clipped(ga)
    for i, (p, a, b, x, y) in enumerate(zip(before, a_params, b_params, ga,
                                            _clipped(gb))):
        bound = _widened_bound(p, y, widen, _lr(1)) if widen else 0.0
        if x is not None:
            bound = np.maximum(bound, _first_step_bound(p, x, y, _lr(1)))
        if i in zero:
            bound = 2 * _lr(1)
        assert np.all(np.abs(b - a) <= bound), i


def _parted_within(a_params, b_params, atol, frac, zero=()):
    """At most ``frac`` of the elements past ``atol`` (per element: an
    array), every one within Adam's reach (twice the summed learning
    rate), as ``test_torch_train_parallel._trajectory_close`` holds
    ``gae``; a leaf in ``zero`` only within the summed learning rate."""
    parted = total = 0
    for i, (a, b, t) in enumerate(zip(a_params, b_params, atol)):
        d = np.abs(b - a)
        if i in zero:
            assert np.all(d <= SUMMED_LR), i
            continue
        assert np.all(d <= 2 * SUMMED_LR * (1 + 0.01 * np.abs(a)) + 1e-7), i
        parted += int(np.count_nonzero(d > t))
        total += d.size
    assert parted <= frac * total, parted / total


def _kept_between(kept, exact, other, total):
    """``gae``'s kept coefficients against another side's count
    ``other``: the port keeps a block whose realized error passes tau
    exact and counts ``block`` coefficients for it (ROADMAP.md §3,
    divergence 7), so ``other`` lies between the port's count without
    those blocks and with them, within ``GAE_KEEP_RTOL``."""
    lo = (kept - 256 * exact) * (1 - GAE_KEEP_RTOL)
    hi = kept * (1 + GAE_KEEP_RTOL)
    assert lo <= other <= hi, (kept / total, exact, other / total)


@pytest.mark.parametrize("name,arch,dp,tp,sp,mode", CASES,
                         ids=[c[0] for c in CASES])
def test_tp_compressed_step_matches_jax(jax_steps, name, arch, dp, tp, sp,
                                       mode):
    """The TP step with ``mode`` against JAX's step (module docstring) and
    against the port's one-device step, step 0 with each side's own
    compressed gradient."""
    cfg = _cfg(arch)
    run = RunConfig(tp=tp, sp=sp, gradient_compression=mode)
    opt = _optimizer(t_opt)
    state = registry.train_state_from_jax(_j_state(arch, tp, sp, mode),
                                          "cpu")
    before = _leaves(state.params)
    paths = _paths(state.params)
    n = len(before)
    mesh = _mesh(dp, tp)
    b0 = _batch(cfg, 0)
    _, g = loop.tensor_parallel_value_and_grad(cfg, run, mesh)(
        loop.shard_train_state(state, mesh).params, b0)
    gh, stats = _compressed(run, loop.shard_train_state(state, mesh), g)
    g, gh = _whole(g), _whole(gh)
    largest = max(np.abs(x).max() for x in g)
    # whisper's key biases: a gradient of 0 in exact arithmetic
    zero = {i for i, x in enumerate(g)
            if np.abs(x).max() <= ZERO_GRAD_FRAC * largest}
    assert all(paths[i].endswith("/bk") for i in zero), zero
    _, g_one = loop.value_and_grad(cfg, run)(state.params, b0)
    gh_one, stats_one = _compressed(run, state, g_one)
    one, m_one = loop.make_train_step(cfg, run, opt)(state, b0)
    if mode == "gae":
        for path, a, b in zip(paths, g, gh):
            assert _block_errs(a, b).max() <= GAE_TAU * (1 + 1e-5), path
        total = stats["total_elems"]
        assert total == stats_one["total_elems"]
        kept, exact = float(stats["kept_coeffs"]), float(stats["exact_blocks"])
        _kept_between(kept, exact, float(jax_steps[f"{name}/metric/0"])
                      * total, total)
        kept1, exact1 = (float(stats_one[k]) for k in ("kept_coeffs",
                                                        "exact_blocks"))
        _kept_between(kept, exact, kept1 - 256 * exact1, total)
    step = loop.make_train_step(cfg, run, opt, mesh=mesh)
    key = "grad_compression" if mode == "pca_ef" else "grad_keep_frac"
    for s in range(STEPS):
        state, m = step(state, _batch(cfg, s))
        assert loop.is_sharded(state.params)
        np.testing.assert_allclose(
            float(m["loss"]), jax_steps[f"{name}/loss/{s}"],
            rtol=1e-5 if s == 0 else (1e-4 if mode == "pca_ef" else 1e-2))
        if mode == "pca_ef":
            np.testing.assert_allclose(
                float(m[key]), jax_steps[f"{name}/metric/{s}"], rtol=1e-6)
            assert m[key] == m_one[key]
        got = _whole(state.params)
        want = _saved(jax_steps, f"{name}/params{s}", n)
        if s == 0:
            assert float(m[key]) == float(
                stats["compression" if mode == "pca_ef" else "keep_frac"])
            _within_first_step(before, _leaves(one.params), got,
                               _leaves(gh_one), gh)
            if mode == "pca_ef":
                _within_first_step(before, want, got, None, gh,
                                   widen=GC_FRAC, zero=zero)
                for i, (a, b) in enumerate(zip(
                        _whole(state.gc.error),
                        _saved(jax_steps, f"{name}/error", n))):
                    np.testing.assert_allclose(a, b, rtol=0,
                                               atol=GC_FRAC * largest,
                                               err_msg=paths[i])
            else:
                _parted_within(want, got, [0.01 * _lr(1)] * n,
                               GAE_PARTED_FRAC, zero)
            first_got, first_want = got, want
        elif mode == "pca_ef":
            _parted_within(want, got, [np.abs(a1 - b1) + 2 * TWO_STEP_ATOL
                                       for a1, b1 in zip(first_got,
                                                         first_want)],
                           PCA_PARTED_FRAC, zero)
        else:
            _parted_within(want, got, [TWO_STEP_ATOL] * n, GAE_PARTED_FRAC,
                           zero)
    assert int(state.step) == STEPS
    if mode == "pca_ef":
        assert int(state.gc.step) == STEPS
        assert isinstance(state.gc.basis, sharding.Sharded)


# ---------------------------------------------------------------------------
# the blocks of a piece
# ---------------------------------------------------------------------------

# (shape, spec, model shards): synthetic leaves cut as the partition rules
# cut them
PIECE_CASES = [
    ((2, 6, 1280), (None, None, "model"), 2),       # w_in-like, run 640
    ((2, 12, 2, 128), (None, None, "model", None), 2),   # wk-like, run 128
    ((2, 12, 4, 128), (None, None, "model", None), 2),   # run 256
    ((2, 12, 6, 128), (None, None, "model", None), 2),   # wq-like, run 384
    ((2, 4, 96), (None, "model", None), 2),         # run 192
    ((1024, 64), ("model", None), 2),               # embed-like rows
    ((8, 512), ("model", None), 4),                 # run 512
    ((3, 100), (None, None), 2),                    # replicated
    ((5, 8, 96), (None, "model", None), 8),         # run 96
]


@pytest.mark.parametrize("shape,spec,tp", PIECE_CASES,
                         ids=[f"{'x'.join(map(str, c[0]))}-tp{c[2]}"
                              for c in PIECE_CASES])
def test_blocks_inside_pieces_against_the_whole_leafs_blocks(shape, spec, tp):
    """A leaf's pieces hold whole-leaf blocks (``_blocked``'s rows, the
    last zero-padded) exactly where ``blocks_inside_pieces`` says so: then
    every row of a piece's ``reshape(-1, 256)`` is a row of the whole
    leaf's blocks and the pieces' rows are all of them; else some whole
    block straddles two pieces."""
    whole = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(
        shape) + 1
    leaf = sharding.shard_leaf(whole, spec, _mesh(1, tp))
    assert leaf.shape == shape
    blocks = t_gc._blocked(whole, 256)
    index = {tuple(r.tolist()): i for i, r in enumerate(blocks)}
    inside = t_gc.blocks_inside_pieces(leaf)
    run = t_gc.piece_run(leaf)
    assert inside == (run is None or run % 256 == 0)
    if run is None:
        return
    seen = []
    for _, piece in leaf.owners():
        if piece.numel() % 256:
            assert not inside
            return
        seen += [index.get(tuple(r.tolist()))
                 for r in piece.reshape(-1, 256)]
    assert (None not in seen and sorted(seen) == list(range(len(blocks)))) \
        == inside


def _meta_tree(shapes: dict):
    out: dict = {}
    for path, shape in shapes.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = torch.empty(shape, device="meta")
    return out


def test_full_width_leaves_aligned_and_misaligned():
    """At qwen2-1.5b's full width, tp 2, fp32, read from
    ``param_partition_specs``: the embedding (rows), ``wq`` and ``bq``
    (run 768), ``wo`` and ``w_out`` have their blocks inside their pieces;
    ``w_gate`` and ``w_in`` (cut on F: run 4480, 17.5 blocks), ``wk``,
    ``wv``, ``bk`` and ``bv`` (run 128) do not, 3 170 951 168 bytes
    gathered a step; the norms are replicated.  mamba2-370m's
    ``ssd/in_proj`` (run 2192) does not either."""
    cfg = get_config("qwen2-1.5b")
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    (H, KV), hd = cfg.padded_heads(2), cfg.resolved_head_dim
    tree = _meta_tree({
        "embed/w": (cfg.padded_vocab(2), D), "final_norm/scale": (D,),
        "layers/attn/wq": (L, D, H, hd), "layers/attn/wk": (L, D, KV, hd),
        "layers/attn/wv": (L, D, KV, hd), "layers/attn/wo": (L, H, hd, D),
        "layers/attn/bq": (L, H, hd), "layers/attn/bk": (L, KV, hd),
        "layers/attn/bv": (L, KV, hd), "layers/ln1/scale": (L, D),
        "layers/ln2/scale": (L, D), "layers/mlp/w_gate": (L, D, F),
        "layers/mlp/w_in": (L, D, F), "layers/mlp/w_out": (L, F, D)})
    mesh = make_mesh((1, 2), ("data", "model"), ["meta"] * 2)
    leaves = sharding.sharded_leaves(sharding.shard_params(tree, mesh, 2))
    kinds = dict(zip(_paths(tree), (t_gc._leaf_kind(x, 256)
                                    for x in leaves)))
    assert {p for p, k in kinds.items() if k == "piece"} == {
        "embed/w", "layers/attn/wq", "layers/attn/bq", "layers/attn/wo",
        "layers/mlp/w_out"}
    gathered = {p for p, k in kinds.items() if k == "gather"}
    assert gathered == {"layers/mlp/w_gate", "layers/mlp/w_in",
                        "layers/attn/wk", "layers/attn/wv", "layers/attn/bk",
                        "layers/attn/bv"}
    assert sum(4 * int(np.prod(x.shape)) for p, x in zip(_paths(tree), leaves)
               if p in gathered) == 3_170_951_168
    ssm = get_config("mamba2-370m")
    dm = ssd._dims(ssm)
    proj = 2 * dm["d_inner"] + 2 * dm["G"] * dm["N"] + dm["H"]
    leaf = sharding.shard_params(_meta_tree(
        {"layers/ssd/in_proj": (ssm.n_layers, ssm.d_model, proj)}), mesh,
        2)["layers"]["ssd"]["in_proj"]
    assert (leaf.shape, t_gc.piece_run(leaf)) == ((48, 1024, 4384), 2192)
    assert not t_gc.blocks_inside_pieces(leaf)


# ---------------------------------------------------------------------------
# each slice once
# ---------------------------------------------------------------------------

# a replicated leaf, one whose blocks lie inside its pieces and one that is
# gathered: (shape, spec)
ONCE_LEAVES = {"a_rep": ((3, 100), (None, None)),
               "b_inside": ((8, 512), ("model", None)),
               "c_gathered": ((2, 6, 1280), (None, None, "model"))}


def _once_tree(devices):
    gen = torch.Generator().manual_seed(3)
    whole = {k: torch.randn(shape, generator=gen)
             for k, (shape, _) in ONCE_LEAVES.items()}
    mesh = _mesh(1, 2, devices)
    pieces = {k: sharding.shard_leaf(whole[k], ONCE_LEAVES[k][1], mesh)
              for k in whole}
    return whole, pieces, mesh


@pytest.mark.parametrize("devices", [["cpu", "cpu"], ["cpu", "cpu:0"]],
                         ids=["one_tensor", "distinct_copies"])
def test_each_slice_enters_the_covariance_once(devices, monkeypatch):
    """``pca_ef`` on a refresh step and ``gae`` over (1, 2): the covariance
    that the basis comes from is the whole gradient's, each replicated or
    gathered leaf in it once whatever its copies (not twice: that
    covariance is another), and one all-reduce of (256, 256) fp32 sums
    it; the compressed gradient and the stats are the one-device ones.
    ``gae``: each leaf's covariance is the whole leaf's, the split leaf's
    summed by one all-reduce of the stacked covariances."""
    whole, pieces, mesh = _once_tree(devices)
    seen = []
    top = t_gc._top_eigvecs
    monkeypatch.setattr(t_gc, "_top_eigvecs",
                        lambda cov, rank: seen.append(cov) or top(cov, rank))
    zeros = {k: sh.map(torch.zeros_like) for k, sh in pieces.items()}
    basis = t_gc.make_basis(256, 32)
    state = t_gc.GradCompressionState(
        basis=sharding.shard_leaf(basis, (), mesh), error=zeros,
        step=torch.zeros((), dtype=torch.int32))
    collectives.LOG.reset()
    gh, new, stats = t_gc.compress_update(pieces, state)
    logged = collectives.LOG.summary()
    gathered = 4 * int(np.prod(ONCE_LEAVES["c_gathered"][0]))
    copies = len(set(devices))
    assert logged["bytes"] == {"all-reduce": 256 * 256 * 4,
                               "all-gather": gathered}
    assert logged["counts"] == {"all-reduce": 1, "all-gather": 1}
    want_cov = t_gc._covariance(whole.values(), 256, "cpu")
    twice = want_cov + t_gc._covariance(
        [whole["a_rep"], whole["c_gathered"]], 256, "cpu")
    scale = want_cov.abs().max()
    assert len(seen) == copies
    for cov in seen:
        torch.testing.assert_close(cov, want_cov, rtol=0, atol=1e-5 * scale)
        assert (cov - twice).abs().max() > 1e-2 * scale
    state1 = t_gc.GradCompressionState(
        basis=basis, error={k: torch.zeros_like(v) for k, v in whole.items()},
        step=torch.zeros((), dtype=torch.int32))
    gh1, new1, stats1 = t_gc.compress_update(whole, state1)
    assert stats == stats1
    for k in whole:
        for got, want in ((gh[k], gh1[k]), (new.error[k], new1.error[k])):
            torch.testing.assert_close(got.host(), want, rtol=0,
                                       atol=1e-5 * want.abs().max())
        assert len(gh[k].owners()) == (copies if k == "a_rep" else 2)
    # gae
    fitted = []
    from_cov = t_gc.basis_from_covariance
    monkeypatch.setattr(t_gc, "basis_from_covariance",
                        lambda cov: fitted.append(cov) or from_cov(cov))
    collectives.LOG.reset()
    gg, gstats = t_gc.gae_compress_grads(pieces, tau=0.5)
    logged = collectives.LOG.summary()
    assert logged["bytes"] == {"all-reduce": 256 * 256 * 4,
                               "all-gather": gathered}
    torch.testing.assert_close(
        fitted[0], t_gc._covariance([whole["b_inside"]], 256, "cpu"),
        rtol=0, atol=1e-5 * scale)
    gg1, gstats1 = t_gc.gae_compress_grads(whole, tau=0.5)
    assert gstats["total_elems"] == gstats1["total_elems"]
    assert float(gstats["exact_blocks"]) == float(gstats1["exact_blocks"])
    _kept_between(float(gstats["kept_coeffs"]),
                  float(gstats["exact_blocks"]),
                  float(gstats1["kept_coeffs"]), gstats1["total_elems"])
    for k in ("a_rep", "c_gathered"):       # the one-device arithmetic
        assert torch.equal(gg[k].host(), gg1[k])
    assert _block_errs(whole["b_inside"].numpy(),
                       gg["b_inside"].host().numpy()).max() <= 0.5


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoints_carry_the_compression_state(tmp_path):
    """A TP ``pca_ef`` state saves whole arrays, its error buffers and
    basis among them, which restore one-device; that state steps and
    saves again, and restores into a TP run, which then steps as the TP
    run that never stopped; a JAX-written step with ``gc`` restores into
    the TP run."""
    arch, tp = "qwen2-1.5b", 2
    cfg = _cfg(arch)
    run, opt = RunConfig(tp=tp, gradient_compression="pca_ef"), \
        _optimizer(t_opt)
    mesh = _mesh(1, tp)
    step = loop.make_train_step(cfg, run, opt, mesh=mesh)
    j_state = _j_state(arch, tp, False, "pca_ef")
    state = registry.train_state_from_jax(j_state, "cpu")
    tp_state, _ = step(state, _batch(cfg, 0))
    ck = CheckpointManager(str(tmp_path / "tp"), device="cpu")
    ck.save(1, tp_state, blocking=True)
    _, restored = ck.restore()
    assert not loop.is_sharded(restored.params)
    assert not isinstance(restored.gc.basis, sharding.Sharded)
    whole = loop.unshard_train_state(tp_state)
    assert len(t_opt.tree_leaves(whole.gc)) == len(t_opt.tree_leaves(
        restored.gc)) == 2 + len(_leaves(state.params))
    for x, y in zip(_leaves(restored), _leaves(whole)):
        np.testing.assert_array_equal(x, y)
    # TP -> one device -> TP
    one, _ = loop.make_train_step(cfg, run, opt)(restored, _batch(cfg, 1))
    ck.save(2, one, blocking=True)
    _, back = ck.restore()
    want, _ = step(loop.make_train_step(cfg, run, opt)(
        loop.unshard_train_state(tp_state), _batch(cfg, 1))[0],
        _batch(cfg, 2))
    got, _ = step(loop.shard_train_state(back, mesh), _batch(cfg, 2))
    for x, y in zip(_leaves(loop.unshard_train_state(got)),
                    _leaves(loop.unshard_train_state(want))):
        np.testing.assert_array_equal(x, y)
    # a JAX-written step with the compression state
    JCheckpointManager(str(tmp_path / "jax")).save(
        0, jax.tree.map(jax.numpy.asarray, j_state), blocking=True)
    _, from_jax = CheckpointManager(str(tmp_path / "jax"),
                                    device="cpu").restore()
    assert from_jax.gc is not None
    got, _ = step(loop.shard_train_state(from_jax, mesh), _batch(cfg, 0))
    for x, y in zip(_leaves(loop.unshard_train_state(got)),
                    _leaves(loop.unshard_train_state(tp_state))):
        np.testing.assert_array_equal(x, y)

