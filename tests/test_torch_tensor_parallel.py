"""The port's tensor-parallel forward against the JAX package's GSPMD
forward, on the CPU: the activation rules, the sharded params computing
the dense and moe families, the vocab-parallel cross-entropy and the
collectives each forward logs.

The params are the JAX package's, seeded at ``RunConfig(tp=N)`` (padded
heads and vocab) and carried across with ``registry.params_from_jax``.
JAX's sharded runs need N devices, which JAX fixes at its first import, so
they run in ONE subprocess (``_JAX_TP``) with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``, at niceness 10:
``jax.jit(forward)`` with the params placed by
``param_partition_specs(tp_size=N)`` on a ``(1, N)`` host mesh, with ``sp``
under ``activation_sharding(activation_rules(False, sp=True))``.  The port
shards the same params over ``["cpu"] * N``.  Cases: reduced qwen2-1.5b at
tp 2 (its one KV head padded to 2), reduced granite-moe-3b-a800m at tp 2
(expert parallelism: 2 of its 4 experts a shard) and at tp 8 (8 does not
divide 4 experts: each expert's F is split), each with ``sp`` off and on.
Tolerances: logits within 1e-5 of the largest |logit| (fp32; the shards'
partial sums add in another order than one device's matmul); the
vocab-parallel CE at 1e-6 relative; the rule table, the mesh helpers and
the collective log exact.
"""
from __future__ import annotations

import itertools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as j_get_config
from repro.configs.base import RunConfig as JRunConfig
from repro.models import registry as j_registry
from repro.parallel import sharding as j_shd
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.launch import mesh as t_mesh
from repro_torch.models import common, registry, transformer
from repro_torch.parallel import collectives, tensor
from repro_torch.parallel import sharding as t_shd
from repro_torch.parallel.tensor import Shards
from repro_torch.train import loop, optim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [("qwen2-1.5b", 2), ("granite-moe-3b-a800m", 2),
         ("granite-moe-3b-a800m", 8)]
B, S = 2, 16
LOGIT_FRAC = 1e-5

_JAX_TP = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, {tests!r})
from test_torch_tensor_parallel import CASES, _tokens
from repro.configs import get_config
from repro.configs.base import RunConfig
from repro.models import registry
from repro.parallel import sharding as shd

out = {{}}
for arch, tp in CASES:
    cfg = registry.reduced_config(get_config(arch))
    run = RunConfig(tp=tp)
    api = registry.get_model(cfg)
    params = api.init_params(jax.random.PRNGKey(0), cfg, run)
    mesh = jax.make_mesh((1, tp), ("data", "model"),
                         devices=jax.devices()[:tp],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    placed = jax.device_put(params, shd.named_shardings(
        shd.param_partition_specs(params, tp_size=tp), mesh))
    tokens = jnp.asarray(_tokens(cfg.vocab))
    for sp in (False, True):
        rules = shd.activation_rules(False, sp=True) if sp else None
        with mesh, shd.activation_sharding(rules):
            fwd = jax.jit(lambda p, t: api.forward(p, cfg, run, t))
            out[f"{{arch}}/{{tp}}/{{int(sp)}}"] = np.asarray(fwd(placed,
                                                              tokens))
np.savez(sys.argv[1], **out)
"""


def _tokens(vocab):
    return np.random.default_rng(7).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.fixture(scope="module")
def jax_tp(tmp_path_factory):
    """JAX's GSPMD logits of every case, sp off and on."""
    path = str(tmp_path_factory.mktemp("jax_tp") / "out.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        # at a lower priority: other tests' stage deadlines keep the CPU
        ["nice", "-n", "10", sys.executable, "-c",
         _JAX_TP.format(tests=os.path.join(REPO, "tests")), path],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(path) as f:
        return dict(f)


def _setup(arch, tp, sp=False):
    """(cfg, run, the JAX package's params at tp as torch tensors)."""
    jcfg = j_registry.reduced_config(j_get_config(arch))
    jparams = j_registry.get_model(jcfg).init_params(
        jax.random.PRNGKey(0), jcfg, JRunConfig(tp=tp))
    cfg = registry.reduced_config(get_config(arch))
    return (cfg, RunConfig(tp=tp, sp=sp),
            registry.params_from_jax(jax.device_get(jparams), "cpu"))


def _shards(params, mesh, tp):
    """The params of the mesh's model shards, as the model code takes
    them."""
    return loop.model_shards(t_shd.shard_params(params, mesh, tp), mesh)


# ---------------------------------------------------------------------------
# the rules and the mesh
# ---------------------------------------------------------------------------

def _norm_spec(spec):
    return tuple(tuple(e) if isinstance(e, (tuple, list)) and len(e) > 1
                 else (e[0] if isinstance(e, (tuple, list)) else e)
                 for e in spec)


@pytest.mark.parametrize("multi_pod,sp,kv_seq_shard",
                         list(itertools.product([False, True], repeat=3)))
def test_activation_rules_equal_jax(multi_pod, sp, kv_seq_shard):
    ours = t_shd.activation_rules(multi_pod, sp=sp, kv_seq_shard=kv_seq_shard)
    theirs = j_shd.activation_rules(multi_pod, sp=sp,
                                    kv_seq_shard=kv_seq_shard)
    assert set(ours) == set(theirs)
    for kind, spec in theirs.items():
        assert isinstance(spec, JP)
        assert _norm_spec(ours[kind]) == _norm_spec(spec), kind


def test_constrain_is_a_no_op_without_rules():
    x = torch.randn(2, 4, 8)
    pieces = Shards([x, x.clone()], tensor.PARTIAL, ["cpu", "cpu"])
    assert t_shd.active_rules() is None
    assert t_shd.constrain(x, "act_btd") is x
    assert t_shd.constrain(pieces, "act_btd") is pieces
    with t_shd.activation_sharding(t_shd.activation_rules(False)):
        assert t_shd.constrain(x, "act_btd") is x      # one device: whole
        assert t_shd.constrain(pieces, "no_such_kind") is pieces
        assert t_shd.constrain(pieces, "tokens") is pieces   # (B, S) rule
        with t_shd.activation_sharding(None):
            assert t_shd.constrain(pieces, "act_btd") is pieces
        placed = t_shd.constrain(pieces, "act_btd")
    assert t_shd.active_rules() is None
    assert placed.layout == tensor.REPLICATED
    torch.testing.assert_close(placed.pieces[0], 2 * x, rtol=0, atol=0)


def test_place_runs_the_collective_the_layouts_need():
    """Partial -> whole: all-reduce; partial -> split: reduce-scatter,
    logged as one shard's slice; split -> whole: all-gather; whole ->
    split: a cut, no transfer."""
    rng = np.random.default_rng(0)
    parts = [torch.from_numpy(rng.standard_normal((2, 6, 4))).float()
             for _ in range(3)]
    devs = ["cpu", "cpu:0", "cpu"]
    total = parts[0] + parts[1] + parts[2]
    collectives.LOG.reset()
    split = Shards(parts, tensor.PARTIAL, devs).place(1)
    assert split.layout == 1 and split.shape == (2, 6, 4)
    for s, p in enumerate(split.pieces):
        torch.testing.assert_close(p, total[:, 2 * s:2 * s + 2])
    whole = split.place(None)
    torch.testing.assert_close(whole.pieces[1], total)
    again = whole.place(1)
    assert again.layout == 1
    torch.testing.assert_close(again.pieces[2], total[:, 4:])
    reduced = Shards(parts, tensor.PARTIAL, devs).place(None)
    torch.testing.assert_close(reduced.pieces[0], total)
    assert collectives.LOG.summary() == {
        "bytes": {"reduce-scatter": 2 * 2 * 4 * 4, "all-gather": 2 * 6 * 4 * 4,
                  "all-reduce": 2 * 6 * 4 * 4},
        "counts": {"reduce-scatter": 1, "all-gather": 1, "all-reduce": 1},
        "total_bytes": 2 * 2 * 4 * 4 + 2 * (2 * 6 * 4 * 4)}
    with pytest.raises(ValueError, match="laid out"):
        Shards(parts, tensor.PARTIAL, devs) + whole
    with pytest.raises(ValueError, match="does not split"):
        collectives.reduce_scatter(parts, 2)


def test_data_and_model_devices_of_a_mesh():
    devs = ["cpu", "cpu:0", "cpu:1", "cpu:2"]
    mesh = t_mesh.make_host_mesh(model=2, devices=devs)
    assert [str(d) for d in t_mesh.data_devices(mesh)] == ["cpu", "cpu:1"]
    assert [str(d) for d in t_mesh.model_devices(mesh, 1)] == ["cpu:1",
                                                              "cpu:2"]
    pods = t_mesh.make_mesh((2, 1, 2), ("pod", "data", "model"), devs)
    assert t_mesh.shard_grid(pods).tolist() == [[(0, 0, 0), (0, 0, 1)],
                                                [(1, 0, 0), (1, 0, 1)]]
    odd = t_mesh.make_mesh((2, 2), ("model", "data"), devs)
    assert [str(d) for d in t_mesh.model_devices(odd, 0)] == ["cpu", "cpu:1"]
    with pytest.raises(NotImplementedError, match="'pipe'"):
        t_mesh.data_devices(t_mesh.make_mesh((2, 2), ("data", "pipe"), devs))


# ---------------------------------------------------------------------------
# the forward against JAX's GSPMD forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sp", [False, True], ids=["sp_off", "sp_on"])
@pytest.mark.parametrize("arch,tp", CASES,
                         ids=[f"{a}-tp{t}" for a, t in CASES])
def test_tp_forward_matches_jax_gspmd(jax_tp, arch, tp, sp):
    cfg, run, params = _setup(arch, tp, sp)
    mesh = t_mesh.make_mesh((1, tp), ("data", "model"), ["cpu"] * tp)
    with torch.no_grad():
        got = transformer.forward(_shards(params, mesh, tp), cfg, run,
                                  torch.from_numpy(_tokens(cfg.vocab)))
        one = transformer.forward(params, cfg, run,
                                  torch.from_numpy(_tokens(cfg.vocab)))
    want = jax_tp[f"{arch}/{tp}/{int(sp)}"]
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=LOGIT_FRAC * scale)
    np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=0,
                               atol=LOGIT_FRAC * scale)
    if cfg.padded_vocab(tp) != cfg.vocab:
        assert (got[..., cfg.vocab:] < -1e29).all()


@pytest.mark.parametrize("tp", [2, 8], ids=["ep", "f_split"])
def test_moe_dispatch_groups_keep_their_meaning_under_tp(tp):
    """``moe_dispatch_groups`` 2: each group routed with its own capacity
    on every shard, as on one device (``tests/test_torch_moe.py`` holds
    the one-device forward to JAX's)."""
    cfg, run, params = _setup("granite-moe-3b-a800m", tp)
    run = RunConfig(tp=tp, moe_dispatch_groups=2)
    mesh = t_mesh.make_mesh((1, tp), ("data", "model"), ["cpu"] * tp)
    tokens = torch.from_numpy(_tokens(cfg.vocab))
    with torch.no_grad():
        got = transformer.forward(_shards(params, mesh, tp), cfg, run,
                                  tokens)
        one = transformer.forward(params, cfg, run, tokens)
        whole = transformer.forward(params, cfg, RunConfig(tp=tp), tokens)
    scale = np.abs(one.numpy()).max()
    np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=0,
                               atol=LOGIT_FRAC * scale)
    # per-group capacities route otherwise than one group over the batch
    assert np.abs(one.numpy() - whole.numpy()).max() > LOGIT_FRAC * scale


def test_moe_fallback_splits_each_experts_f():
    """At tp 8 granite's reduced 4 experts do not divide the axis: the
    pieces are (E, D, F/8), and every shard runs every expert."""
    cfg, run, params = _setup("granite-moe-3b-a800m", 8)
    mesh = t_mesh.make_mesh((1, 8), ("data", "model"), ["cpu"] * 8)
    shards = _shards(params, mesh, 8)
    w = shards.pieces[3]["layers"]["moe"]["w_gate"]
    assert tuple(w.shape) == (cfg.n_layers, 4, cfg.d_model, cfg.d_ff // 8)
    ep = _shards(_setup("granite-moe-3b-a800m", 2)[2], t_mesh.make_mesh(
        (1, 2), ("data", "model"), ["cpu"] * 2), 2)
    assert tuple(ep.pieces[1]["layers"]["moe"]["w_out"].shape) == (
        cfg.n_layers, 2, cfg.d_ff, cfg.d_model)


def test_forward_refuses_what_is_not_ported():
    """The ``shard_map`` step over a model axis (the JAX package has none;
    gradient compression trains under tensor parallelism in the GSPMD
    mode) and decoding from split params are refused."""
    qwen, run, params = _setup("qwen2-1.5b", 2)
    mesh = t_mesh.make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    compressed = RunConfig(tp=2, gradient_compression="pca_ef")
    loop.make_train_step(qwen, compressed, optim.adamw(1e-3), mesh=mesh)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        loop.make_train_step(qwen, compressed, optim.adamw(1e-3), mesh=mesh,
                             axis_name="data")
    shards = _shards(params, t_mesh.make_mesh((1, 2), ("data", "model"),
                                              ["cpu"] * 2), 2)
    with pytest.raises(NotImplementedError, match="sharded decode state"):
        transformer.init_decode_state(shards, qwen, run, 1, 8)


# ---------------------------------------------------------------------------
# the vocab-parallel cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_vocab_parallel_ce_equals_the_whole_ce(n):
    """Padded columns at -1e30 on the last shard, labels in every shard's
    range, padding labels (>= vocab, and -1) ignored; the chunked CE the
    same way through the head's pieces."""
    rng = np.random.default_rng(n)
    vocab, vpad, d = 50, 64, 8
    x = torch.from_numpy(rng.standard_normal((2, 12, d))).float()
    w = torch.from_numpy(rng.standard_normal((d, vpad))).float()
    labels = torch.from_numpy(rng.integers(0, vocab, (2, 12)))
    labels[0, :n] = torch.arange(n) * (vpad // n) + 1   # every shard's range
    labels[1, 3], labels[1, 5] = vocab + 3, -1           # ignored
    whole = common.lm_head(x, w, vocab, vpad)
    want = common.cross_entropy_loss(whole, labels, vocab)
    devs = ["cpu"] * n
    pieces = Shards(list(w.chunk(n, dim=1)), None, devs)
    logits = common.lm_head(Shards([x] * n, tensor.REPLICATED, devs),
                            pieces, vocab, vpad)
    assert logits.layout == 2
    torch.testing.assert_close(tensor.gather(logits), whole, rtol=1e-6,
                               atol=0)
    got = common.cross_entropy_loss(logits, labels, vocab)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    chunked = common.chunked_ce_loss(x, w, labels, vocab, 4, vocab)
    chunked_tp = common.chunked_ce_loss(
        Shards([x] * n, tensor.REPLICATED, devs), pieces, labels, vocab, 4,
        vocab)
    torch.testing.assert_close(chunked, want, rtol=1e-6, atol=0)
    torch.testing.assert_close(chunked_tp, want, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# what a forward logs
# ---------------------------------------------------------------------------

def _reckoned(cfg, tp, sp, loss):
    """The collectives of reduced qwen2-1.5b's forward (or its loss):
    without sp, the embedding's all-reduce and two a layer, all of
    (B, S, D) fp32; with sp, reduce-scatters of one shard's (B, S/tp, D)
    in their place, and the all-gathers of each block's input and of the
    head's.  The forward's logits: one all-gather of (B, S, V).  The loss:
    the CE's all-reduce of the rows' max (B, S) and of their sums of
    exponentials and labels' logits (2 x (B, S))."""
    act = B * S * cfg.d_model * 4
    n = 1 + 2 * cfg.n_layers
    if sp:
        out = {"reduce-scatter": (n, n * act // tp),
               "all-gather": (n, n * act)}          # 2 a layer + the head's
    else:
        out = {"all-reduce": (n, n * act)}
    if loss:
        c, b = out.get("all-reduce", (0, 0))
        out["all-reduce"] = (c + 2, b + 3 * B * S * 4)
    else:
        c, b = out.get("all-gather", (0, 0))
        out["all-gather"] = (c + 1, b + B * S * cfg.padded_vocab(tp) * 4)
    return {"bytes": {k: v[1] for k, v in out.items()},
            "counts": {k: v[0] for k, v in out.items()},
            "total_bytes": sum(v[1] for v in out.values())}


@pytest.mark.parametrize("sp", [False, True], ids=["sp_off", "sp_on"])
def test_collective_log_equals_the_reckoning(sp):
    cfg, run, params = _setup("qwen2-1.5b", 2, sp)
    mesh = t_mesh.make_mesh((1, 2), ("data", "model"), ["cpu"] * 2)
    shards = _shards(params, mesh, 2)
    tokens = torch.from_numpy(_tokens(cfg.vocab))
    with torch.no_grad():
        collectives.LOG.reset()
        transformer.forward(shards, cfg, run, tokens)
        assert collectives.LOG.summary() == _reckoned(cfg, 2, sp, False)
        collectives.LOG.reset()
        transformer.train_loss(shards, cfg, run,
                               {"tokens": tokens, "labels": tokens})
        assert collectives.LOG.summary() == _reckoned(cfg, 2, sp, True)
