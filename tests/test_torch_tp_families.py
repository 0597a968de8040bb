"""The port's tensor-parallel forward of the ssm, hybrid, vlm and audio
families against the JAX package's GSPMD forward, on the CPU, and the
pieces it is made of: the packed SSD projection's gathered columns, the
RMSNorm over a split width, the row-split LM head, the collectives of one
SSD block and the refusal to decode from split params.

The params are the JAX package's, seeded at ``RunConfig(tp=N)`` (padded
heads and vocab), with seeded numpy noise on every leaf whose init is a
constant (norm scales, biases, ``ssd/conv_b``, ``conv/b``, ``D``, the
VLM's tanh gates: ``_perturbed``), so that a bias added once per shard or a
cross layer behind a zero gate would show; the same arrays go to both
packages (``registry.params_from_jax``).  JAX's sharded runs need N
devices, which JAX fixes at its first import, so they run in ONE subprocess
(``_JAX_TP``) with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``,
at niceness 10: ``jax.jit(forward)`` with the params placed by
``param_partition_specs(tp_size=N)`` on a ``(1, N)`` host mesh, with ``sp``
under ``activation_sharding(activation_rules(False, sp=True))``.  The port
shards the same params over ``["cpu"] * N``.  Cases (``CASES``): reduced
mamba2-370m at tp 2 and 4 (its ``in_proj`` of 296 columns cuts across
heads at both), recurrentgemma-9b, llama-3.2-vision-11b and whisper-medium
at tp 2, and deepseek-coder-33b at tp 2 (the dense family's untied head,
whose ``unembed/w`` the rules cut by rows), each with ``sp`` off and on.
Tolerances: logits within 1e-5 of the largest |logit| (fp32; the shards'
partial sums add in another order); the gathered columns exact; the norm
and the head within 1e-6 relative; the collective log exact.
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
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.launch import mesh as t_mesh
from repro_torch.models import common, registry, ssd
from repro_torch.parallel import collectives, tensor
from repro_torch.parallel import sharding as t_shd
from repro_torch.parallel.tensor import Shards
from repro_torch.train import loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [("mamba2-370m", 2), ("mamba2-370m", 4), ("recurrentgemma-9b", 2),
         ("llama-3.2-vision-11b", 2), ("whisper-medium", 2),
         ("deepseek-coder-33b", 2)]
B, S = 2, 16
LOGIT_FRAC = 1e-5
NOISE = 0.2

_JAX_TP = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, {tests!r})
from test_torch_tp_families import CASES, _extra, _jax_params, _tokens
from repro.configs import get_config
from repro.configs.base import RunConfig
from repro.models import registry
from repro.parallel import sharding as shd

out = {{}}
for arch, tp in CASES:
    cfg = registry.reduced_config(get_config(arch))
    run = RunConfig(tp=tp)
    api = registry.get_model(cfg)
    params = _jax_params(arch, tp)
    mesh = jax.make_mesh((1, tp), ("data", "model"),
                         devices=jax.devices()[:tp],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    placed = jax.device_put(params, shd.named_shardings(
        shd.param_partition_specs(params, tp_size=tp), mesh))
    tokens = jnp.asarray(_tokens(cfg.vocab))
    extra = {{k: jnp.asarray(v) for k, v in _extra(cfg).items()}}
    for sp in (False, True):
        rules = shd.activation_rules(False, sp=True) if sp else None
        with mesh, shd.activation_sharding(rules):
            fwd = jax.jit(lambda p, t, e: api.forward(p, cfg, run, t, **e))
            out[f"{{arch}}/{{tp}}/{{int(sp)}}"] = np.asarray(
                fwd(placed, tokens, extra))
np.savez(sys.argv[1], **out)
"""


def _tokens(vocab):
    return np.random.default_rng(7).integers(0, vocab, (B, S)).astype(
        np.int32)


def _extra(cfg, b=B):
    """The frontend's input of the vlm and audio families."""
    rng = np.random.default_rng(11)
    if cfg.family == "vlm":
        return {"vision_embeds": rng.standard_normal(
            (b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)}
    if cfg.family == "audio":
        return {"frames": rng.standard_normal(
            (b, cfg.n_frames, cfg.d_model)).astype(np.float32)}
    return {}


def _perturbed(tree, seed=0):
    """The numpy param tree with seeded noise of ``NOISE`` on every leaf
    whose entries are all one value (the JAX init's constants), keys walked
    in sorted order."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        a = np.asarray(node)
        if np.all(a == a.flat[0]):
            a = (a + NOISE * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return walk(tree)


def _jax_params(arch, tp):
    """The JAX package's reduced params at ``tp``, perturbed (numpy)."""
    cfg = j_registry.reduced_config(j_get_config(arch))
    return _perturbed(jax.device_get(j_registry.get_model(cfg).init_params(
        jax.random.PRNGKey(0), cfg, JRunConfig(tp=tp))))


@pytest.fixture(scope="module")
def jax_tp(tmp_path_factory):
    """JAX's GSPMD logits of every case, sp off and on."""
    path = str(tmp_path_factory.mktemp("jax_tp_families") / "out.npz")
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
    """(cfg, run, the perturbed JAX params at tp as torch tensors)."""
    cfg = registry.reduced_config(get_config(arch))
    return (cfg, RunConfig(tp=tp, sp=sp),
            registry.params_from_jax(_jax_params(arch, tp), "cpu"))


def _mesh(tp, devices=None):
    return t_mesh.make_mesh((1, tp), ("data", "model"),
                            devices or ["cpu"] * tp)


def _shards(params, tp, devices=None):
    mesh = _mesh(tp, devices)
    return loop.model_shards(t_shd.shard_params(params, mesh, tp), mesh)


def _inputs(cfg):
    return (torch.from_numpy(_tokens(cfg.vocab)),
            {k: torch.from_numpy(v) for k, v in _extra(cfg).items()})


# ---------------------------------------------------------------------------
# the forward against JAX's GSPMD forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sp", [False, True], ids=["sp_off", "sp_on"])
@pytest.mark.parametrize("arch,tp", CASES,
                         ids=[f"{a}-tp{t}" for a, t in CASES])
def test_tp_forward_matches_jax_gspmd(jax_tp, arch, tp, sp):
    cfg, run, params = _setup(arch, tp, sp)
    api = registry.get_model(cfg)
    tokens, extra = _inputs(cfg)
    with torch.no_grad():
        got = api.forward(_shards(params, tp), cfg, run, tokens, **extra)
        one = api.forward(params, cfg, run, tokens, **extra)
    want = jax_tp[f"{arch}/{tp}/{int(sp)}"]
    scale = np.abs(want).max()
    assert got.shape == want.shape == (B, S, cfg.padded_vocab(tp))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=LOGIT_FRAC * scale)
    np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=0,
                               atol=LOGIT_FRAC * scale)
    if cfg.padded_vocab(tp) != cfg.vocab:
        assert (got[..., cfg.vocab:] < -1e29).all()


def test_perturbation_reaches_every_constant_leaf():
    """Each leaf the JAX init makes constant differs from its init after
    ``_perturbed`` (the gates, biases and scales the forward is held on)."""
    jcfg = j_registry.reduced_config(j_get_config("whisper-medium"))
    raw = jax.device_get(j_registry.get_model(jcfg).init_params(
        jax.random.PRNGKey(0), jcfg, JRunConfig(tp=2)))
    moved = _perturbed(raw)
    flat_raw = jax.tree_util.tree_flatten_with_path(raw)[0]
    flat_new = dict(jax.tree_util.tree_flatten_with_path(moved)[0])
    constant = [p for p, a in flat_raw if np.all(a == np.asarray(a).flat[0])]
    assert len(constant) >= 10
    for p in constant:
        assert not np.all(flat_new[p] == np.asarray(dict(flat_raw)[p]))
    for arch, leaf in (("llama-3.2-vision-11b", ("groups", "cross",
                                                 "gate_attn")),
                       ("mamba2-370m", ("layers", "ssd", "conv_b"))):
        p = _jax_params(arch, 2)
        for k in leaf:
            p = p[k]
        assert np.all(p != 0)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
def test_gathered_columns_are_each_shards_heads(tp):
    """``gather_pick`` of JAX's contiguous cuts of ``in_proj`` and
    ``conv_w`` gives shard s the whole leaf's columns of its heads' z, x
    and dt and all of B and C, in that order."""
    cfg, run, params = _setup("mamba2-370m", tp)
    dm = ssd._dims(cfg)
    di, gn, p_ = dm["d_inner"], dm["G"] * dm["N"], dm["P"]
    hs = dm["H"] // tp
    shards = _shards(params, tp)
    lp = common.layer(shards["layers"], 1)["ssd"]
    whole = common.layer(params["layers"], 1)["ssd"]
    assert lp["in_proj"].pieces[0].shape[-1] == whole["in_proj"].shape[-1] // tp
    got_in = tensor.gather_pick(lp["in_proj"], lambda s, n, w: ssd._columns(
        w, ssd._proj_spans(cfg, s, n)))
    got_conv = tensor.gather_pick(lp["conv_w"], lambda s, n, w: ssd._columns(
        w, ssd._conv_spans(cfg, s, n)))
    for s in range(tp):
        heads = np.arange(s * hs, (s + 1) * hs)
        chans = (heads[:, None] * p_ + np.arange(p_)).ravel()
        cols = np.concatenate([chans, di + chans,
                               2 * di + np.arange(2 * gn),
                               2 * di + 2 * gn + heads])
        torch.testing.assert_close(got_in.pieces[s],
                                   whole["in_proj"][:, cols], rtol=0, atol=0)
        conv_cols = np.concatenate([chans, di + np.arange(2 * gn)])
        torch.testing.assert_close(got_conv.pieces[s],
                                   whole["conv_w"][:, conv_cols], rtol=0,
                                   atol=0)


@pytest.mark.parametrize("n", [2, 4])
def test_rmsnorm_over_shards_equals_one_devices(n):
    """The gated norm's mean of squares summed across the shards: the
    shards' outputs joined are one device's ``rmsnorm``; one all-reduce of
    (B, S, 1) float32."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((2, 6, 32))).float()
    scale = torch.from_numpy(1 + 0.1 * rng.standard_normal(32)).float()
    want = common.rmsnorm({"scale": scale}, x, 1e-5)
    devs = ["cpu"] * n
    collectives.LOG.reset()
    got = common.rmsnorm_over_shards(
        {"scale": Shards(list(scale.chunk(n)), None, devs)},
        Shards(list(x.chunk(n, dim=-1)), 2, devs), 1e-5)
    assert collectives.LOG.summary()["bytes"] == {"all-reduce": 2 * 6 * 4}
    assert got.layout == 2
    torch.testing.assert_close(torch.cat(got.pieces, -1), want, rtol=1e-6,
                               atol=1e-6)
    # each shard normalising its own piece alone is another function
    alone = torch.cat([common.rmsnorm({"scale": s_}, p, 1e-5) for s_, p in
                       zip(scale.chunk(n), x.chunk(n, dim=-1))], -1)
    assert (alone - want).abs().max() > 1e-3
    assert common.rmsnorm_over_shards({"scale": scale}, x, 1e-5).equal(want)


@pytest.mark.parametrize("n", [2, 4])
def test_row_split_lm_head_equals_the_whole_head(n):
    """An untied ``unembed/w`` is cut by rows (D) under the partition rules
    (``embed/w$`` matches it first): the head's partial sums over D are
    reduce-scattered over the vocab, so that the logits, the CE and the
    chunked CE equal the whole head's."""
    rng = np.random.default_rng(n)
    vocab, vpad, d = 50, 64, 16
    assert t_shd.param_spec_for_path("unembed/w", 2) == t_shd.P("model",
                                                                 None)
    x = torch.from_numpy(rng.standard_normal((2, 12, d))).float()
    w = torch.from_numpy(rng.standard_normal((d, vpad))).float()
    labels = torch.from_numpy(rng.integers(0, vocab, (2, 12)))
    whole = common.lm_head(x, w, vocab, vpad)
    want = common.cross_entropy_loss(whole, labels, vocab)
    devs = ["cpu"] * n
    rows = Shards(list(w.chunk(n, dim=0)), None, devs)
    xs = Shards([x] * n, tensor.REPLICATED, devs)
    collectives.LOG.reset()
    logits = common.lm_head(xs, rows, vocab, vpad)
    assert collectives.LOG.summary()["bytes"] == {
        "reduce-scatter": 2 * 12 * vpad // n * 4}
    assert logits.layout == 2
    torch.testing.assert_close(tensor.gather(logits), whole, rtol=1e-6,
                               atol=1e-5)
    torch.testing.assert_close(common.cross_entropy_loss(logits, labels,
                                                         vocab), want,
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(common.chunked_ce_loss(xs, rows, labels, vocab,
                                                      4, vocab), want,
                               rtol=1e-6, atol=0)


def _ssd_block_reckoning(cfg, tp, sp):
    """One SSD block's collectives at (B, S): the all-gathers of its two
    packed weights, (D, proj_out) and (cw, conv_ch) fp32; the gated norm's
    all-reduce of (B, S, 1); the boundary's all-reduce of (B, S, D), or
    with sp its reduce-scatter of one shard's (B, S / tp, D) and the
    all-gather of the block's input."""
    dm = ssd._dims(cfg)
    proj_out = 2 * dm["d_inner"] + 2 * dm["G"] * dm["N"] + dm["H"]
    act = B * S * cfg.d_model * 4
    gather = (cfg.d_model * proj_out + cfg.conv_width * dm["conv_ch"]) * 4
    ops = {"all-gather": [2, gather], "all-reduce": [1, B * S * 4]}
    if sp:
        ops["all-gather"] = [3, gather + act]
        ops["reduce-scatter"] = [1, act // tp]
    else:
        ops["all-reduce"] = [2, B * S * 4 + act]
    return {"bytes": {k: v[1] for k, v in ops.items()},
            "counts": {k: v[0] for k, v in ops.items()},
            "total_bytes": sum(v[1] for v in ops.values())}


@pytest.mark.parametrize("sp", [False, True], ids=["sp_off", "sp_on"])
def test_ssm_block_collectives_equal_the_reckoning(sp):
    cfg, run, params = _setup("mamba2-370m", 2, sp)
    shards = _shards(params, 2)
    tokens, _ = _inputs(cfg)
    rules = t_shd.activation_rules(False, sp=sp)
    with torch.no_grad(), t_shd.activation_sharding(rules):
        x = t_shd.constrain(common.embed(shards["embed"], tokens), "act_btd")
        collectives.LOG.reset()
        out = ssd._block_forward(common.layer(shards["layers"], 0), cfg, x)
        logged = collectives.LOG.summary()
    assert out.layout == (1 if sp else tensor.REPLICATED)
    assert logged == _ssd_block_reckoning(cfg, 2, sp)


DECODE_ARCHS = ["mamba2-370m", "recurrentgemma-9b", "llama-3.2-vision-11b",
                "whisper-medium"]


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_from_split_params_is_refused(arch):
    """``init_decode_state`` and ``decode_step`` refuse split params with
    the transformer's "sharded decode state" error, before any work."""
    cfg, run, params = _setup(arch, 2)
    api = registry.get_model(cfg)
    shards = _shards(params, 2)
    extra = {k: torch.from_numpy(v[:1]) for k, v in _extra(cfg, 1).items()}
    with pytest.raises(NotImplementedError,
                       match=r"sharded decode state.*ROADMAP\.md"):
        api.init_decode_state(shards, cfg, run, 1, 8, **extra)
    state = api.init_decode_state(params, cfg, run, 1, 8, **extra)
    with pytest.raises(NotImplementedError,
                       match=r"sharded decode state.*ROADMAP\.md"):
        api.decode_step(shards, cfg, run, torch.zeros(1, 1, dtype=torch.long),
                        state)
