"""The port's MoE family (granite-moe-3b-a800m, llama4-scout-17b-a16e) and
the dense deepseek-coder-33b against the JAX package's, on the CPU.

For the reduced configs (4 experts, top 2 or top 1 with llama4's shared
expert, per-expert d_ff 64), JAX params are carried across with
``params_from_jax`` and the same numpy-made inputs go through both packages.

Tolerances: ``moe_apply`` 1e-5 (fp32, one layer: the expert matmuls and the
combine sum in another order), with the expert indices and the kept mask
equal to JAX's; logits 1e-4 (fp32 through a few layers, as
``test_torch_lm.py``); losses rtol 3e-5 (as ``test_torch_train.py``);
greedy tokens equal; the ``kv_tau`` caches within one bin, as
``test_torch_lm.py`` holds the dense ones.
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
from repro.models import moe as j_moe
from repro.models import registry as j_registry
from repro.models import transformer as j_transformer
from repro.serve import engine as j_engine
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.models import common, moe, registry, transformer
from repro_torch.serve import engine

ARCHS = ["granite-moe-3b-a800m", "llama4-scout-17b-a16e", "deepseek-coder-33b"]
MOE_ARCHS = ARCHS[:2]
MOE_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_RTOL = 3e-5
KV_TAU = 0.05


@dataclasses.dataclass
class Pair:
    cfg: object
    jcfg: object
    jparams: dict
    params: dict


def _pair(arch) -> Pair:
    jcfg = j_registry.reduced_config(j_get_config(arch))
    cfg = registry.reduced_config(get_config(arch))
    jparams = jax.device_get(j_registry.get_model(jcfg).init_params(
        jax.random.PRNGKey(0), jcfg, JRunConfig()))
    return Pair(cfg, jcfg, jparams, registry.params_from_jax(jparams, "cpu"))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_pair(request):
    return _pair(request.param)


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def _no_drop(cfg):
    """The config with capacity factor n_experts / top_k: capacity = T, so
    no (token, slot) pair is dropped and ``forward`` equals decode."""
    if cfg.family != "moe":
        return cfg
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------

def test_configs_match_jax(pair):
    full, jfull = get_config(pair.cfg.arch), j_get_config(pair.cfg.arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert dataclasses.asdict(pair.cfg) == dataclasses.asdict(pair.jcfg)
    assert registry.get_model(full).forward is transformer.forward


def test_params_from_jax_keeps_moe_paths_and_values(pair):
    assert _shapes(pair.params) == _shapes(pair.jparams)
    if pair.cfg.family == "moe":
        w = pair.jparams["layers"]["moe"]
        for leaf in ("router", "w_gate", "w_in", "w_out"):
            np.testing.assert_array_equal(
                pair.params["layers"]["moe"][leaf].numpy(), w[leaf])
        assert ("shared" in w) == pair.cfg.shared_expert
    seeded = registry.init_params(pair.cfg, RunConfig(),
                                  torch.Generator().manual_seed(0), "cpu")
    assert _shapes(seeded) == _shapes(pair.jparams)
    assert all(v.dtype == torch.float32 for v in _leaves(seeded))


@pytest.mark.parametrize("arch,billions", [("granite-moe-3b-a800m", 3.30),
                                           ("deepseek-coder-33b", 33.3)])
def test_full_config_param_count(arch, billions, monkeypatch):
    """The JAX package's ``params_specs`` count (granite: 12.3 GiB fp32),
    and the port's seeded init has its shapes at full width (drawn on the
    meta device, so nothing is allocated)."""
    specs = j_registry.params_specs(j_get_config(arch), JRunConfig())
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(specs))
    assert round(n / 1e9, 1 if billions > 10 else 2) == billions

    def meta(gen, shape, device):
        return torch.empty(shape, device="meta")
    monkeypatch.setattr(common, "randn", meta)
    monkeypatch.setattr(transformer, "randn", meta)
    got = transformer.init_params(get_config(arch), RunConfig(),
                                  torch.Generator(), "meta")
    assert _shapes(got) == _shapes(specs)


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _j_route_and_keep(jp, xf, top_k, c):
    """``jax.lax.top_k``'s expert ids and the kept mask of the JAX dispatch
    (``src/repro/models/moe.py:83-96``), both over the sorted pairs."""
    e = jp["router"].shape[1]
    gates = jax.nn.softmax((xf @ jp["router"]).astype(jnp.float32))
    _, expert_idx = jax.lax.top_k(gates, top_k)
    flat = expert_idx.reshape(-1)
    order = jnp.argsort(flat)
    se = flat[order]
    seg = jnp.cumsum(jnp.bincount(se, length=e)) - jnp.bincount(se, length=e)
    keep = jnp.arange(flat.shape[0]) - seg[se] < c
    return np.asarray(expert_idx), np.asarray(order), np.asarray(keep)


MOE_SETTINGS = {"drops": dict(capacity_factor=0.25),
                "no_drops": dict(capacity_factor=None),
                "dispatch_groups_2": dict(dispatch_groups=2),
                "zero_router": dict(zero_router=True)}


@pytest.mark.parametrize("setting", list(MOE_SETTINGS))
def test_moe_apply_matches_jax(moe_pair, setting):
    """One layer's ``moe_apply`` on (2, 16, 64): with drops (capacity factor
    0.25), without (capacity = T), with two dispatch groups, and with a zero
    router, where every gate ties and ``jax.lax.top_k`` picks experts
    0..k-1.  The expert ids and the kept mask equal JAX's, the output is
    within 1e-5."""
    cfg = moe_pair.cfg
    opts = MOE_SETTINGS[setting]
    jp = jax.tree.map(lambda a: np.array(a[0]), moe_pair.jparams["layers"]["moe"])
    if opts.get("zero_router"):
        jp["router"] = np.zeros_like(jp["router"])
    cf = opts.get("capacity_factor", cfg.capacity_factor)
    cf = cfg.n_experts / cfg.top_k if cf is None else cf
    groups = opts.get("dispatch_groups", 0)
    x = np.random.default_rng(7).standard_normal((2, 16, 64)).astype(np.float32)
    want = j_moe.moe_apply(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                           top_k=cfg.top_k, capacity_factor=cf,
                           dispatch_groups=groups)
    p = registry.params_from_jax(jp, "cpu")
    got = moe.moe_apply(p, torch.from_numpy(x), top_k=cfg.top_k,
                        capacity_factor=cf, dispatch_groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)

    n = max(groups, 1)
    kept = 0
    for xg in x.reshape(n, -1, 64):
        c = moe._capacity(xg.shape[0], cfg.top_k, cfg.n_experts, cf)
        j_idx, j_order, j_keep = _j_route_and_keep(jp, jnp.asarray(xg),
                                                   cfg.top_k, c)
        _, idx = moe._route(p, torch.from_numpy(xg), cfg.top_k)
        order, keep, _ = moe._plan(idx, cfg.n_experts, c)
        np.testing.assert_array_equal(idx.numpy(), j_idx)
        np.testing.assert_array_equal(order.numpy(), j_order)
        np.testing.assert_array_equal(keep.numpy(), j_keep)
        kept += int(keep.sum())
    pairs = x.shape[0] * x.shape[1] * cfg.top_k
    if setting in ("drops", "zero_router"):
        assert kept < pairs            # the setting drops pairs
    if setting == "no_drops":
        assert kept == pairs
    if setting == "zero_router":
        assert (idx.numpy() == np.arange(cfg.top_k)).all()


def test_moe_router_stats_matches_jax(moe_pair):
    cfg = moe_pair.cfg
    jp = jax.tree.map(lambda a: np.array(a[0]), moe_pair.jparams["layers"]["moe"])
    x = np.random.default_rng(8).standard_normal((2, 24, 64)).astype(np.float32)
    want = j_moe.moe_router_stats(jax.tree.map(jnp.asarray, jp),
                                  jnp.asarray(x), cfg.top_k)
    got = moe.moe_router_stats(registry.params_from_jax(jp, "cpu"),
                               torch.from_numpy(x), cfg.top_k)
    np.testing.assert_array_equal(got["expert_load"].numpy(),
                                  np.asarray(want["expert_load"]))
    np.testing.assert_allclose(float(got["load_cv"]), float(want["load_cv"]),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# forward, decode, loss
# ---------------------------------------------------------------------------

def test_forward_matches_jax(pair):
    """At the config's own capacity factor: granite and llama4 drop pairs
    here (24 tokens a row), so the drops must be JAX's too."""
    toks = _tokens(pair.cfg, (2, 24))
    want = j_transformer.forward(pair.jparams, pair.jcfg, JRunConfig(),
                                 jnp.asarray(toks))
    got = transformer.forward(pair.params, pair.cfg, RunConfig(),
                              torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_forward_with_dispatch_groups_matches_jax(moe_pair):
    toks = _tokens(moe_pair.cfg, (2, 24), seed=2)
    want = j_transformer.forward(moe_pair.jparams, moe_pair.jcfg,
                                 JRunConfig(moe_dispatch_groups=2),
                                 jnp.asarray(toks))
    got = transformer.forward(moe_pair.params, moe_pair.cfg,
                              RunConfig(moe_dispatch_groups=2),
                              torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_decode_step_matches_jax(pair):
    """10 teacher-forced decode steps: the logits and every KV cache."""
    toks = _tokens(pair.cfg, (2, 10), seed=3)
    jstate = j_transformer.init_decode_state(pair.jparams, pair.jcfg,
                                             JRunConfig(), 2, 16)
    state = transformer.init_decode_state(pair.params, pair.cfg, RunConfig(),
                                          2, 16)
    step = jax.jit(lambda p, t, s: j_transformer.decode_step(
        p, pair.jcfg, JRunConfig(), t, s))
    for t in range(toks.shape[1]):
        want, jstate = step(pair.jparams, jnp.asarray(toks[:, t:t + 1]), jstate)
        got, state = transformer.decode_step(
            pair.params, pair.cfg, RunConfig(),
            torch.from_numpy(toks[:, t:t + 1]).long(), state)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert state.pos == state.caches.pos == 10 and state.vision_kv is None
    for g, w in ((state.caches.k, jstate.caches.k),
                 (state.caches.v, jstate.caches.v)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **LOGIT_TOL)


def test_decode_matches_forward_prefix(pair):
    """Decode (one token a step, capacity >= tokens) against ``forward`` at
    every position, with the capacity factor at which ``forward`` drops
    nothing either."""
    cfg = _no_drop(pair.cfg)
    toks = _tokens(cfg, (2, 12), seed=5)
    full = transformer.forward(pair.params, cfg, RunConfig(),
                               torch.from_numpy(toks).long())
    state = transformer.init_decode_state(pair.params, cfg, RunConfig(), 2, 16)
    for t in range(toks.shape[1]):
        got, state = transformer.decode_step(
            pair.params, cfg, RunConfig(),
            torch.from_numpy(toks[:, t:t + 1]).long(), state)
        torch.testing.assert_close(got[:, 0], full[:, t], **LOGIT_TOL)


@pytest.mark.parametrize("ce_chunk", [0, 8])
def test_train_loss_matches_jax(pair, ce_chunk):
    toks = np.random.default_rng(3).integers(0, pair.cfg.vocab, (2, 33))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    want = j_transformer.train_loss(
        jax.tree.map(jnp.asarray, pair.jparams), pair.jcfg,
        JRunConfig(ce_chunk=ce_chunk),
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = transformer.train_loss(
        pair.params, pair.cfg, RunConfig(ce_chunk=ce_chunk),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_generate_batch_and_serve_match_jax(pair):
    jeng = j_engine.ServeEngine(pair.jcfg, JRunConfig(), pair.jparams,
                                batch_size=2, max_len=48, seed=0)
    eng = engine.ServeEngine(pair.cfg, RunConfig(), pair.params, batch_size=2,
                             max_len=48, seed=0, device="cpu")
    prompts = _tokens(pair.cfg, (2, 12), seed=1)
    np.testing.assert_array_equal(eng.generate_batch(prompts, 6),
                                  jeng.generate_batch(prompts, 6))
    rng = np.random.default_rng(1)
    specs = [(rng.integers(0, pair.cfg.vocab, 8).astype(np.int32), 3 + i % 3)
             for i in range(4)]
    got = eng.serve([engine.Request(i, p, n) for i, (p, n) in enumerate(specs)])
    want = jeng.serve([j_engine.Request(i, p, n)
                       for i, (p, n) in enumerate(specs)])
    assert [c.rid for c in got] == [c.rid for c in want] == list(range(4))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)


def test_kv_tau_cache_matches_jax_within_one_bin(moe_pair):
    cfg, jcfg = moe_pair.cfg, moe_pair.jcfg
    prompts = _tokens(cfg, (2, 10), seed=6)
    jeng = j_engine.ServeEngine(jcfg, JRunConfig(), moe_pair.jparams,
                                batch_size=2, max_len=16, kv_tau=KV_TAU)
    eng = engine.ServeEngine(cfg, RunConfig(), moe_pair.params, batch_size=2,
                             max_len=16, kv_tau=KV_TAU, device="cpu")
    jstate = jeng.api.init_decode_state(moe_pair.jparams, jcfg, JRunConfig(),
                                        2, 16)
    jstate, _ = jeng._prefill(moe_pair.jparams, jnp.asarray(prompts), jstate)
    state = eng.api.init_decode_state(moe_pair.params, cfg, RunConfig(), 2, 16)
    state, _ = eng.prefill(torch.from_numpy(prompts).long(), state)
    jstate = jeng._compress_kv(jstate)
    state = eng._compress_kv(state)
    bin_size = 2.0 * KV_TAU / np.sqrt(cfg.resolved_head_dim * cfg.n_kv_heads)
    for got, want in ((state.caches.k, jstate.caches.k),
                      (state.caches.v, jstate.caches.v)):
        diff = np.abs(got.numpy() - np.asarray(want))
        assert diff.max() <= bin_size * (1 + 1e-5)
        assert np.mean(diff > 1e-5) <= 1e-3


def test_serve_cli_runs_moe_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "granite-moe-3b-a800m", "--reduced", "--device",
                "cpu", "--requests", "3", "--batch", "2", "--prompt-len", "8",
                "--max-new", "3", "--max-len", "32", "--kv-tau", "0.05"])
    out = capsys.readouterr().out
    assert "3 completions, 9 tokens" in out and "on cpu" in out
