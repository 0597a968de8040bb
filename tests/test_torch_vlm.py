"""The port's VLM family (llama-3.2-vision-11b: a cross-attention layer
every 5th layer, tanh-gated, over projected vision embeddings) against the
JAX package's, on the CPU.

For the reduced config (one group of 4 self-attention layers and one cross
layer, 16 vision tokens), JAX params are carried across with
``params_from_jax`` after the two tanh gates are set to nonzero seeded
values on the JAX side (at their init of 0 the cross layer adds nothing, and
no comparison would see it), and the same numpy-made tokens and vision
embeddings go through both packages.

Tolerances: cross-attention 3e-5 (fp32, one layer, as the flash checks of
``test_torch_lm_kernels.py``); logits, caches and cross K/V 1e-4 (fp32
through a few layers, as ``test_torch_lm.py``); losses rtol 3e-5 (as
``test_torch_train.py``); greedy tokens equal; the ``kv_tau`` caches within
one bin, as ``test_torch_lm.py`` holds the dense ones.
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
from repro.models import attention as j_attention
from repro.models import registry as j_registry
from repro.models import transformer as j_transformer
from repro.serve import engine as j_engine
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.models import attention, common, registry, transformer
from repro_torch.serve import engine

ARCH = "llama-3.2-vision-11b"
ATTN_TOL = dict(atol=3e-5, rtol=3e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_RTOL = 3e-5
KV_TAU = 0.05


@dataclasses.dataclass
class Pair:
    cfg: object
    jcfg: object
    jparams: dict
    params: dict


@pytest.fixture(scope="module")
def pair():
    jcfg = j_registry.reduced_config(j_get_config(ARCH))
    cfg = registry.reduced_config(get_config(ARCH))
    jparams = jax.device_get(j_registry.get_model(jcfg).init_params(
        jax.random.PRNGKey(0), jcfg, JRunConfig()))
    cross = jparams["groups"]["cross"]
    rng = np.random.default_rng(11)
    for gate in ("gate_attn", "gate_mlp"):
        assert not cross[gate].any()         # the JAX init: tanh(0) = 0
        cross[gate] = rng.uniform(0.3, 1.0, cross[gate].shape).astype(np.float32)
    return Pair(cfg, jcfg, jparams, registry.params_from_jax(jparams, "cpu"))


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _vision(cfg, b, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------

def test_configs_match_jax(pair):
    full, jfull = get_config(ARCH), j_get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert dataclasses.asdict(pair.cfg) == dataclasses.asdict(pair.jcfg)
    assert registry.get_model(full).forward is transformer.forward


def test_params_from_jax_keeps_group_paths_and_gates(pair):
    """``groups/selfs`` (two leading axes), ``groups/cross`` with its
    (n_groups,)-shaped tanh gates, and ``vision_proj`` cross as they are."""
    assert _shapes(pair.params) == _shapes(pair.jparams)
    assert pair.params["groups"]["selfs"]["attn"]["wq"].shape[:2] == (1, 4)
    for gate in ("gate_attn", "gate_mlp"):
        np.testing.assert_array_equal(
            pair.params["groups"]["cross"][gate].numpy(),
            pair.jparams["groups"]["cross"][gate])
    seeded = registry.init_params(pair.cfg, RunConfig(),
                                  torch.Generator().manual_seed(0), "cpu")
    assert _shapes(seeded) == _shapes(pair.jparams)
    assert not seeded["groups"]["cross"]["gate_attn"].any()


def test_full_config_param_count(monkeypatch):
    """9.79 B parameters, as the JAX package's ``params_specs`` counts them
    (36.5 GiB fp32); the port's seeded init has those shapes at full width
    (drawn on the meta device, so nothing is allocated)."""
    specs = j_registry.params_specs(j_get_config(ARCH), JRunConfig())
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(specs))
    assert round(n / 1e9, 2) == 9.79

    def meta(gen, shape, device):
        return torch.empty(shape, device="meta")
    monkeypatch.setattr(common, "randn", meta)
    monkeypatch.setattr(transformer, "randn", meta)
    got = transformer.init_params(get_config(ARCH), RunConfig(),
                                  torch.Generator(), "meta")
    assert _shapes(got) == _shapes(specs)


# ---------------------------------------------------------------------------
# cross-attention, forward, decode, loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,t", [(12, 16), (20, 7)])
def test_cross_attention_matches_jax(pair, s, t):
    """``full_attention(x_kv=...)``: the flash wrapper's plain version,
    non-causal with T != S, against JAX's einsum path with mask None."""
    jp = jax.tree.map(lambda a: np.array(a[0]),
                      pair.jparams["groups"]["cross"]["attn"])
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 64)).astype(np.float32)
    xkv = rng.standard_normal((2, t, 64)).astype(np.float32)
    pos = np.zeros((2, s), np.int32)
    want = j_attention.full_attention(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
        positions=jnp.asarray(pos), theta=5e5, x_kv=jnp.asarray(xkv))
    got = attention.full_attention(
        registry.params_from_jax(jp, "cpu"), torch.from_numpy(x),
        positions=torch.from_numpy(pos), theta=5e5,
        x_kv=torch.from_numpy(xkv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


def test_forward_matches_jax(pair):
    toks, vis = _tokens(pair.cfg, (2, 24)), _vision(pair.cfg, 2)
    want = j_transformer.forward(pair.jparams, pair.jcfg, JRunConfig(),
                                 jnp.asarray(toks),
                                 vision_embeds=jnp.asarray(vis))
    got = transformer.forward(pair.params, pair.cfg, RunConfig(),
                              torch.from_numpy(toks).long(),
                              vision_embeds=torch.from_numpy(vis))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    # the gates matter: with them at 0 the logits move
    zero = {**pair.params, "groups": {**pair.params["groups"], "cross": {
        **pair.params["groups"]["cross"],
        "gate_attn": torch.zeros(1), "gate_mlp": torch.zeros(1)}}}
    off = transformer.forward(zero, pair.cfg, RunConfig(),
                              torch.from_numpy(toks).long(),
                              vision_embeds=torch.from_numpy(vis))
    assert (off - got).abs().max().item() > 1e-2


def test_forward_without_vision_embeds_raises(pair):
    with pytest.raises(ValueError, match="vision_embeds"):
        transformer.forward(pair.params, pair.cfg, RunConfig(),
                            torch.zeros(1, 4, dtype=torch.long))


def test_decode_step_matches_jax(pair):
    """10 teacher-forced decode steps: the logits, every self-layer cache
    and the cross K/V (``vision_kv``) against JAX's."""
    toks, vis = _tokens(pair.cfg, (2, 10), seed=3), _vision(pair.cfg, 2, seed=3)
    jstate = j_transformer.init_decode_state(pair.jparams, pair.jcfg,
                                             JRunConfig(), 2, 16,
                                             vision_embeds=jnp.asarray(vis))
    state = transformer.init_decode_state(pair.params, pair.cfg, RunConfig(),
                                          2, 16,
                                          vision_embeds=torch.from_numpy(vis))
    for g, w in zip(state.vision_kv, jstate.vision_kv):
        assert tuple(g.shape) == w.shape == (1, 2, 16, 2, 16)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **LOGIT_TOL)
    step = jax.jit(lambda p, t, s: j_transformer.decode_step(
        p, pair.jcfg, JRunConfig(), t, s))
    for t in range(toks.shape[1]):
        want, jstate = step(pair.jparams, jnp.asarray(toks[:, t:t + 1]), jstate)
        got, state = transformer.decode_step(
            pair.params, pair.cfg, RunConfig(),
            torch.from_numpy(toks[:, t:t + 1]).long(), state)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    selfs, jselfs = state.caches["selfs"], jstate.caches["selfs"]
    assert state.pos == selfs.pos == 10
    for g, w in ((selfs.k, jselfs.k), (selfs.v, jselfs.v)):
        assert tuple(g.shape) == w.shape == (1, 4, 2, 16, 2, 16)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **LOGIT_TOL)
    for g, w in zip(state.vision_kv, jstate.vision_kv):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **LOGIT_TOL)


def test_decode_matches_forward_prefix(pair):
    toks, vis = _tokens(pair.cfg, (2, 12), seed=5), _vision(pair.cfg, 2, 5)
    full = transformer.forward(pair.params, pair.cfg, RunConfig(),
                               torch.from_numpy(toks).long(),
                               vision_embeds=torch.from_numpy(vis))
    state = transformer.init_decode_state(pair.params, pair.cfg, RunConfig(),
                                          2, 16,
                                          vision_embeds=torch.from_numpy(vis))
    for t in range(toks.shape[1]):
        got, state = transformer.decode_step(
            pair.params, pair.cfg, RunConfig(),
            torch.from_numpy(toks[:, t:t + 1]).long(), state)
        torch.testing.assert_close(got[:, 0], full[:, t], **LOGIT_TOL)


@pytest.mark.parametrize("ce_chunk", [0, 8])
def test_train_loss_matches_jax(pair, ce_chunk):
    """``batch["vision_embeds"]`` goes through ``common.train_loss`` to
    ``forward``, dense and chunked."""
    toks = np.random.default_rng(3).integers(0, pair.cfg.vocab, (2, 33))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32),
             "vision_embeds": _vision(pair.cfg, 2, seed=4)}
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

def test_generate_batch_and_serve_with_frontend_match_jax(pair):
    jeng = j_engine.ServeEngine(pair.jcfg, JRunConfig(), pair.jparams,
                                batch_size=2, max_len=48, seed=0)
    eng = engine.ServeEngine(pair.cfg, RunConfig(), pair.params, batch_size=2,
                             max_len=48, seed=0, device="cpu")
    prompts = _tokens(pair.cfg, (2, 12), seed=1)
    front = {"vision_embeds": _vision(pair.cfg, 2, seed=1)}
    np.testing.assert_array_equal(eng.generate_batch(prompts, 6, front),
                                  jeng.generate_batch(prompts, 6, front))
    rng = np.random.default_rng(1)
    specs = [(rng.integers(0, pair.cfg.vocab, 8).astype(np.int32), 3 + i % 3,
              {"vision_embeds": _vision(pair.cfg, 1, seed=10 + i)[0]})
             for i in range(4)]
    got = eng.serve([engine.Request(i, p, n, f)
                     for i, (p, n, f) in enumerate(specs)])
    want = jeng.serve([j_engine.Request(i, p, n, f)
                       for i, (p, n, f) in enumerate(specs)])
    assert [c.rid for c in got] == [c.rid for c in want] == list(range(4))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)


def test_kv_tau_caches_within_one_bin_and_vision_kv_raw(pair):
    cfg, jcfg = pair.cfg, pair.jcfg
    prompts, vis = _tokens(cfg, (2, 10), seed=6), _vision(cfg, 2, seed=6)
    jeng = j_engine.ServeEngine(jcfg, JRunConfig(), pair.jparams, batch_size=2,
                                max_len=16, kv_tau=KV_TAU)
    eng = engine.ServeEngine(cfg, RunConfig(), pair.params, batch_size=2,
                             max_len=16, kv_tau=KV_TAU, device="cpu")
    jstate = jeng.api.init_decode_state(pair.jparams, jcfg, JRunConfig(), 2,
                                        16, vision_embeds=jnp.asarray(vis))
    jstate, _ = jeng._prefill(pair.jparams, jnp.asarray(prompts), jstate)
    state = eng.api.init_decode_state(pair.params, cfg, RunConfig(), 2, 16,
                                      vision_embeds=torch.from_numpy(vis))
    state, _ = eng.prefill(torch.from_numpy(prompts).long(), state)
    jstate = jeng._compress_kv(jstate)
    raw = state.vision_kv
    state = eng._compress_kv(state)
    assert state.vision_kv is raw          # the cross K/V are not quantized
    bin_size = 2.0 * KV_TAU / np.sqrt(cfg.resolved_head_dim * cfg.n_kv_heads)
    for got, want in ((state.caches["selfs"].k, jstate.caches["selfs"].k),
                      (state.caches["selfs"].v, jstate.caches["selfs"].v)):
        diff = np.abs(got.numpy() - np.asarray(want))
        assert diff.max() <= bin_size * (1 + 1e-5)
        assert np.mean(diff > 1e-5) <= 1e-3


def test_serve_cli_exits_2_for_the_vlm(capsys):
    """The launcher makes no frontend (nor does the JAX package's), so it
    refuses the vlm family with a message that names it."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
    assert e.value.code == 2
    assert "frontend" in capsys.readouterr().err
