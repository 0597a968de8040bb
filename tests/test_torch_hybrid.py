"""The port's recurrentgemma (RG-LRU + local attention hybrid) against the
JAX package's, on the CPU.

For the reduced config (5 layers: one (rec, rec, attn) triple and two tail
recurrent layers, window 16, lru width 64), and the same with head_dim 256
(the full model's, so that the hd-256 path and the window run), JAX params
are carried across with ``params_from_jax`` and the same numpy-made inputs
go through both packages.

Tolerances: logits, recurrent states and caches 1e-4 (fp32, sums in
another order: the port's doubling scan composes the recurrence's steps in
another order than ``jax.lax.associative_scan``); bf16 logits 5 % of max
|logit| (the test says why); losses rtol 3e-5, as
``test_torch_train.py``; the blocks' pieces 1e-6 (one op apart); greedy
tokens equal; the ``kv_tau`` ring caches within one bin, as
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
from repro.models import attention as j_attention
from repro.models import registry as j_registry
from repro.models import rglru as j_rglru
from repro.serve import engine as j_engine
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.models import attention, registry, rglru
from repro_torch.serve import engine

ARCH = "recurrentgemma-9b"
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
PIECE_TOL = dict(atol=1e-6, rtol=1e-6)
LOSS_RTOL = 3e-5
KV_TAU = 0.05


@dataclasses.dataclass
class Pair:
    cfg: object
    jcfg: object
    jparams: dict
    params: dict


def _pair(head_dim=None) -> Pair:
    jcfg = j_registry.reduced_config(j_get_config(ARCH))
    cfg = registry.reduced_config(get_config(ARCH))
    if head_dim:
        jcfg = dataclasses.replace(jcfg, head_dim=head_dim)
        cfg = dataclasses.replace(cfg, head_dim=head_dim)
    jparams = jax.device_get(j_registry.get_model(jcfg).init_params(
        jax.random.PRNGKey(0), jcfg, JRunConfig()))
    return Pair(cfg, jcfg, jparams, registry.params_from_jax(jparams, "cpu"))


@pytest.fixture(scope="module", params=[None, 256], ids=["hd16", "hd256"])
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def small():
    return _pair()


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


# ---------------------------------------------------------------------------
# config and params
# ---------------------------------------------------------------------------

def test_configs_match_jax():
    full, jfull = get_config(ARCH), j_get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert (dataclasses.asdict(registry.reduced_config(full))
            == dataclasses.asdict(j_registry.reduced_config(jfull)))
    assert registry.get_model(full).forward is rglru.forward


def test_params_have_jax_paths_and_shapes(pair):
    assert _shapes(pair.params) == _shapes(pair.jparams)
    assert set(pair.params) == {"embed", "final_norm", "unembed", "triples",
                                "tail"}
    np.testing.assert_array_equal(
        pair.params["triples"]["rec1"]["lru"]["alpha"].numpy(),
        pair.jparams["triples"]["rec1"]["lru"]["alpha"])
    seeded = registry.init_params(pair.cfg, RunConfig(),
                                  torch.Generator().manual_seed(0), "cpu")
    assert _shapes(seeded) == _shapes(pair.jparams)
    assert all(v.dtype == torch.float32 for v in _leaves(seeded))
    alpha = seeded["triples"]["rec2"]["lru"]["alpha"]
    assert 0.7 <= alpha.min().item() and alpha.max().item() <= 0.95
    assert abs(seeded["embed"]["w"].std().item() - 0.02) < 0.002


def test_full_config_param_count():
    """10.445 B parameters, as the JAX package's ``params_specs`` counts
    them (38.9 GiB in fp32)."""
    specs = j_registry.params_specs(j_get_config(ARCH), JRunConfig())
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(specs))
    assert round(n / 1e9, 3) == 10.445


# ---------------------------------------------------------------------------
# the blocks' pieces
# ---------------------------------------------------------------------------

def _rec_params(pair):
    return (jax.tree.map(lambda x: jnp.asarray(x[0]),
                         pair.jparams["triples"]["rec1"]),
            registry.params_from_jax(jax.tree.map(
                lambda x: x[0], pair.jparams["triples"]["rec1"]), "cpu"))


def test_causal_conv_and_lru_coeffs_match_jax(small):
    jp, p = _rec_params(small)
    x = np.random.default_rng(1).standard_normal((2, 37, 64)).astype(np.float32)
    want = j_rglru._causal_conv(jp["conv"], jnp.asarray(x))
    got = rglru._causal_conv(p["conv"], torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PIECE_TOL)
    for g, w in zip(rglru._lru_coeffs(p["lru"], torch.from_numpy(x)),
                    j_rglru._lru_coeffs(jp["lru"], jnp.asarray(x))):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **PIECE_TOL)
    # bf16 input: the coefficients stay float32
    a, b = rglru._lru_coeffs(p["lru"], torch.from_numpy(x).to(torch.bfloat16))
    assert a.dtype == b.dtype == torch.float32


def test_geglu_uses_the_tanh_gelu(small):
    """``jax.nn.gelu`` defaults to the tanh approximation, torch's gelu to
    the exact erf: the port must take the former."""
    jp, p = _rec_params(small)
    x = 3 * np.random.default_rng(2).standard_normal((2, 5, 64)).astype(np.float32)
    want = np.asarray(j_rglru._geglu(jp["mlp"], jnp.asarray(x)))
    got = rglru._geglu(p["mlp"], torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **PIECE_TOL)
    erf = ((torch.nn.functional.gelu(torch.from_numpy(x) @ p["mlp"]["w_gate"])
            * (torch.from_numpy(x) @ p["mlp"]["w_in"])) @ p["mlp"]["w_out"])
    assert np.abs(erf.numpy() - want).max() > 100 * PIECE_TOL["atol"]


@pytest.mark.parametrize("s", [1, 37, 300])
def test_linear_scan_matches_associative_scan(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (2, s, 8)).astype(np.float32)
    b = rng.standard_normal((2, s, 8)).astype(np.float32)

    def combine(left, right):
        return left[0] * right[0], right[0] * left[1] + right[1]
    wa, wb = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)),
                                      axis=1)
    ga, gb = rglru.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), **LOGIT_TOL)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), **LOGIT_TOL)
    # and the recurrence itself, stepped in float64
    h, hs = np.zeros((2, 8)), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    np.testing.assert_allclose(gb.numpy(), np.stack(hs, 1), **LOGIT_TOL)


# ---------------------------------------------------------------------------
# forward, loss and decode
# ---------------------------------------------------------------------------

def test_forward_matches_jax(pair):
    toks = _tokens(pair.cfg, (2, 40))            # past the window of 16
    want = j_rglru.forward(pair.jparams, pair.jcfg, JRunConfig(),
                           jnp.asarray(toks))
    got = rglru.forward(pair.params, pair.cfg, RunConfig(),
                        torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_forward_bf16_matches_jax(pair):
    """``compute_dtype="bfloat16"`` in both packages: the activations in
    bf16, the recurrence's coefficients and state in fp32.  The frameworks
    round to bf16 at other places, so the logits are held to 5 % of max
    |logit|, as ``test_torch_lm.py`` holds mamba2's recurrence.  The port
    measured 2.6 % (hd 16) and 2.7 % (hd 256), under JAX's own bf16
    against fp32 on these inputs (4.5 and 4.0 %)."""
    toks = _tokens(pair.cfg, (2, 40))
    want = np.asarray(j_rglru.forward(
        pair.jparams, pair.jcfg, JRunConfig(compute_dtype="bfloat16"),
        jnp.asarray(toks)), np.float32)
    got = rglru.forward(pair.params, pair.cfg,
                        RunConfig(compute_dtype="bfloat16"),
                        torch.from_numpy(toks).long())
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want).max()
    assert diff <= 0.05 * np.abs(want).max(), (diff, np.abs(want).max())


@pytest.mark.parametrize("ce_chunk", [0, 8])
def test_train_loss_matches_jax(pair, ce_chunk):
    toks = np.random.default_rng(3).integers(0, pair.cfg.vocab, (2, 33))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    want = j_rglru.train_loss(
        jax.tree.map(jnp.asarray, pair.jparams), pair.jcfg,
        JRunConfig(ce_chunk=ce_chunk),
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = rglru.train_loss(pair.params, pair.cfg, RunConfig(ce_chunk=ce_chunk),
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def test_decode_through_the_wrapped_ring_matches_jax(pair):
    """40 decode steps with a window of 16: the ring buffer wraps twice.
    Logits, every recurrent state and the caches against JAX's."""
    toks = _tokens(pair.cfg, (2, 40), seed=4)
    jstate = j_rglru.init_decode_state(pair.jparams, pair.jcfg, JRunConfig(),
                                       2, 64)
    state = rglru.init_decode_state(pair.params, pair.cfg, RunConfig(), 2, 64)
    assert state.triples["attn"].k.shape[2] == pair.cfg.window == 16
    step = jax.jit(lambda p, t, s: j_rglru.decode_step(p, pair.jcfg,
                                                       JRunConfig(), t, s))
    for t in range(toks.shape[1]):
        want, jstate = step(pair.jparams, jnp.asarray(toks[:, t:t + 1]), jstate)
        got, state = rglru.decode_step(pair.params, pair.cfg, RunConfig(),
                                       torch.from_numpy(toks[:, t:t + 1]).long(),
                                       state)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert state.pos == state.triples["attn"].pos == 40
    pairs = [(state.triples["attn"].k, jstate.triples["attn"].k),
             (state.triples["attn"].v, jstate.triples["attn"].v),
             (state.tail.h, jstate.tail.h),
             (state.tail.conv_buf, jstate.tail.conv_buf)]
    for name in ("rec1", "rec2"):
        pairs += [(state.triples[name].h, jstate.triples[name].h),
                  (state.triples[name].conv_buf, jstate.triples[name].conv_buf)]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert state.triples["rec1"].h.dtype == torch.float32


def test_decode_matches_forward_prefix(small):
    """Decode (ring buffer, one state update a step) against ``forward``
    (windowed attention, the log-depth scan) at every position."""
    toks = _tokens(small.cfg, (2, 40), seed=5)
    full = rglru.forward(small.params, small.cfg, RunConfig(),
                         torch.from_numpy(toks).long())
    state = rglru.init_decode_state(small.params, small.cfg, RunConfig(), 2, 64)
    for t in range(toks.shape[1]):
        got, state = rglru.decode_step(small.params, small.cfg, RunConfig(),
                                       torch.from_numpy(toks[:, t:t + 1]).long(),
                                       state)
        torch.testing.assert_close(got[:, 0], full[:, t], **LOGIT_TOL)


@pytest.mark.parametrize("s", [10, 16, 37])
def test_prefill_cache_matches_jax(small, s):
    """The ring-buffer fill: S <= window writes the prefix, S > window the
    last ``window`` keys at slot t % window."""
    p = jax.tree.map(lambda x: x[0],
                     small.jparams["triples"]["attn_layer"]["attn"])
    x = np.random.default_rng(s).standard_normal((2, s, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    want = j_attention.prefill_cache(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        positions=jnp.asarray(pos), theta=1e4, rope=True, max_len=64,
        window=16)
    got = attention.prefill_cache(
        registry.params_from_jax(p, "cpu"), torch.from_numpy(x),
        positions=torch.from_numpy(pos.copy()), theta=1e4, rope=True,
        max_len=64, window=16)
    assert got.pos == int(want.pos) == s and got.window == 16
    for g, w in ((got.k, want.k), (got.v, want.v)):
        assert tuple(g.shape) == w.shape == (2, 16, 1, 16)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **PIECE_TOL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_generate_batch_and_serve_match_jax(pair):
    jeng = j_engine.ServeEngine(pair.jcfg, JRunConfig(), pair.jparams,
                                batch_size=2, max_len=48, seed=0)
    eng = engine.ServeEngine(pair.cfg, RunConfig(), pair.params, batch_size=2,
                             max_len=48, seed=0, device="cpu")
    prompts = _tokens(pair.cfg, (2, 12), seed=1)
    np.testing.assert_array_equal(eng.generate_batch(prompts, 8),
                                  jeng.generate_batch(prompts, 8))
    rng = np.random.default_rng(1)
    specs = [(rng.integers(0, pair.cfg.vocab, 20).astype(np.int32), 3 + i % 3)
             for i in range(4)]
    got = eng.serve([engine.Request(i, p, n) for i, (p, n) in enumerate(specs)])
    want = jeng.serve([j_engine.Request(i, p, n)
                       for i, (p, n) in enumerate(specs)])
    assert [c.rid for c in got] == [c.rid for c in want] == list(range(4))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)


def test_kv_tau_ring_caches_match_jax_within_one_bin(pair):
    cfg = pair.cfg
    prompts = _tokens(cfg, (2, 20), seed=6)        # wraps the ring of 16
    jeng = j_engine.ServeEngine(pair.jcfg, JRunConfig(), pair.jparams,
                                batch_size=2, max_len=32, kv_tau=KV_TAU)
    eng = engine.ServeEngine(cfg, RunConfig(), pair.params, batch_size=2,
                             max_len=32, kv_tau=KV_TAU, device="cpu")
    jstate = jeng.api.init_decode_state(pair.jparams, pair.jcfg, JRunConfig(),
                                        2, 32)
    jstate, _ = jeng._prefill(pair.jparams, jnp.asarray(prompts), jstate)
    state = eng.api.init_decode_state(pair.params, cfg, RunConfig(), 2, 32)
    state, _ = eng.prefill(torch.from_numpy(prompts).long(), state)
    jstate = jeng._compress_kv(jstate)
    raw_k, rec1 = state.triples["attn"].k.clone(), state.triples["rec1"]
    state = eng._compress_kv(state)
    assert not torch.equal(state.triples["attn"].k, raw_k)
    assert state.triples["rec1"] is rec1      # recurrent states pass as they are
    bin_size = 2.0 * KV_TAU / np.sqrt(cfg.resolved_head_dim * cfg.n_kv_heads)
    for got, want in ((state.triples["attn"].k, jstate.triples["attn"].k),
                      (state.triples["attn"].v, jstate.triples["attn"].v)):
        diff = np.abs(got.numpy() - np.asarray(want))
        assert diff.max() <= bin_size * (1 + 1e-5)
        assert np.mean(diff > 1e-5) <= 1e-3
    np.testing.assert_array_equal(
        eng.generate_batch(prompts, 6),
        j_engine.ServeEngine(pair.jcfg, JRunConfig(), pair.jparams,
                             batch_size=2, max_len=32,
                             kv_tau=KV_TAU).generate_batch(prompts, 6))


def test_serve_cli_runs_the_hybrid_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                "--requests", "3", "--batch", "2", "--prompt-len", "20",
                "--max-new", "3", "--max-len", "48", "--kv-tau", "0.05"])
    out = capsys.readouterr().out
    assert "3 completions, 9 tokens" in out and "on cpu" in out
