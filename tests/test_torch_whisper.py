"""The port's audio family (whisper-medium: a bidirectional encoder over
precomputed frame embeddings, a decoder with learned positions, causal
self-attention and cross-attention) against the JAX package's, on the CPU.

For the reduced config (2 encoder and 4 decoder layers, 4 heads on 4 KV
heads of 16 as whisper is MHA, 24 frames), JAX
params are carried across with ``params_from_jax`` after every bias and
layer-norm parameter is set to seeded values on the JAX side (the init
leaves them at 0 and 1, where a bias added to the wrong tensor would go
unseen), and the same numpy-made tokens and frames go through both
packages.

Tolerances: the layer-norm and GELU-MLP helpers 1e-5 and the sinusoids 2e-4
at whisper-medium's own (1500, 1024) (fp32 angles up to 1500 rad, where
one ulp of the angle is 1.2e-4); encoder output, logits, caches and cross
K/V 1e-4 (fp32 through a few layers, as ``test_torch_lm.py``); losses rtol
3e-5 and the AdamW steps as ``test_torch_train.py`` holds them (one step
within Adam's first-step bound, three steps within 1 % of their summed
learning rate); greedy tokens equal; the ``kv_tau`` caches within one bin.
The key biases ``bk`` are the one exception in the steps: their gradient is
zero in exact arithmetic (``q . bk`` is the same for every key of a query,
and softmax does not see a shift), so what either package computes is
rounding noise, about 1e-10; it is held below 1e-6 of the largest gradient,
and after the steps, where Adam turns that noise into moves of up to the
learning rate, each ``bk`` within the summed learning rate of JAX's.
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
from repro.models import common as j_common
from repro.models import registry as j_registry
from repro.models import whisper as j_whisper
from repro.serve import engine as j_engine
from repro.train import loop as j_loop
from repro.train import optim as j_opt
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.models import common, registry, whisper
from repro_torch.serve import engine
from repro_torch.train import loop
from repro_torch.train import optim as t_opt
from test_torch_train import (EPS, PEAK_LR, TOTAL, WARMUP, _adam_first_step_bound,
                              _clipped)

ARCH = "whisper-medium"
HELPER_TOL = dict(atol=1e-5, rtol=1e-5)
SINCOS_ATOL = 2e-4
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_RTOL = 3e-5
GRAD_FRAC = 1e-5
KV_TAU = 0.05
# three steps: 1 % of the summed learning rate, as test_torch_train.py
# holds five
THREE_STEP_LR = sum(
    float(t_opt.warmup_cosine_schedule(PEAK_LR, WARMUP, TOTAL)(i))
    for i in range(1, 4))
THREE_STEP_ATOL = 0.01 * THREE_STEP_LR
ZERO_GRAD_FRAC = 1e-6
assert EPS == 1e-8


@dataclasses.dataclass
class Pair:
    cfg: object
    jcfg: object
    jparams: dict
    params: dict


def _seed_zero_init(tree, rng):
    """Biases and layer-norm shifts to N(0, 0.1), layer-norm scales to
    1 + N(0, 0.1), in place (numpy leaves)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _seed_zero_init(v, rng)
        elif k in ("bq", "bk", "bv", "b_in", "b_out", "bias"):
            tree[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k == "scale":
            tree[k] = (1 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)


def _jparams(jcfg, seed=0):
    p = jax.device_get(j_registry.get_model(jcfg).init_params(
        jax.random.PRNGKey(seed), jcfg, JRunConfig()))
    _seed_zero_init(p, np.random.default_rng(11))
    return p


@pytest.fixture(scope="module")
def pair():
    jcfg = j_registry.reduced_config(j_get_config(ARCH))
    cfg = registry.reduced_config(get_config(ARCH))
    jparams = _jparams(jcfg)
    return Pair(cfg, jcfg, jparams, registry.params_from_jax(jparams, "cpu"))


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _frames(cfg, b, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.n_frames, cfg.d_model)).astype(np.float32)


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# configs, params, helpers
# ---------------------------------------------------------------------------

def test_configs_match_jax(pair):
    full, jfull = get_config(ARCH), j_get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert dataclasses.asdict(pair.cfg) == dataclasses.asdict(pair.jcfg)
    assert (pair.cfg.n_enc_layers, pair.cfg.n_frames) == (2, 24)
    assert registry.get_model(full).forward is whisper.forward


def test_params_from_jax_keeps_encoder_and_decoder_trees(pair):
    """``enc_layers`` and ``dec_layers`` (stacked over their layers, the
    decoder's with ``xattn``) and the learned position table cross as they
    are; the port's seeded init has the same shapes."""
    assert _shapes(pair.params) == _shapes(pair.jparams)
    assert pair.params["enc_layers"]["attn"]["wq"].shape == (2, 64, 4, 16)
    assert pair.params["dec_layers"]["xattn"]["bk"].shape == (4, 4, 16)
    assert pair.params["pos_embed"]["w"].shape == (512, 64)
    np.testing.assert_array_equal(pair.params["dec_layers"]["ln3"]["bias"].numpy(),
                                  pair.jparams["dec_layers"]["ln3"]["bias"])
    seeded = registry.init_params(pair.cfg, RunConfig(),
                                  torch.Generator().manual_seed(0), "cpu")
    assert _shapes(seeded) == _shapes(pair.jparams)
    assert not seeded["dec_layers"]["mlp"]["b_in"].any()
    assert torch.all(seeded["enc_layers"]["ln1"]["scale"] == 1)


def test_full_config_param_count(monkeypatch):
    """762 663 936 parameters, as the JAX package's ``params_specs`` counts
    them (3.05 GB fp32); the port's seeded init has those shapes at full
    width (drawn on the meta device, so nothing is allocated)."""
    specs = j_registry.params_specs(j_get_config(ARCH), JRunConfig())
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(specs)) \
        == 762_663_936

    def meta(gen, shape, device):
        return torch.empty(shape, device="meta")
    monkeypatch.setattr(common, "randn", meta)
    monkeypatch.setattr(whisper, "randn", meta)
    got = whisper.init_params(get_config(ARCH), RunConfig(),
                              torch.Generator(), "meta")
    assert _shapes(got) == _shapes(specs)
    assert got["pos_embed"]["w"].shape == (4096, 1024)


@pytest.mark.parametrize("helper", ["layernorm", "sincos_positions",
                                    "embedding_init", "gelu_mlp"])
def test_common_helpers_match_jax(helper):
    rng = np.random.default_rng(3)
    if helper == "layernorm":
        x = (3 + 2 * rng.standard_normal((2, 5, 64))).astype(np.float32)
        p = {"scale": rng.standard_normal(64).astype(np.float32),
             "bias": rng.standard_normal(64).astype(np.float32)}
        want = j_common.layernorm(p, jnp.asarray(x))
        got = common.layernorm(_t(p), torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **HELPER_TOL)
        # in fp32, cast back to the input's dtype
        got16 = common.layernorm(_t(p), torch.from_numpy(x).bfloat16())
        assert got16.dtype == torch.bfloat16
        init = common.layernorm_init(64, "cpu", lead=(3,))
        assert init["scale"].shape == init["bias"].shape == (3, 64)
        assert torch.all(init["scale"] == 1) and not init["bias"].any()
    elif helper == "sincos_positions":
        got = common.sincos_positions(1500, 1024).numpy()
        want = np.asarray(j_common.sincos_positions(1500, 1024))
        assert got.shape == want.shape == (1500, 1024)
        np.testing.assert_allclose(got, want, rtol=0, atol=SINCOS_ATOL)
        # [sin | cos] halves, not interleaved: position 0 is [0...0 | 1...1]
        np.testing.assert_array_equal(got[0], np.r_[np.zeros(512), np.ones(512)])
    elif helper == "embedding_init":
        w = common.embedding_init(torch.Generator().manual_seed(0), 4096, 64,
                                  "cpu")["w"]
        jw = np.asarray(j_common.embedding_init(jax.random.PRNGKey(0), 4096,
                                                64)["w"])
        assert tuple(w.shape) == jw.shape == (4096, 64)
        np.testing.assert_allclose(w.std().item(), 0.02, rtol=0.02)
        np.testing.assert_allclose(jw.std(), 0.02, rtol=0.02)
    else:
        x = rng.standard_normal((2, 5, 64)).astype(np.float32)
        p = {"w_in": rng.standard_normal((64, 128)).astype(np.float32) / 8,
             "b_in": rng.standard_normal(128).astype(np.float32),
             "w_out": rng.standard_normal((128, 64)).astype(np.float32) / 11,
             "b_out": rng.standard_normal(64).astype(np.float32)}
        want = j_common.gelu_mlp(p, jnp.asarray(x))
        got = common.gelu_mlp(_t(p), torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **HELPER_TOL)
        init = common.gelu_mlp_init(torch.Generator().manual_seed(0), 64, 128,
                                    "cpu", lead=(2,))
        assert {k: tuple(v.shape) for k, v in init.items()} == {
            "w_in": (2, 64, 128), "b_in": (2, 128), "w_out": (2, 128, 64),
            "b_out": (2, 64)}


# ---------------------------------------------------------------------------
# encode, forward, decode, loss
# ---------------------------------------------------------------------------

def test_encode_matches_jax(pair):
    fr = _frames(pair.cfg, 2)
    want = j_whisper.encode(pair.jparams, pair.jcfg, JRunConfig(),
                            jnp.asarray(fr))
    got = whisper.encode(pair.params, pair.cfg, RunConfig(),
                         torch.from_numpy(fr))
    assert tuple(got.shape) == (2, 24, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


@pytest.mark.parametrize("max_seq,s", [(512, 24), (16, 40)])
def test_forward_matches_jax(max_seq, s):
    """At max_seq 16 the learned position table has 16 rows and the 40
    decoder positions wrap around it (``pos % 16``)."""
    jcfg = dataclasses.replace(j_registry.reduced_config(j_get_config(ARCH)),
                               max_seq=max_seq)
    cfg = dataclasses.replace(registry.reduced_config(get_config(ARCH)),
                              max_seq=max_seq)
    jparams = _jparams(jcfg)
    params = registry.params_from_jax(jparams, "cpu")
    assert params["pos_embed"]["w"].shape[0] == min(max_seq, 4096)
    toks, fr = _tokens(cfg, (2, s)), _frames(cfg, 2)
    want = j_whisper.forward(jparams, jcfg, JRunConfig(), jnp.asarray(toks),
                             jnp.asarray(fr))
    got = whisper.forward(params, cfg, RunConfig(),
                          torch.from_numpy(toks).long(), torch.from_numpy(fr))
    assert tuple(got.shape) == (2, s, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_decode_step_matches_jax(pair):
    """20 teacher-forced decode steps: the logits, every self-attention
    cache and the cross K/V against JAX's."""
    toks, fr = _tokens(pair.cfg, (2, 20), seed=3), _frames(pair.cfg, 2, seed=3)
    jstate = j_whisper.init_decode_state(pair.jparams, pair.jcfg, JRunConfig(),
                                         2, 24, jnp.asarray(fr))
    state = whisper.init_decode_state(pair.params, pair.cfg, RunConfig(), 2,
                                      24, torch.from_numpy(fr))
    for g, w in zip(state.cross_kv, jstate.cross_kv):
        assert tuple(g.shape) == w.shape == (4, 2, 24, 4, 16)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **LOGIT_TOL)
    step = jax.jit(lambda p, t, s: j_whisper.decode_step(
        p, pair.jcfg, JRunConfig(), t, s))
    for t in range(toks.shape[1]):
        want, jstate = step(pair.jparams, jnp.asarray(toks[:, t:t + 1]), jstate)
        got, state = whisper.decode_step(
            pair.params, pair.cfg, RunConfig(),
            torch.from_numpy(toks[:, t:t + 1]).long(), state)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert state.pos == state.caches.pos == 20
    for g, w in ((state.caches.k, jstate.caches.k),
                 (state.caches.v, jstate.caches.v)):
        assert tuple(g.shape) == w.shape == (4, 2, 24, 4, 16)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **LOGIT_TOL)
    for g, w in zip(state.cross_kv, jstate.cross_kv):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **LOGIT_TOL)


def test_decode_matches_forward_prefix(pair):
    toks, fr = _tokens(pair.cfg, (2, 12), seed=5), _frames(pair.cfg, 2, 5)
    full = whisper.forward(pair.params, pair.cfg, RunConfig(),
                           torch.from_numpy(toks).long(), torch.from_numpy(fr))
    state = whisper.init_decode_state(pair.params, pair.cfg, RunConfig(), 2,
                                      16, torch.from_numpy(fr))
    for t in range(toks.shape[1]):
        got, state = whisper.decode_step(
            pair.params, pair.cfg, RunConfig(),
            torch.from_numpy(toks[:, t:t + 1]).long(), state)
        torch.testing.assert_close(got[:, 0], full[:, t], **LOGIT_TOL)


def _batch(cfg, seed=0, b=4, s=32):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (b, s + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
            "frames": _frames(cfg, b, seed=seed + 100)}


@pytest.mark.parametrize("ce_chunk", [0, 8])
def test_train_loss_matches_jax(pair, ce_chunk):
    """The dense CE on the full logits; ``ce_chunk`` is not read, as in
    JAX: both equal JAX's dense loss."""
    batch = _batch(pair.cfg, b=2)
    want = j_whisper.train_loss(pair.jparams, pair.jcfg, JRunConfig(),
                                _j(batch))
    got = whisper.train_loss(pair.params, pair.cfg,
                             RunConfig(ce_chunk=ce_chunk), _t(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _states(pair):
    def make(m):
        return m.adamw(m.warmup_cosine_schedule(PEAK_LR, WARMUP, TOTAL),
                       weight_decay=0.01, max_grad_norm=1.0)
    j_o, t_o = make(j_opt), make(t_opt)
    j_state = j_loop.init_train_state(jax.random.PRNGKey(0), pair.jcfg,
                                      JRunConfig(), j_o)
    j_state = j_state._replace(params=jax.tree.map(jnp.asarray, pair.jparams))
    t_state = registry.train_state_from_jax(jax.device_get(j_state), "cpu")
    return j_o, t_o, j_state, t_state


def _leaves_t(tree):
    return [x.detach().numpy() for x in t_opt.tree_leaves(tree)]


def _leaves_j(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _is_key_bias(tree):
    """Per leaf, in ``jax.tree.leaves`` order: whether it is a key bias."""
    return [path[-1].key == "bk"
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_one_step_matches_jax(pair):
    j_o, t_o, j_state, t_state = _states(pair)
    batch = _batch(pair.cfg, seed=2)
    j_new, j_m = jax.jit(j_loop.make_train_step(pair.jcfg, JRunConfig(), j_o))(
        j_state, _j(batch))
    before = _leaves_t(t_state.params)
    t_new, t_m = loop.make_train_step(pair.cfg, RunConfig(), t_o)(t_state,
                                                                  batch)
    np.testing.assert_allclose(float(t_m["loss"]), float(j_m["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(t_m["grad_norm"]),
                               float(j_m["grad_norm"]), rtol=1e-5)
    assert int(t_new.step) == 1
    j_l, j_g = jax.jit(jax.value_and_grad(
        lambda p: j_whisper.train_loss(p, pair.jcfg, JRunConfig(),
                                       _j(batch))))(j_state.params)
    t_l, t_g = loop.value_and_grad(pair.cfg, RunConfig())(t_state.params,
                                                          _t(batch))
    gj, gt = _leaves_j(j_g), _leaves_t(t_g)
    largest = max(np.abs(a).max() for a in gj)
    for a, b, bk in zip(gj, gt, _is_key_bias(j_g)):
        if bk:
            assert max(np.abs(a).max(), np.abs(b).max()) \
                <= ZERO_GRAD_FRAC * largest
            continue
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=GRAD_FRAC * np.abs(a).max())
    lr = float(t_opt.warmup_cosine_schedule(PEAK_LR, WARMUP, TOTAL)(1))
    for p, a, b, cj, ct in zip(before, _leaves_j(j_new.params),
                               _leaves_t(t_new.params), _clipped(gj),
                               _clipped(gt)):
        assert np.all(np.abs(b - a) <= _adam_first_step_bound(p, cj, ct, lr))


def test_three_steps_follow_jax(pair):
    j_o, t_o, j_state, t_state = _states(pair)
    j_step = jax.jit(j_loop.make_train_step(pair.jcfg, JRunConfig(), j_o))
    t_step = loop.make_train_step(pair.cfg, RunConfig(), t_o)
    j_losses, t_losses = [], []
    for i in range(3):
        batch = _batch(pair.cfg, seed=10 + i)
        j_state, j_m = j_step(j_state, _j(batch))
        t_state, t_m = t_step(t_state, batch)
        j_losses.append(float(j_m["loss"]))
        t_losses.append(float(t_m["loss"]))
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    for a, b, bk in zip(_leaves_j(j_state.params), _leaves_t(t_state.params),
                        _is_key_bias(j_state.params)):
        np.testing.assert_allclose(
            b, a, rtol=0, atol=THREE_STEP_LR if bk else THREE_STEP_ATOL)
    assert int(t_state.step) == 3


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_generate_batch_and_serve_with_frames_match_jax(pair):
    """The port's counterpart of
    ``test_system.py::test_serve_whisper_with_frames_frontend``: the same
    greedy tokens as the JAX engine, batched and through continuous
    batching with each request's own frames."""
    jeng = j_engine.ServeEngine(pair.jcfg, JRunConfig(), pair.jparams,
                                batch_size=2, max_len=32, seed=0)
    eng = engine.ServeEngine(pair.cfg, RunConfig(), pair.params, batch_size=2,
                             max_len=32, seed=0, device="cpu")
    prompts = _tokens(pair.cfg, (2, 4), seed=1)
    front = {"frames": _frames(pair.cfg, 2, seed=1)}
    np.testing.assert_array_equal(eng.generate_batch(prompts, 6, front),
                                  jeng.generate_batch(prompts, 6, front))
    rng = np.random.default_rng(1)
    specs = [(rng.integers(0, pair.cfg.vocab, 4).astype(np.int32), 3 + i % 3,
              {"frames": _frames(pair.cfg, 1, seed=10 + i)[0]})
             for i in range(3)]
    got = eng.serve([engine.Request(i, p, n, f)
                     for i, (p, n, f) in enumerate(specs)])
    want = jeng.serve([j_engine.Request(i, p, n, f)
                       for i, (p, n, f) in enumerate(specs)])
    assert [c.rid for c in got] == [c.rid for c in want] == list(range(3))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)


def test_kv_tau_caches_within_one_bin_and_cross_kv_raw(pair):
    cfg, jcfg = pair.cfg, pair.jcfg
    prompts, fr = _tokens(cfg, (2, 10), seed=6), _frames(cfg, 2, seed=6)
    jeng = j_engine.ServeEngine(jcfg, JRunConfig(), pair.jparams, batch_size=2,
                                max_len=16, kv_tau=KV_TAU)
    eng = engine.ServeEngine(cfg, RunConfig(), pair.params, batch_size=2,
                             max_len=16, kv_tau=KV_TAU, device="cpu")
    jstate = jeng.api.init_decode_state(pair.jparams, jcfg, JRunConfig(), 2,
                                        16, jnp.asarray(fr))
    jstate, _ = jeng._prefill(pair.jparams, jnp.asarray(prompts), jstate)
    state = eng.api.init_decode_state(pair.params, cfg, RunConfig(), 2, 16,
                                      torch.from_numpy(fr))
    state, _ = eng.prefill(torch.from_numpy(prompts).long(), state)
    jstate = jeng._compress_kv(jstate)
    raw = state.cross_kv
    state = eng._compress_kv(state)
    assert state.cross_kv is raw          # the cross K/V are not quantized
    for g, w in zip(state.cross_kv, jstate.cross_kv):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **LOGIT_TOL)
    bin_size = 2.0 * KV_TAU / np.sqrt(cfg.resolved_head_dim * cfg.n_kv_heads)
    for got, want in ((state.caches.k, jstate.caches.k),
                      (state.caches.v, jstate.caches.v)):
        diff = np.abs(got.numpy() - np.asarray(want))
        assert diff.max() <= bin_size * (1 + 1e-5)
        assert np.mean(diff > 1e-5) <= 1e-3


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_serve_cli_exits_2_for_whisper(capsys):
    """The launcher makes no frames (the JAX one announces random frames
    but passes none), so it refuses the audio family with a message that
    names the frontend."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "frontend" in err and "frames" in err


@pytest.mark.parametrize("arch,payload", [("whisper-medium", "frames"),
                                          ("llama-3.2-vision-11b",
                                           "vision_embeds")])
def test_train_cli_exits_2_for_frontend_families(capsys, tmp_path, arch,
                                                 payload):
    """The token pipeline makes no frames or vision embeddings, so the
    train launcher refuses the audio and vlm families at parse time,
    before any state is made."""
    from repro_torch.launch import train
    with pytest.raises(SystemExit) as e:
        train.main(["--arch", arch, "--reduced", "--steps", "1", "--device",
                    "cpu", "--ckpt", str(tmp_path / "ck")])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "frontend" in err and payload in err
    assert not (tmp_path / "ck").exists()
