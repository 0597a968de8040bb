"""The port's LM inference path against the JAX package's, on the CPU.

For the reduced configs of qwen1.5 (MHA), qwen2 (GQA), qwen3 (qk-norm) and
mamba2 (SSD), JAX params are carried across with ``params_from_jax`` and the
same numpy-made tokens go through both packages.

Tolerances: logits 1e-4 (fp32, sums in another order through a few layers);
greedy tokens equal; the ``kv_tau`` cache within one quantization bin, and
only at entries whose quotient x / bin lies at a half-way point (the jitted
JAX quantizer multiplies by 1/bin where the port divides, ROADMAP.md §3), so
at most 0.1 % of the entries may move a bin.
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
from repro.models import registry as j_registry
from repro.runtime import kvcache as j_kvcache
from repro.serve import engine as j_engine
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.models import registry
from repro_torch.runtime import kvcache
from repro_torch.serve import engine

ARCHS = ["qwen1.5-0.5b", "qwen2-1.5b", "qwen3-1.7b", "mamba2-370m"]
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
KV_TAU = 0.05


@dataclasses.dataclass
class Pair:
    cfg: object
    jcfg: object
    jparams: dict
    params: dict


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg = j_registry.reduced_config(j_get_config(arch))
    cfg = registry.reduced_config(get_config(arch))
    jparams = jax.device_get(j_registry.get_model(jcfg).init_params(
        jax.random.PRNGKey(0), jcfg, JRunConfig()))
    return Pair(cfg, jcfg, jparams, registry.params_from_jax(jparams, "cpu"))


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _requests(cfg, cls, seed=1):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, cfg.vocab, 8).astype(np.int32),
                max_new_tokens=3 + i % 3) for i in range(5)]


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
    assert dataclasses.asdict(pair.cfg) == dataclasses.asdict(pair.jcfg)
    full, jfull = get_config(pair.cfg.arch), j_get_config(pair.cfg.arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert full.padded_vocab(1) == full.vocab


def test_params_from_jax_keeps_paths_and_values(pair):
    assert _shapes(pair.params) == _shapes(pair.jparams)
    w = pair.jparams["layers"]
    key = "attn" if "attn" in w else "ssd"
    leaf = "wq" if key == "attn" else "in_proj"
    np.testing.assert_array_equal(pair.params["layers"][key][leaf].numpy(),
                                  w[key][leaf])


def test_seeded_init_has_jax_shapes_and_scales(pair):
    cfg = pair.cfg
    params = registry.init_params(cfg, RunConfig(),
                                  torch.Generator().manual_seed(0), "cpu")
    assert _shapes(params) == _shapes(pair.jparams)
    assert all(v.dtype == torch.float32 for v in _leaves(params))
    emb = params["embed"]["w"]
    assert abs(emb.std().item() - 0.02) < 0.002
    again = registry.init_params(cfg, RunConfig(),
                                 torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["embed"]["w"], emb)


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


@pytest.mark.parametrize("field,value", [
    ("param_dtype", "bfloat16"), ("dp", 2), ("remat", True),
    ("scan_layers", False), ("ce_chunk", 512), ("sp", True),
    ("moe_dispatch_groups", 2), ("cast_params_early", True),
    ("gradient_compression", "gae"), ("grad_comp_rank", 8),
    ("grad_comp_tau", 0.1)])
def test_run_config_refuses_what_the_port_does_not_honour(field, value):
    JRunConfig(**{field: value})             # the JAX package takes it
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        RunConfig(**{field: value})


def test_run_config_takes_what_the_port_honours():
    run = RunConfig(tp=1, compute_dtype="bfloat16", use_flash_kernel=True)
    assert run == dataclasses.replace(RunConfig(), compute_dtype="bfloat16",
                                      use_flash_kernel=True)
    assert ({f.name for f in dataclasses.fields(RunConfig)}
            == {f.name for f in dataclasses.fields(JRunConfig)})


# ---------------------------------------------------------------------------
# forward and decode
# ---------------------------------------------------------------------------

def test_forward_matches_jax(pair):
    toks = _tokens(pair.cfg, (2, 24))
    want = j_registry.get_model(pair.jcfg).forward(
        pair.jparams, pair.jcfg, JRunConfig(), jnp.asarray(toks))
    got = registry.get_model(pair.cfg).forward(
        pair.params, pair.cfg, RunConfig(), torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_forward_bf16_matches_jax(pair):
    """``compute_dtype="bfloat16"``, the JAX package's deployment dtype, in
    both packages on the same params and tokens.  The two frameworks round
    to bf16 (8 significant bits) at other places, so the logits are held to
    a share of max |logit|: 3 % for the dense models and 5 % for mamba2,
    whose SSD state carries the rounding through a longer recurrence.  The
    port measured 1.6 % (qwen1.5), 1.2 % (qwen2, qwen3) and 2.9 % (mamba2),
    under JAX's own bf16-against-fp32 difference on these inputs (1.9, 1.5,
    1.4 and 3.0 %)."""
    toks = _tokens(pair.cfg, (2, 24))
    want = np.asarray(j_registry.get_model(pair.jcfg).forward(
        pair.jparams, pair.jcfg, JRunConfig(compute_dtype="bfloat16"),
        jnp.asarray(toks)), np.float32)
    got = registry.get_model(pair.cfg).forward(
        pair.params, pair.cfg, RunConfig(compute_dtype="bfloat16"),
        torch.from_numpy(toks).long())
    assert got.dtype == torch.bfloat16
    share = 0.05 if pair.cfg.family == "ssm" else 0.03
    diff = np.abs(got.float().numpy() - want).max()
    assert diff <= share * np.abs(want).max(), (diff, np.abs(want).max())


def test_decode_step_teacher_forcing_matches_jax(pair):
    toks = _tokens(pair.cfg, (2, 12), seed=3)
    japi, api = j_registry.get_model(pair.jcfg), registry.get_model(pair.cfg)
    jstate = japi.init_decode_state(pair.jparams, pair.jcfg, JRunConfig(), 2, 32)
    state = api.init_decode_state(pair.params, pair.cfg, RunConfig(), 2, 32)
    step = jax.jit(lambda p, t, s: japi.decode_step(p, pair.jcfg, JRunConfig(),
                                                    t, s))
    for t in range(toks.shape[1]):
        want, jstate = step(pair.jparams, jnp.asarray(toks[:, t:t + 1]), jstate)
        got, state = api.decode_step(pair.params, pair.cfg, RunConfig(),
                                     torch.from_numpy(toks[:, t:t + 1]).long(),
                                     state)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert state.pos == toks.shape[1]


def test_forward_matches_engine_prefill(pair):
    """The port's own consistency: ``forward``'s last-position logits (the
    kernels' path) against the engine's decode-step prefill (plain code)."""
    toks = _tokens(pair.cfg, (2, 20), seed=5)
    eng = engine.ServeEngine(pair.cfg, RunConfig(), pair.params, batch_size=2,
                             max_len=32, device="cpu")
    state = eng.api.init_decode_state(pair.params, pair.cfg, RunConfig(), 2, 32)
    _, logits = eng.prefill(torch.from_numpy(toks).long(), state)
    full = eng.api.forward(pair.params, pair.cfg, RunConfig(),
                           torch.from_numpy(toks).long())
    torch.testing.assert_close(logits, full[:, -1], **LOGIT_TOL)


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
    got = eng.serve(_requests(pair.cfg, engine.Request))
    want = jeng.serve(_requests(pair.cfg, j_engine.Request))
    assert [c.rid for c in got] == [c.rid for c in want] == list(range(5))
    for g, w in zip(got, want):
        assert g.prompt_len == w.prompt_len
        np.testing.assert_array_equal(g.tokens, w.tokens)


def test_kv_tau_cache_matches_jax_within_one_bin(pair):
    cfg, jcfg = pair.cfg, pair.jcfg
    prompts = _tokens(cfg, (2, 10), seed=6)
    jeng = j_engine.ServeEngine(jcfg, JRunConfig(), pair.jparams, batch_size=2,
                                max_len=16, kv_tau=KV_TAU)
    eng = engine.ServeEngine(cfg, RunConfig(), pair.params, batch_size=2,
                             max_len=16, kv_tau=KV_TAU, device="cpu")
    jstate = jeng.api.init_decode_state(pair.jparams, jcfg, JRunConfig(), 2, 16)
    jstate, _ = jeng._prefill(pair.jparams, jnp.asarray(prompts), jstate)
    state = eng.api.init_decode_state(pair.params, cfg, RunConfig(), 2, 16)
    state, _ = eng.prefill(torch.from_numpy(prompts).long(), state)
    if cfg.family == "ssm":          # no KV cache: the state passes unchanged
        assert eng._compress_kv(state) is state
        return
    jstate = jeng._compress_kv(jstate)
    state = eng._compress_kv(state)
    bin_size = 2.0 * KV_TAU / np.sqrt(cfg.resolved_head_dim * cfg.n_kv_heads)
    for got, want in ((state.caches.k, jstate.caches.k),
                      (state.caches.v, jstate.caches.v)):
        diff = np.abs(got.numpy() - np.asarray(want))
        assert diff.max() <= bin_size * (1 + 1e-5)
        assert np.mean(diff > 1e-5) <= 1e-3


def test_kv_tau_serving_matches_jax_tokens():
    cfg = registry.reduced_config(get_config("qwen3-1.7b"))
    jcfg = j_registry.reduced_config(j_get_config("qwen3-1.7b"))
    jparams = jax.device_get(j_registry.get_model(jcfg).init_params(
        jax.random.PRNGKey(1), jcfg, JRunConfig()))
    params = registry.params_from_jax(jparams, "cpu")
    prompts = _tokens(cfg, (2, 12), seed=1)
    jeng = j_engine.ServeEngine(jcfg, JRunConfig(), jparams, batch_size=2,
                                max_len=48, kv_tau=0.01)
    eng = engine.ServeEngine(cfg, RunConfig(), params, batch_size=2,
                             max_len=48, kv_tau=0.01, device="cpu")
    np.testing.assert_array_equal(eng.generate_batch(prompts, 6),
                                  jeng.generate_batch(prompts, 6))


def test_temperature_sampling_follows_the_seed():
    cfg = registry.reduced_config(get_config("qwen2-1.5b"))
    params = registry.init_params(cfg, RunConfig(),
                                  torch.Generator().manual_seed(0), "cpu")
    prompts = _tokens(cfg, (2, 6))

    def run(seed):
        eng = engine.ServeEngine(cfg, RunConfig(), params, batch_size=2,
                                 max_len=16, temperature=1.0, seed=seed,
                                 device="cpu")
        return eng.generate_batch(prompts, 8)
    out = run(0)
    np.testing.assert_array_equal(out, run(0))
    assert not np.array_equal(out, run(1))
    assert np.all((out >= 0) & (out < cfg.vocab))


# ---------------------------------------------------------------------------
# the paged KV archive
# ---------------------------------------------------------------------------

def test_compress_pages_keeps_every_page_within_tau():
    rng = np.random.default_rng(0)
    kv = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    pages = kvcache.paginate(kv)
    assert pages.shape == (2, 4, kvcache.PAGE_TOKENS * 2 * 16)
    np.testing.assert_array_equal(kvcache.unpaginate(pages, 2, 16), kv)
    flat = pages.reshape(-1, pages.shape[-1])
    tau = 0.25
    recon, store = kvcache.compress_pages(
        flat, tau=tau, page_shape=(kvcache.PAGE_TOKENS, 2, 16), device="cpu")
    assert np.linalg.norm(flat - recon, axis=1).max() <= tau * (1 + 1e-5)
    np.testing.assert_allclose(kvcache.decompress_pages(store), recon,
                               atol=1e-5)
    assert 0 < store.nbytes() < store.raw_nbytes()
    # with the JAX package's basis, the reconstruction is the JAX one's
    jrecon, jstore = j_kvcache.compress_pages(
        flat, tau=tau, page_shape=(kvcache.PAGE_TOKENS, 2, 16))
    recon2, _ = kvcache.compress_pages(flat, tau=tau, basis=jstore.basis,
                                       page_shape=(kvcache.PAGE_TOKENS, 2, 16),
                                       device="cpu")
    np.testing.assert_allclose(recon2, jrecon, atol=1e-5)


# ---------------------------------------------------------------------------
# entry points and what is not ported
# ---------------------------------------------------------------------------

def test_serve_cli_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "mamba2-370m", "--reduced", "--device", "cpu",
                "--requests", "3", "--batch", "2", "--prompt-len", "8",
                "--max-new", "3", "--max-len", "32", "--kv-tau", "0.05"])
    out = capsys.readouterr().out
    assert "3 completions, 9 tokens" in out and "on cpu" in out


def test_entry_points_run_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    cfg = registry.reduced_config(get_config("qwen2-1.5b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        registry.init_params(cfg, RunConfig(), torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.ServeEngine(cfg, RunConfig(), {}, batch_size=1, max_len=8)


def test_unported_archs_and_features_raise():
    with pytest.raises(KeyError, match="ROADMAP.md"):
        get_config("granite-moe-3b-a800m")
    moe = dataclasses.replace(
        registry.reduced_config(get_config("qwen2-1.5b")), family="moe")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        registry.get_model(moe)
    from repro_torch.models import attention, transformer
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        transformer.init_params(moe, RunConfig(), torch.Generator(), "cpu")
    x = torch.zeros(1, 2, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        attention.full_attention({}, x, positions=torch.arange(2), x_kv=x)
