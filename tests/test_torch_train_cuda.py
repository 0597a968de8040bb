"""The LM training path on the card, without JAX.

One train step of reduced qwen2-1.5b and mamba2-370m on the card (the
flash_attention and ssd_scan kernels in their ``autograd.Function``s)
against the same step on the CPU (their plain versions); the ``gae``
gradient compression on the card (the gae_project and quantize kernels)
within tau; a checkpoint restored onto the card; and a chaos run of the
``ResilientRunner`` on the card ending where the clean run ends.

The file imports no JAX, so it runs on a machine with a card and no JAX:
``python -m pytest -m cuda tests/test_torch_train_cuda.py``.  Every test
skips without a card.

Tolerances: the loss at 1e-5 relative and every gradient at 1e-5 of its
leaf's largest (fp32 sums in another order; TF32 off), as ``chip_smoke.py``
holds them; every ``gae`` block within tau; the chaos run's final state
within 1 % of its summed learning rate of the clean run's (the bound of
``tests/test_torch_train.py``; any reduction whose order varies on the card
moves Adam's update where |g| is near eps).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.data.tokens import SyntheticCorpus, TokenPipelineConfig
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.gae_project import ops as gp
from repro_torch.kernels.quantize import ops as qz
from repro_torch.kernels.ssd_scan import ops as sd
from repro_torch.models import registry
from repro_torch.runtime import grad_compress
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.failures import ResilientRunner, chaos_wrap
from repro_torch.train import loop, optim

ARCHS = {"qwen2-1.5b": fa.launches, "mamba2-370m": sd.launches}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _setup(arch):
    cfg = registry.reduced_config(get_config(arch))
    params = registry.init_params(cfg, RunConfig(),
                                  torch.Generator().manual_seed(0), "cpu")
    batch = SyntheticCorpus(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=64, global_batch=2)).batch_at(0)
    return cfg, params, batch


def _to(tree, dev):
    return optim.tree_map(lambda t: t.to(dev), tree)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_step_on_the_card_matches_the_cpu(card, arch):
    cfg, params, batch = _setup(arch)
    run = RunConfig(ce_chunk=16)
    grad_fn = loop.value_and_grad(cfg, run)
    l_cpu, g_cpu = grad_fn(params, batch)
    counter = ARCHS[arch]
    counter.reset()
    l_dev, g_dev = grad_fn(_to(params, card), batch)
    assert counter.value == cfg.n_layers
    np.testing.assert_allclose(float(l_dev), float(l_cpu), rtol=1e-5)
    for a, b in zip(optim.tree_leaves(g_cpu), optim.tree_leaves(g_dev)):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=0,
                                   atol=1e-5 * float(a.abs().max()))


@pytest.mark.cuda
def test_gae_gradients_on_the_card_within_tau(card):
    cfg, params, batch = _setup("mamba2-370m")
    _, grads = loop.value_and_grad(cfg, RunConfig())(_to(params, card),
                                                     batch)
    tau = 1e-3
    gp.launches.reset()
    qz.launches.reset()
    out, stats = grad_compress.gae_compress_grads(grads, tau=tau)
    n = len(optim.tree_leaves(grads))
    assert gp.launches.value == qz.launches.value == n
    for g, o in zip(optim.tree_leaves(grads), optim.tree_leaves(out)):
        d = (g - o).reshape(-1).cpu().numpy()
        d = np.pad(d, (0, -d.size % 256)).reshape(-1, 256)
        assert np.linalg.norm(d, axis=1).max() <= tau * (1 + 1e-4)
    assert 0.0 < float(stats["keep_frac"]) <= 1.0


@pytest.mark.cuda
def test_checkpoint_restores_onto_the_card(card, tmp_path):
    cfg, params, _ = _setup("qwen2-1.5b")
    opt = optim.adamw(1e-3)
    state = loop.TrainState(params=_to(params, card),
                            opt=opt.init(_to(params, card)), gc=None,
                            step=torch.zeros((), dtype=torch.int32,
                                             device=card))
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(3, state)
    step, back = mgr.restore()
    assert step == 3 and type(back) is loop.TrainState
    for a, b in zip(optim.tree_leaves(list(state)),
                    optim.tree_leaves(list(back))):
        assert b.device.type == "cuda" and torch.equal(a, b)


@pytest.mark.cuda
def test_chaos_run_on_the_card_ends_where_the_clean_run_ends(card, tmp_path):
    cfg, _, _ = _setup("qwen2-1.5b")
    run = RunConfig(ce_chunk=16)
    sched = optim.warmup_cosine_schedule(1e-3, 2, 6)
    opt = optim.adamw(sched, weight_decay=0.01, max_grad_norm=1.0)
    corpus = SyntheticCorpus(TokenPipelineConfig(vocab=cfg.vocab, seq_len=64,
                                                 global_batch=2))
    finals = []
    for name, fails in (("clean", set()), ("chaos", {2, 5})):
        state = loop.init_train_state(torch.Generator().manual_seed(0), cfg,
                                      run, opt, card)
        runner = ResilientRunner(
            chaos_wrap(loop.make_train_step(cfg, run, opt), fails),
            CheckpointManager(str(tmp_path / name), async_save=False,
                              device=card),
            lambda s: (corpus.batch_at(i) for i in range(s, 10 ** 9)),
            save_every=2)
        state, end = runner.run(state, 0, 6)
        assert end == 6 and runner.stats.restores == len(fails)
        finals.append(state)
    bound = 0.01 * sum(float(sched(i)) for i in range(1, 7))
    for a, b in zip(optim.tree_leaves(list(finals[0])),
                    optim.tree_leaves(list(finals[1]))):
        assert float((a.float() - b.float()).abs().max()) <= bound
