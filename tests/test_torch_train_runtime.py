"""The port's training runtime against the JAX package's, on the CPU: the
token pipeline, ``CheckpointManager`` (and a step directory the JAX package
wrote), ``ResilientRunner`` and the ``launch/train.py`` CLI.

The batches must equal the JAX package's byte for byte, and a restored tree
its saved leaves bit for bit.  The runner tests mirror
``tests/test_checkpoint.py`` and ``tests/test_failures.py`` with torch
scalars for the state; the chaos run trains the reduced qwen2-1.5b and ends
bit for bit where the uninterrupted run ends (the CPU's arithmetic is
deterministic, and a restored state equals the saved one).
"""
from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import tokens as j_tokens
from repro.runtime.checkpoint import CheckpointManager as JManager
from repro.train import loop as j_loop
from repro.train import optim as j_opt
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.data.tokens import (PrefetchIterator, SyntheticCorpus,
                                     TokenPipelineConfig, make_iterator)
from repro_torch.models import registry
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.failures import (ResilientRunner,
                                          SimulatedDeviceFailure, chaos_wrap)
from repro_torch.train import loop
from repro_torch.train import optim as t_opt
from repro_torch.train.loop import TrainState
from repro_torch.train.optim import AdamState

ROOT = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# token pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shard_index,shard_count", [(0, 1), (1, 4)])
def test_batch_at_equals_jax_bytes(shard_index, shard_count):
    kw = dict(vocab=1000, seq_len=16, global_batch=8, seed=7,
              shard_index=shard_index, shard_count=shard_count)
    mine = SyntheticCorpus(TokenPipelineConfig(**kw))
    ref = j_tokens.SyntheticCorpus(j_tokens.TokenPipelineConfig(**kw))
    for step in (0, 1, 17, 1000):
        a, b = mine.batch_at(step), ref.batch_at(step)
        for key in ("tokens", "labels"):
            assert a[key].dtype == b[key].dtype == np.int32
            assert a[key].tobytes() == b[key].tobytes()


def test_make_iterator_follows_batch_at_from_its_step():
    cfg = TokenPipelineConfig(vocab=50, seq_len=8, global_batch=4)
    it = make_iterator(cfg, start_step=5)
    try:
        for step in range(5, 9):
            assert next(it)["tokens"].tobytes() == \
                SyntheticCorpus(cfg).batch_at(step)["tokens"].tobytes()
    finally:
        it.close()


def test_prefetch_iterator_reraises_a_worker_crash_and_joins():
    corpus = SyntheticCorpus(TokenPipelineConfig(vocab=50, seq_len=8,
                                                 global_batch=4))
    real = corpus.batch_at

    def crashing(step):
        if step >= 2:
            raise ValueError("corrupt shard")
        return real(step)

    corpus.batch_at = crashing
    it = PrefetchIterator(corpus, start_step=0, depth=2)
    try:
        assert next(it)["tokens"].shape == (4, 8)
        assert next(it)["tokens"].shape == (4, 8)
        with pytest.raises(ValueError, match="corrupt shard"):
            for _ in range(4):
                next(it)
        with pytest.raises(ValueError, match="corrupt shard"):
            next(it)
    finally:
        it.close()
    assert not it._thread.is_alive()


def test_prefetch_iterator_close_joins_a_blocked_worker():
    it = PrefetchIterator(SyntheticCorpus(TokenPipelineConfig(
        vocab=50, seq_len=8, global_batch=4)), start_step=0, depth=1)
    deadline = time.monotonic() + 5.0
    while it.q.empty() and time.monotonic() < deadline:
        time.sleep(0.005)
    it.close()
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)
    it.close()


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"layer": {"w": torch.randn(32, 16, generator=g),
                      "b": torch.zeros(16)},
            "step": torch.tensor(seed, dtype=torch.int32)}


def _equal(a, b):
    for x, y in zip(t_opt.tree_leaves(a), t_opt.tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _mgr(tmp_path, **kw):
    return CheckpointManager(str(tmp_path), device="cpu", **kw)


def test_save_restore_roundtrip(tmp_path):
    mgr = _mgr(tmp_path, async_save=False)
    mgr.save(3, _tree(3))
    step, back = mgr.restore()
    assert step == 3 and sorted(back) == ["layer", "step"]
    _equal(back, _tree(3))


def test_async_save_then_wait(tmp_path):
    mgr = _mgr(tmp_path, async_save=True)
    t = _tree(1)
    mgr.save(1, t)
    t["layer"]["w"].add_(1.0)       # the save fetched the tensors already
    mgr.wait()
    assert mgr.latest_step() == 1
    _equal(mgr.restore()[1], _tree(1))


def test_retention(tmp_path):
    mgr = _mgr(tmp_path, retention=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [3, 4]


def test_torn_save_falls_back(tmp_path):
    mgr = _mgr(tmp_path, async_save=False)
    mgr.save(1, _tree(1))
    mgr.save(2, _tree(2))
    with open(os.path.join(mgr._step_dir(2), "arrays.npz"), "wb") as f:
        f.write(b"garbage")
    step, back = mgr.restore()
    assert step == 1 and int(back["step"]) == 1


def test_hash_mismatch_detected(tmp_path):
    mgr = _mgr(tmp_path, async_save=False)
    mgr.save(5, _tree(5))
    d = mgr._step_dir(5)
    data = dict(np.load(os.path.join(d, "arrays.npz")))
    data["t0"] = data["t0"] + 1.0
    np.savez(os.path.join(d, "arrays.npz"), **data)
    with pytest.raises(FileNotFoundError):
        mgr.restore()


def test_restore_needs_a_device_without_a_card(tmp_path):
    """Without a device the restore goes to the card; with no card it raises
    at once instead of reading every step as torn."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, _tree(1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mgr.restore()
    assert mgr.restore(device="cpu")[0] == 1


def _jax_state(mode):
    from repro.configs import get_config as j_get_config
    from repro.configs.base import RunConfig as JRunConfig
    from repro.models import registry as j_registry

    jcfg = j_registry.reduced_config(j_get_config("qwen2-1.5b"))
    return j_loop.init_train_state(
        jax.random.PRNGKey(0), jcfg, JRunConfig(gradient_compression=mode),
        j_opt.adamw(1e-3))


@pytest.mark.parametrize("mode", ["none", "pca_ef"])
def test_jax_written_train_state_restores_in_the_port(tmp_path, mode):
    """A step directory of the JAX ``CheckpointManager`` (with its
    ``treedef.pkl``, which the port never opens) restores as the port's
    ``TrainState`` with every leaf equal."""
    j_state = _jax_state(mode)
    JManager(str(tmp_path), async_save=False).save(7, j_state)
    step, back = _mgr(tmp_path).restore()
    assert step == 7
    assert type(back) is TrainState and type(back.opt) is AdamState
    assert (back.gc is None) == (mode == "none")
    want = registry.train_state_from_jax(jax.device_get(j_state), "cpu")
    got_leaves = t_opt.tree_leaves(list(back))
    assert len(got_leaves) == len(jax.tree.leaves(j_state))
    _equal(list(back), list(want))


def test_port_train_state_round_trips_and_keeps_jax_paths(tmp_path):
    import json

    state = registry.train_state_from_jax(
        jax.device_get(_jax_state("pca_ef")), "cpu")
    mgr = _mgr(tmp_path, async_save=False)
    mgr.save(2, state)
    with open(os.path.join(mgr._step_dir(2), "manifest.json")) as f:
        paths = [t["path"] for t in json.load(f)["tensors"]]
    jax_paths = _jax_paths(_jax_state("pca_ef"))
    assert paths == jax_paths
    assert ".params/embed/w" in paths and ".opt/.step" in paths
    _, back = mgr.restore()
    _equal(list(back), list(state))


def _jax_paths(tree):
    from repro.runtime.checkpoint import _flatten_with_paths
    return [p for p, _ in _flatten_with_paths(tree)[0]]


# ---------------------------------------------------------------------------
# ResilientRunner
# ---------------------------------------------------------------------------

def _data_iter(start):
    def gen():
        s = start
        while True:
            yield {"i": s}
            s += 1
    return iter(gen())


def _counting_step(state, batch):
    return state + 1, {"loss": torch.tensor(0.5)}


def test_runner_recovers_from_injected_failures(tmp_path):
    seen = []

    def step_fn(state, batch):
        seen.append(int(batch["i"]))
        return state + 1, {"loss": 1.0 / (state + 1.0)}

    runner = ResilientRunner(chaos_wrap(step_fn, {3, 7}),
                             _mgr(tmp_path, async_save=False), _data_iter,
                             save_every=2, max_retries=5)
    state, end = runner.run(torch.zeros(()), 0, 10)
    assert end == 10 and runner.stats.restores == 2
    assert sorted(set(seen)) == list(range(10))


def test_runner_skips_nan_batches(tmp_path):
    def step_fn(state, batch):
        loss = float("nan") if int(batch["i"]) == 2 else 0.5
        return state + 1, {"loss": torch.tensor(loss)}

    runner = ResilientRunner(step_fn, _mgr(tmp_path, async_save=False),
                             _data_iter, save_every=100, anomaly_policy="skip")
    state, end = runner.run(torch.zeros(()), 0, 6)
    assert runner.stats.skipped_batches == 1 and end == 6
    assert int(state) == 5                  # the NaN step's state was dropped


def test_retry_budget_exhaustion_reraises(tmp_path):
    def always_fails(state, batch):
        raise SimulatedDeviceFailure("node is gone for good")

    events = []
    runner = ResilientRunner(always_fails, _mgr(tmp_path, async_save=False),
                             _data_iter, max_retries=2,
                             on_event=lambda k, info: events.append((k, info)))
    with pytest.raises(SimulatedDeviceFailure):
        runner.run(torch.zeros(()), 0, 5)
    failures = [info for k, info in events if k == "failure"]
    assert len(failures) == 3 and failures[-1]["retry"] == 3


def test_anomaly_restore_policy_rolls_back(tmp_path):
    spiked = {"done": False}

    def step_fn(state, batch):
        loss = 0.5
        if int(batch["i"]) == 3 and not spiked["done"]:
            spiked["done"] = True
            loss = float("nan")
        return state + 1, {"loss": torch.tensor(loss)}

    events = []
    runner = ResilientRunner(step_fn, _mgr(tmp_path, async_save=False),
                             _data_iter, save_every=2,
                             anomaly_policy="restore",
                             on_event=lambda k, info: events.append((k, info)))
    state, end = runner.run(torch.zeros(()), 0, 6)
    assert end == 6 and runner.stats.restores == 1
    assert [i for k, i in events if k == "restore"] == [{"step": 2}]
    assert int(state) == 6


def test_cold_restore_fallback_without_checkpoint(tmp_path):
    events = []
    runner = ResilientRunner(chaos_wrap(_counting_step, {1}),
                             _mgr(tmp_path, async_save=False), _data_iter,
                             save_every=100, max_retries=3,
                             on_event=lambda k, info: events.append((k, info)))
    state, end = runner.run(torch.zeros(()), 0, 4)
    assert end == 4
    assert [i for k, i in events if k == "restore"] == [{"step": 0,
                                                         "cold": True}]
    assert int(state) == 5


def test_preemption_checkpoints_and_stops(tmp_path):
    box = {}

    def step_fn(state, batch):
        if int(batch["i"]) == 2:
            box["r"].request_preemption()
        return state + 1, {"loss": torch.tensor(0.5)}

    events = []
    mgr = _mgr(tmp_path, async_save=False)
    runner = ResilientRunner(step_fn, mgr, _data_iter, save_every=100,
                             on_event=lambda k, info: events.append((k, info)))
    box["r"] = runner
    state, end = runner.run(torch.zeros(()), 0, 10)
    assert end == 3 and ("preempted", {"step": 3}) in events
    step, back = mgr.restore()
    assert step == 3 and int(back) == 3


def test_data_iterator_crash_counts_as_step_failure(tmp_path):
    crashed = {"done": False}

    def make_iter(start):
        def gen():
            s = start
            while True:
                if s == 2 and not crashed["done"]:
                    crashed["done"] = True
                    raise RuntimeError("prefetch worker died")
                yield {"i": s}
                s += 1
        return iter(gen())

    events = []
    runner = ResilientRunner(_counting_step, _mgr(tmp_path, async_save=False),
                             make_iter, save_every=100, max_retries=3,
                             on_event=lambda k, info: events.append((k, info)))
    _, end = runner.run(torch.zeros(()), 0, 4)
    failures = [i for k, i in events if k == "failure"]
    assert end == 4 and len(failures) == 1
    assert "prefetch worker died" in failures[0]["error"]
    assert runner.stats.restores == 1


def test_chaos_run_of_the_train_step_ends_where_the_clean_run_ends(tmp_path):
    """The reduced qwen2-1.5b trained 6 steps through the runner, with
    failures injected at calls 2 and 5, restores twice and ends with the
    params, moments and step of the uninterrupted run, bit for bit."""
    cfg = registry.reduced_config(get_config("qwen2-1.5b"))
    run = RunConfig(ce_chunk=8)
    opt = t_opt.adamw(t_opt.warmup_cosine_schedule(1e-3, 2, 6),
                      weight_decay=0.01, max_grad_norm=1.0)
    corpus = SyntheticCorpus(TokenPipelineConfig(vocab=cfg.vocab, seq_len=16,
                                                 global_batch=2))

    def batches(start):
        return (corpus.batch_at(s) for s in range(start, 10 ** 9))

    finals = []
    for name, fail_at in (("clean", set()), ("chaos", {2, 5})):
        state = loop.init_train_state(torch.Generator().manual_seed(0), cfg,
                                      run, opt, "cpu")
        runner = ResilientRunner(
            chaos_wrap(loop.make_train_step(cfg, run, opt), fail_at),
            _mgr(tmp_path / name, async_save=False), batches, save_every=2)
        state, end = runner.run(state, 0, 6)
        assert end == 6 and runner.stats.restores == len(fail_at)
        finals.append(state)
    _equal(list(finals[0]), list(finals[1]))
    assert int(finals[1].step) == int(finals[1].opt.step) == 6


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cli(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    common = ["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
              "--batch", "2", "--seq", "32", "--save-every", "2", "--ckpt",
              str(tmp_path)]
    first = _cli(*common, "--steps", "4")
    assert first.returncode == 0, first.stderr
    assert "done: steps 0->4" in first.stdout and "restores=0" in first.stdout
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4]
    again = _cli(*common, "--steps", "2", "--resume")
    assert again.returncode == 0, again.stderr
    assert "resumed at step 4" in again.stdout
    assert "done: steps 4->6" in again.stdout


@pytest.mark.parametrize("mode", ["pca_ef", "gae"])
def test_cli_runs_gradient_compression(tmp_path, mode):
    out = _cli("--arch", "mamba2-370m", "--reduced", "--device", "cpu",
               "--batch", "2", "--seq", "32", "--steps", "2",
               "--grad-compression", mode, "--ckpt", str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert "done: steps 0->2" in out.stdout


def test_cli_refuses_tensor_parallelism_at_parse_time():
    """What the launcher does not train under ``--tp``, before any device
    is asked for: the audio family, whose batches need a frontend, with
    gradient compression or without (gradient compression trains under
    ``--tp`` on every other family: ``tests/test_torch_train_tp.py``)."""
    for extra in ((), ("--grad-compression", "pca_ef")):
        out = _cli("--arch", "whisper-medium", "--tp", "2", *extra,
                   timeout=60)
        assert out.returncode == 2
        assert "frontend" in out.stderr
