"""Elastic restore: ``CheckpointManager.restore(mesh=, shardings=)`` places
a step written by the port (any placement, FSDP's cuts over ``"data"``
included) or by the JAX package onto any mesh and spec tree that divides
it, as ``src/repro/runtime/checkpoint.py``'s ``restore`` does with
``jax.device_put``, and refuses one that does not.

The states are reduced qwen2-1.5b at ``RunConfig(tp=2)`` on the CPU, the
meshes ``["cpu"] * N``, the FSDP specs ``train_state_specs(..., fsdp=True,
min_fsdp_elems=1024)`` so that the reduced leaves are cut.  A restore onto
the placement that wrote the step resumes bit for bit; onto another layout
(tensor-parallel ``(1, 2)``, one device) one further step lands within
Adam's first-step bound of the uninterrupted run, from the two sides'
gradients, with 1 % of the learning rate beside it (the layouts sum the
same gradient in other orders), as
``tests/test_torch_train_tp_families.py`` holds a step of another program.
"""
from __future__ import annotations

import os

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
from repro_torch.models import registry
from repro_torch.parallel import fsdp, sharding
from repro_torch.parallel.sharding import NamedSharding, P, Sharded
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.train import loop
from repro_torch.train import optim as t_opt

ARCH, TP = "qwen2-1.5b", 2
PEAK_LR, WARMUP, TOTAL, EPS = 1e-3, 2, 5, 1e-8
B, S, MIN_FSDP = 4, 16, 1024


def _optimizer(m):
    return m.adamw(m.warmup_cosine_schedule(PEAK_LR, WARMUP, TOTAL),
                   weight_decay=0.01, max_grad_norm=1.0)


def _lr(step):
    return float(t_opt.warmup_cosine_schedule(PEAK_LR, WARMUP, TOTAL)(step))


def _batch(cfg, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the reduced models' ops gain
    nothing from more, and the whole suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfg():
    return registry.reduced_config(get_config(ARCH))


def _mesh(dp, tp):
    return make_mesh((dp, tp), ("data", "model"), ["cpu"] * (dp * tp))


def _whole(tree):
    return [x.detach().numpy()
            for x in t_opt.tree_leaves(sharding.unshard_params(tree))]


def _state(cfg):
    return loop.init_train_state(torch.Generator().manual_seed(0), cfg,
                                 RunConfig(tp=TP), _optimizer(t_opt), "cpu")


def _first_step_bound(p, gj, gt, lr):
    """``tests/test_torch_train.py``'s: how far two Adam first steps from
    ``p`` may land apart with gradients ``gj`` and ``gt``."""
    g_min = np.where(np.sign(gj) == np.sign(gt),
                     np.minimum(np.abs(gj), np.abs(gt)), 0.0)
    slope = lr * EPS / (g_min + EPS) ** 2
    return (slope * np.abs(gt.astype(np.float64) - gj)
            + 8 * np.spacing(np.float32(lr)) + 2 * np.spacing(np.abs(p) + lr))


def _clipped(grads):
    norm = np.sqrt(sum(np.sum(np.square(g.astype(np.float64)))
                       for g in grads))
    return [g * min(1.0, 1.0 / (norm + 1e-12)) for g in grads]


def test_elastic_restore_onto_different_device_count(tmp_path):
    """The counterpart of ``tests/test_checkpoint.py``'s: a one-device
    tree restored onto a mesh of 4 devices, replicated, by a spec tree,
    and by specs bound to the mesh; the step counter lies on the mesh's
    first device."""
    mgr = CheckpointManager(str(tmp_path), async_save=False, device="cpu")
    t = {"layer": {"w": torch.randn(32, 16, generator=torch.Generator()
                                    .manual_seed(7)),
                   "b": torch.zeros(16)},
         "step": torch.tensor(7, dtype=torch.int32)}
    mgr.save(7, t)
    mesh = make_mesh((4,), ("data",), ["cpu"] * 4)
    specs = {"layer": {"w": P(), "b": P()}, "step": P()}
    for shardings in (specs, {"layer": {k: NamedSharding(mesh, v) for k, v
                                        in specs["layer"].items()},
                              "step": NamedSharding(mesh, P())}):
        step, back = mgr.restore(mesh=mesh, shardings=shardings)
        assert step == 7
        for k in ("w", "b"):
            assert isinstance(back["layer"][k], Sharded)
            assert back["layer"][k].pieces.shape == (4,)
            torch.testing.assert_close(back["layer"][k].host(),
                                       t["layer"][k], rtol=0, atol=0)
        assert int(back["step"]) == 7
    # cut over the mesh: each device its quarter of the rows
    _, back = mgr.restore(mesh=mesh, shardings={"layer": {"w": P("data"),
                                                          "b": P()},
                                                "step": P()})
    assert back["layer"]["w"].pieces[0].shape == (8, 16)
    torch.testing.assert_close(back["layer"]["w"].host(), t["layer"]["w"],
                               rtol=0, atol=0)


def test_jax_written_step_restores_onto_fsdp_and_one_device(cfg, tmp_path):
    """A JAX-written ``TrainState`` step restored with ``mesh=,
    shardings=`` onto a ``(2, 2)`` FSDP placement holds the JAX arrays cut
    over ``"data"`` and ``"model"``, and steps as the one-device restore
    of the same step does (its first step within Adam's bound)."""
    jcfg = j_registry.reduced_config(j_get_config(ARCH))
    j_state = j_loop.init_train_state(jax.random.PRNGKey(0), jcfg,
                                      JRunConfig(tp=TP), _optimizer(j_opt))
    JCheckpointManager(str(tmp_path)).save(3, j_state, blocking=True)
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    _, one = mgr.restore(device="cpu")
    mesh = _mesh(2, 2)
    specs = sharding.train_state_specs(one, mesh, fsdp=True,
                                       min_fsdp_elems=MIN_FSDP)
    step, placed = mgr.restore(mesh=mesh, shardings=specs)
    assert step == 3
    cut = [sh for sh in sharding.sharded_leaves(placed.params)
           if fsdp.cut_dim(sh) is not None]
    assert cut and all(sh.pieces.shape == (2, 2) for sh in cut)
    for a, b in zip(_whole(placed.params),
                    [np.asarray(x) for x in jax.tree.leaves(
                        j_state.params)]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_whole(placed.opt.mu), _whole(one.opt.mu)):
        np.testing.assert_array_equal(a, b)
    run, opt = RunConfig(tp=TP), _optimizer(t_opt)
    batch = _batch(cfg, 0)
    new_f, m_f = loop.make_train_step(cfg, run, opt, mesh=mesh,
                                      shardings=specs)(placed, batch)
    new_1, m_1 = loop.make_train_step(cfg, run, opt)(one, batch)
    np.testing.assert_allclose(float(m_f["loss"]), float(m_1["loss"]),
                               rtol=1e-5)
    _, g_f = loop.tensor_parallel_value_and_grad(cfg, run, mesh)(
        placed.params, batch)
    _, g_1 = loop.value_and_grad(cfg, run)(one.params, batch)
    g1 = [x.numpy() for x in t_opt.tree_leaves(g_1)]
    for p, a, b, x, y in zip(_whole(one.params), _whole(new_f.params),
                             [x.numpy() for x in t_opt.tree_leaves(
                                 new_1.params)],
                             _clipped(_whole(g_f)), _clipped(g1)):
        assert np.all(np.abs(a - b) <= _first_step_bound(p, x, y, _lr(1))
                      + 0.01 * _lr(1))


@pytest.fixture(scope="module")
def fsdp_run(cfg, tmp_path_factory):
    """One FSDP ``(2, 2)`` step, saved (blocking), and the uninterrupted
    run's next step with its gradient."""
    d = tmp_path_factory.mktemp("fsdp_ckpt")
    run, opt = RunConfig(tp=TP), _optimizer(t_opt)
    mesh = _mesh(2, 2)
    state = _state(cfg)
    specs = sharding.train_state_specs(state, mesh, fsdp=True,
                                       min_fsdp_elems=MIN_FSDP)
    step = loop.make_train_step(cfg, run, opt, mesh=mesh, shardings=specs)
    first, _ = step(state, _batch(cfg, 0))
    mgr = CheckpointManager(str(d), device="cpu")
    mgr.save(1, first, blocking=True)
    _, g = loop.tensor_parallel_value_and_grad(cfg, run, mesh)(
        first.params, _batch(cfg, 1))
    second, m = step(first, _batch(cfg, 1))
    return dict(mgr=mgr, first=first, second=second, loss=float(m["loss"]),
                grad=_whole(g), specs=specs, mesh=mesh)


@pytest.mark.parametrize("layout", ["fsdp_2x2", "tp_1x2", "one_device"])
def test_fsdp_state_restores_onto_any_layout(cfg, fsdp_run, layout):
    """The FSDP state's step directory holds whole arrays; restored onto
    FSDP ``(2, 2)`` it resumes bit for bit, onto TP ``(1, 2)`` and one
    device within Adam's first-step bound (with 1 % of lr), then steps."""
    run, opt = RunConfig(tp=TP), _optimizer(t_opt)
    mgr, batch = fsdp_run["mgr"], _batch(cfg, 1)
    for a, b in zip(_whole(mgr.restore(device="cpu")[1].params),
                    _whole(fsdp_run["first"].params)):
        np.testing.assert_array_equal(a, b)
    if layout == "fsdp_2x2":
        mesh, specs = fsdp_run["mesh"], fsdp_run["specs"]
        _, st = mgr.restore(mesh=mesh, shardings=specs)
        new, m = loop.make_train_step(cfg, run, opt, mesh=mesh,
                                      shardings=specs)(st, batch)
        assert float(m["loss"]) == fsdp_run["loss"]
        for a, b in zip(_whole(new.params), _whole(fsdp_run["second"].params)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(_whole(new.opt.nu),
                        _whole(fsdp_run["second"].opt.nu)):
            np.testing.assert_array_equal(a, b)
        return
    if layout == "tp_1x2":
        mesh = _mesh(1, 2)
        _, st = mgr.restore(mesh=mesh, shardings=sharding.train_state_specs(
            fsdp_run["first"], mesh))
        assert loop.is_sharded(st.params)
        assert all(fsdp.cut_dim(sh) is None
                   for sh in sharding.sharded_leaves(st.params))
        _, g = loop.tensor_parallel_value_and_grad(cfg, run, mesh)(
            st.params, batch)
        g = _whole(g)
        new, m = loop.make_train_step(cfg, run, opt, mesh=mesh)(st, batch)
    else:
        _, st = mgr.restore(device="cpu")
        _, g = loop.value_and_grad(cfg, run)(st.params, batch)
        g = [x.numpy() for x in t_opt.tree_leaves(g)]
        new, m = loop.make_train_step(cfg, run, opt)(st, batch)
    np.testing.assert_allclose(float(m["loss"]), fsdp_run["loss"], rtol=1e-5)
    for p, a, b, x, y in zip(_whole(fsdp_run["first"].params),
                             _whole(new.params),
                             _whole(fsdp_run["second"].params),
                             _clipped(g), _clipped(fsdp_run["grad"])):
        assert np.all(np.abs(a - b) <= _first_step_bound(p, x, y, _lr(2))
                      + 0.01 * _lr(2))


def test_restore_refuses_specs_that_do_not_fit(cfg, fsdp_run, tmp_path):
    """A spec tree that does not match the saved tree, a spec that does
    not divide its dim, and specs without a mesh: each a ``ValueError``;
    the step directory stays restorable."""
    mgr, mesh, specs = fsdp_run["mgr"], fsdp_run["mesh"], fsdp_run["specs"]
    short = specs._replace(params={k: v for k, v in specs.params.items()
                                   if k != "final_norm"})
    with pytest.raises(ValueError, match="do not match the saved tree"):
        mgr.restore(mesh=mesh, shardings=short)
    with pytest.raises(ValueError, match="do not match the saved tree"):
        mgr.restore(mesh=mesh, shardings=specs._replace(gc=P()))
    three = make_mesh((3, 1), ("data", "model"), ["cpu"] * 3)
    with pytest.raises(ValueError, match="does not divide"):
        mgr.restore(mesh=three, shardings=specs)
    with pytest.raises(ValueError, match="no mesh"):
        mgr.restore(shardings=specs)
    t = {"w": torch.zeros(5, 4)}
    small = CheckpointManager(str(tmp_path), async_save=False, device="cpu")
    small.save(0, t)
    with pytest.raises(ValueError, match="does not divide"):
        small.restore(mesh=make_mesh((2,), ("data",), ["cpu"] * 2),
                      shardings={"w": P("data", None)})
    assert mgr.restore(mesh=mesh, shardings=specs)[0] == 1


def test_restore_refuses_a_compressed_member(tmp_path):
    """Both packages write each array as a stored member; a step whose
    ``arrays.npz`` holds a compressed one is not read (an ``IOError``
    under the restore's fallback), and the step before it restores."""
    import os

    mgr = CheckpointManager(str(tmp_path), async_save=False, device="cpu")
    for step in (1, 2):
        mgr.save(step, {"w": torch.full((8, 4), float(step))})
    path = os.path.join(mgr._step_dir(2), "arrays.npz")
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    np.savez_compressed(path, **arrays)
    with pytest.raises(FileNotFoundError) as err:
        mgr.restore(2)
    assert isinstance(err.value.__cause__, IOError)
    assert "compressed member" in str(err.value.__cause__)
    step, back = mgr.restore()
    assert step == 1
    torch.testing.assert_close(back["w"], torch.full((8, 4), 1.0))
