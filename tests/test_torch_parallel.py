"""The port's mesh, partition rules, placement, collectives and GPipe
against the JAX package's, on the CPU.

Inputs are made with numpy from a seed.  JAX's placement and pipeline need
several devices, which JAX fixes at its first import, so they run in ONE
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(``_JAX_MESH``), whose results the tests read.  The port runs the same
work over meshes of ``cpu`` repeated (its counterpart of JAX's virtual
devices), and over ``cpu`` and ``cpu:0`` (a second device object, which
takes the copy path).  Tolerances:

* partition specs, the collective accounting, and the pieces of
  ``shard_tensor``: exact;
* ``pipeline_apply`` against JAX's and against the sequential loop: atol
  1e-5 (as ``tests/test_system.py::test_gpipe_pipeline_matches_sequential``
  holds JAX's), and bit for bit between the port's meshes.
"""
from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as j_get_config
from repro.configs.base import RunConfig as JRunConfig, ShapeConfig
from repro.models import registry as j_registry
from repro.parallel import sharding as j_shd
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.core.errors import ConfigError
from repro_torch.launch import mesh as t_mesh
from repro_torch.models import registry
from repro_torch.parallel import collectives, pipeline
from repro_torch.parallel import sharding as t_shd
from repro_torch.parallel.sharding import P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["qwen1.5-0.5b", "qwen2-1.5b", "qwen3-1.7b", "mamba2-370m",
         "recurrentgemma-9b", "granite-moe-3b-a800m",
         "llama4-scout-17b-a16e", "deepseek-coder-33b",
         "llama-3.2-vision-11b", "whisper-medium"]

# (name, shape, spec) placed on a (2, 2) ("data", "model") mesh
PLACEMENTS = [("dm", (8, 6, 4), ("data", "model", None)),
              ("md", (4, 6, 8), ("model", None, "data")),
              ("joint", (8, 3), (("data", "model"), None)),
              ("joint_minor", (2, 8), (None, ("model", "data"))),
              ("replicated", (6, 5), ()),
              ("batch", (4, 16), (("data",), None))]
# GPipe: the PP script's sizes, made with numpy
PP_STAGES, PP_MICRO, PP_MB, PP_D = 4, 8, 2, 16


def _placement_input(i, shape):
    return np.random.default_rng(100 + i).standard_normal(shape).astype(
        np.float32)


def _pp_inputs():
    rng = np.random.default_rng(7)
    ws = (rng.standard_normal((PP_STAGES, PP_D, PP_D))
          / np.sqrt(PP_D)).astype(np.float32)
    x = rng.standard_normal((PP_MICRO, PP_MB, PP_D)).astype(np.float32)
    return ws, x


_JAX_MESH = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
sys.path.insert(0, {tests!r})
from test_torch_parallel import PLACEMENTS, _placement_input, _pp_inputs
from repro.parallel.pipeline import pipeline_apply

assert len(jax.devices()) == 4, jax.devices()
out = {{}}
mesh = jax.make_mesh((2, 2), ("data", "model"))
devs = mesh.devices
for i, (name, shape, spec) in enumerate(PLACEMENTS):
    a = jax.device_put(_placement_input(i, shape),
                       NamedSharding(mesh, P(*spec)))
    for sh in a.addressable_shards:
        (r, c), = np.argwhere(devs == sh.device)
        out[f"{{name}}/{{r}}/{{c}}"] = np.asarray(sh.data)
ws, x = _pp_inputs()
pmesh = jax.make_mesh((4,), ("pipe",))
out["pp"] = np.asarray(pipeline_apply(lambda w, h: jnp.tanh(h @ w),
                                      jnp.asarray(ws), jnp.asarray(x),
                                      mesh=pmesh))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_mesh(tmp_path_factory):
    """The JAX package's shards and GPipe output over 4 virtual devices."""
    path = str(tmp_path_factory.mktemp("jax_mesh") / "out.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        # at a lower priority: other tests' stage deadlines keep the CPU
        ["nice", "-n", "10", sys.executable, "-c",
         _JAX_MESH.format(tests=os.path.join(REPO, "tests")), path],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(path) as f:
        return dict(f)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_meshes_take_named_devices_repeats_included():
    mesh = t_mesh.make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    assert mesh.shape == {"data": 2, "model": 2}
    assert mesh.axis_names == ("data", "model")
    assert mesh.devices.dtype == object and mesh.devices.shape == (2, 2)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert t_mesh.dp_size(mesh) == 2 and t_mesh.tp_size(mesh) == 2
    host = t_mesh.make_host_mesh(model=2, devices=["cpu", "cpu:0"] * 2)
    assert host.shape == {"data": 2, "model": 2}
    assert host.axis_devices("data") == [torch.device("cpu")] * 2
    assert host.axis_devices("model") == [torch.device("cpu"),
                                          torch.device("cpu", 0)]
    pod = t_mesh.make_production_mesh(True, devices=["cpu"] * 512)
    assert pod.shape == {"pod": 2, "data": 16, "model": 16}
    assert t_mesh.dp_size(pod) == 32 and t_mesh.tp_size(pod) == 16
    assert t_mesh.make_production_mesh(devices=["cpu"] * 256).shape == {
        "data": 16, "model": 16}


def test_meshes_refuse_what_cannot_run():
    n_cards = torch.cuda.device_count()
    with pytest.raises(ConfigError, match=f"wants {n_cards + 1} device.*"
                                          f"only {n_cards} card"):
        t_mesh.make_mesh((n_cards + 1, 1), ("data", "model"))
    with pytest.raises(ConfigError, match="wants 256 device.*given 4"):
        t_mesh.make_production_mesh(devices=["cpu"] * 4)
    with pytest.raises(ConfigError, match="wants 512"):
        t_mesh.make_production_mesh(True, devices=["cpu"] * 256)
    with pytest.raises(ConfigError, match="3 device.*model axis of 2"):
        t_mesh.make_host_mesh(model=2, devices=["cpu"] * 3)
    with pytest.raises(ConfigError, match="mixes device types"):
        t_mesh.make_mesh((2,), ("data",), ["cpu", "meta"])
    mesh = t_mesh.make_mesh((2,), ("data",), ["cpu", "cpu"])
    with pytest.raises(ConfigError, match="not of the tensors' device type"):
        t_mesh.check_device_type(mesh, "meta")
    with pytest.raises(ConfigError, match="not of the tensors' device type"):
        t_shd.shard_tensor(torch.zeros(4, device="meta"), P("data"), mesh)
    with pytest.raises(NameError, match="unbound axis name: data"):
        t_mesh.bound_axis(None, "data")
    with pytest.raises(NameError, match="unbound axis name: pod"):
        t_mesh.bound_axis(mesh, "pod")


# ---------------------------------------------------------------------------
# partition rules
# ---------------------------------------------------------------------------

def _spec_leaves(tree, path=()):
    """(path, spec) of a spec tree, sorted keys (``jax.tree`` order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in
                _spec_leaves(tree[k], path + (k,))]
    return [("/".join(path), tuple(tree))]


def _jax_spec_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return [("/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                      for e in path), tuple(spec)) for path, spec in flat]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_partition_specs_match_jax_leaf_for_leaf(arch):
    jcfg = j_registry.reduced_config(j_get_config(arch))
    cfg = registry.reduced_config(get_config(arch))
    jshape = j_registry.params_specs(jcfg, JRunConfig())
    params = registry.init_params(cfg, RunConfig(),
                                  torch.Generator().manual_seed(0), "cpu")
    for kw in (dict(tp_size=1), dict(tp_size=16),
               dict(tp_size=16, fsdp_axis="data", fsdp_size=4),
               dict(tp_size=16, fsdp_axis="data", fsdp_size=4,
                    min_fsdp_elems=1024)):
        want = _jax_spec_leaves(j_shd.param_partition_specs(jshape, **kw))
        got = _spec_leaves(t_shd.param_partition_specs(params, **kw))
        assert got == want, (arch, kw)
    if cfg.family == "moe" and cfg.n_experts % 16:
        # granite's fallback: the per-expert ffn dim carries "model"
        specs = dict(_spec_leaves(t_shd.param_partition_specs(
            params, tp_size=16)))
        assert specs["layers/moe/w_in"] == (None, None, None, "model")
        assert specs["layers/moe/w_out"] == (None, None, "model", None)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_specs_match_jax(arch):
    jcfg = j_registry.reduced_config(j_get_config(arch))
    for batch, dp, tp in ((4, 2, 16), (1, 4, 2), (8, 4, 4)):
        shape = ShapeConfig("d", 32, batch, "decode")
        state = j_registry.decode_specs(jcfg, JRunConfig(), shape)["state"]
        leaves = jax.tree.leaves(state)
        for multi_pod in (False, True):
            kw = dict(batch=batch, dp_size=dp, seq_len=32, tp_size=tp)
            want = [tuple(s) for s in jax.tree.leaves(
                j_shd.decode_state_specs(state, multi_pod, **kw),
                is_leaf=lambda x: isinstance(x, JP))]
            got = [tuple(s) for s in t_shd.decode_state_specs(
                [torch.empty(leaf.shape, device="meta") for leaf in leaves],
                multi_pod, **kw)]
            assert got == want, (arch, batch, dp, multi_pod)


def test_batch_spec_and_the_normalized_one_name_tuple():
    for multi_pod in (False, True):
        assert tuple(t_shd.batch_spec(multi_pod)) == tuple(
            j_shd.batch_spec(multi_pod))
    assert P(("data",), None) == ("data", None)
    assert P(("pod", "data")) == (("pod", "data"),)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def test_shard_tensor_pieces_equal_jax_addressable_shards(jax_mesh):
    mesh = t_mesh.make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    for i, (name, shape, spec) in enumerate(PLACEMENTS):
        t = torch.from_numpy(_placement_input(i, shape))
        pieces = t_shd.shard_tensor(t, P(*spec), mesh)
        assert pieces.shape == (2, 2)
        for r in range(2):
            for c in range(2):
                np.testing.assert_array_equal(
                    pieces[r, c].numpy(), jax_mesh[f"{name}/{r}/{c}"])
                # one device repeated: every piece is a view of t
                assert pieces[r, c].untyped_storage().data_ptr() == \
                    t.untyped_storage().data_ptr()
        assert torch.equal(t_shd.unshard(pieces, P(*spec), mesh), t)


def test_shard_tensor_copies_once_to_another_device():
    mesh = t_mesh.make_mesh((2, 2), ("data", "model"),
                            ["cpu", "cpu:0", "cpu", "cpu:0"])
    t = torch.from_numpy(_placement_input(0, (8, 6)))
    pieces = t_shd.shard_tensor(t, P("data"), mesh)
    ptr = t.untyped_storage().data_ptr()
    for r in range(2):
        assert pieces[r, 0].untyped_storage().data_ptr() == ptr
        assert pieces[r, 1].untyped_storage().data_ptr() != ptr
        assert torch.equal(pieces[r, 0], pieces[r, 1])
    full = t_shd.shard_tensor(t, P(), mesh)
    assert full[0, 1] is full[1, 1]          # one copy a (device, piece)
    assert torch.equal(t_shd.unshard(pieces, P("data"), mesh), t)
    with pytest.raises(ValueError, match="does not divide"):
        t_shd.shard_tensor(torch.zeros(5, 6), P("data"), mesh)
    with pytest.raises(ValueError, match="used twice|not in the mesh"):
        t_shd.shard_tensor(t, P("data", "data"), mesh)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

_HLO = """
  %ar = f32[256,1024]{1,0} all-reduce(f32[256,1024]{1,0} %x), replica_groups={}
  %ag.1 = bf16[8,128] all-gather(bf16[4,128] %y), dimensions={0}
  %st = (f32[16], f32[16]) all-reduce-start(f32[16] %z)
  %dn = f32[16] all-reduce-done((f32[16], f32[16]) %st)
  %cp = u8[64]{0} collective-permute(u8[64]{0} %w), source_target_pairs={{0,1}}
"""


def test_collective_bytes_parser_on_synthetic_hlo():
    out = collectives.collective_bytes(_HLO)
    assert out["bytes"]["all-reduce"] == 256 * 1024 * 4 + 16 * 4 * 2
    assert out["bytes"]["all-gather"] == 8 * 128 * 2
    assert out["bytes"]["collective-permute"] == 64
    assert out["counts"]["all-reduce"] == 2  # start counted, done skipped
    from repro.parallel.collectives import collective_bytes as j_bytes
    assert out == j_bytes(_HLO)


@pytest.mark.parametrize("devices", [["cpu", "cpu"], ["cpu", "cpu:0"]],
                         ids=["repeated", "distinct"])
def test_collective_log_of_a_sequence_equals_the_hlo_accounting(devices):
    devs = [torch.device(d) for d in devices]
    rng = np.random.default_rng(3)
    log = collectives.LOG
    log.reset()
    a = [torch.from_numpy(rng.standard_normal((256, 1024)).astype(
        np.float32)) for _ in range(2)]
    summed = collectives.all_reduce(a, "sum", devs)
    torch.testing.assert_close(summed[0], a[0] + a[1], rtol=0, atol=0)
    assert (summed[0] is summed[1]) == (devs[0] == devs[1])
    pairs = [(torch.ones(16), torch.arange(16.0)) for _ in range(2)]
    mean = collectives.all_reduce(pairs, "mean", devs)
    assert isinstance(mean[0], tuple)
    assert torch.equal(mean[1][0], torch.ones(16))
    assert torch.equal(mean[1][1], torch.arange(16.0))
    g = [torch.full((4, 128), float(i), dtype=torch.bfloat16)
         for i in range(2)]
    gathered = collectives.all_gather(g, 0, devs)
    assert gathered[1].shape == (8, 128) and gathered[1][4:].eq(1).all()
    moved = collectives.permute([torch.arange(64, dtype=torch.uint8), None],
                                [(0, 1)], devs)
    assert moved[0] is None and torch.equal(moved[1],
                                            torch.arange(64,
                                                         dtype=torch.uint8))
    assert log.summary() == collectives.collective_bytes(_HLO)
    # one shard is no collective
    collectives.all_reduce([a[0]], "sum", devs[:1])
    assert log.summary() == collectives.collective_bytes(_HLO)
    log.reset()
    assert log.summary() == {"bytes": {}, "counts": {}, "total_bytes": 0}


def test_distributed_covariance_sums_the_shards_in_order():
    from repro.parallel.collectives import distributed_covariance as j_cov

    r = np.random.default_rng(4).standard_normal((96, 24)).astype(np.float32)
    parts = [torch.from_numpy(r[i * 32:(i + 1) * 32]) for i in range(3)]
    log = collectives.LOG
    log.reset()
    got = collectives.distributed_covariance(parts)
    want = parts[0].T @ parts[0] + parts[1].T @ parts[1] \
        + parts[2].T @ parts[2]
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_cov(jnp.asarray(r))),
                               rtol=1e-5, atol=1e-4)
    assert log.summary()["bytes"] == {"all-reduce": 24 * 24 * 4}


# ---------------------------------------------------------------------------
# GPipe
# ---------------------------------------------------------------------------

def _sequential(ws, x):
    ref = x
    for w in ws:
        ref = np.tanh(ref @ w)
    return ref


@pytest.mark.parametrize("devices", [["cpu"] * 4, ["cpu", "cpu:0"] * 2],
                         ids=["repeated", "distinct"])
def test_gpipe_matches_jax_and_the_sequential_loop(jax_mesh, devices):
    ws, x = _pp_inputs()
    mesh = t_mesh.make_mesh((PP_STAGES,), ("pipe",), devices)
    log = collectives.LOG
    log.reset()
    out = pipeline.pipeline_apply(lambda w, h: torch.tanh(h @ w),
                                  torch.from_numpy(ws), torch.from_numpy(x),
                                  mesh=mesh)
    assert out.shape == (PP_MICRO, PP_MB, PP_D)
    np.testing.assert_allclose(out.numpy(), jax_mesh["pp"], atol=1e-5)
    np.testing.assert_allclose(out.numpy(), _sequential(ws, x), atol=1e-5)
    # each microbatch crosses P - 1 stage boundaries; the bubble sends none
    summary = log.summary()
    assert summary["bytes"] == {"collective-permute": (PP_STAGES - 1)
                                * PP_MICRO * PP_MB * PP_D * 4}
    assert summary["counts"] == {"collective-permute":
                                 PP_MICRO + PP_STAGES - 2}
    assert pipeline.gpipe_bubble_fraction(PP_STAGES, PP_MICRO) == 3 / 11
    from repro.parallel.pipeline import gpipe_bubble_fraction as j_bubble
    assert j_bubble(PP_STAGES, PP_MICRO) == 3 / 11


def test_gpipe_splits_a_param_tree_per_stage_and_checks_it():
    ws, x = _pp_inputs()
    bs = np.random.default_rng(8).standard_normal((PP_STAGES, PP_D)).astype(
        np.float32)
    mesh = t_mesh.make_mesh((1, PP_STAGES), ("data", "pipe"), ["cpu"] * 4)
    params = {"w": torch.from_numpy(ws), "b": {"v": torch.from_numpy(bs)}}
    out = pipeline.pipeline_apply(
        lambda p, h: torch.tanh(h @ p["w"] + p["b"]["v"]), params,
        torch.from_numpy(x), mesh=mesh)
    ref = x
    for w, b in zip(ws, bs):
        ref = np.tanh(ref @ w + b)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    with pytest.raises(ValueError, match="stages"):
        pipeline.pipeline_apply(lambda w, h: h, torch.from_numpy(ws[:3]),
                                torch.from_numpy(x), mesh=mesh)
