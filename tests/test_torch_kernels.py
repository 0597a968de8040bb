"""The port's kernels against the JAX package's.

On the CPU each plain version (``*_plain``, what the wrapper runs for a CPU
tensor) is held against the JAX oracle ``ref.py`` and the Pallas kernel run
in interpret mode.  On a card (``-m cuda``) each CUDA kernel is held against
its plain version.

Tolerances: quantize is exact (elementwise, true division and half-to-even
rounding on both sides); block_attention 1e-5 (fp32 sums in another order);
gae_project 3e-5, as ``test_kernels.py`` uses, for the summation order at
D = 1521.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from repro.kernels.block_attention import ops as ba_ops
    from repro.kernels.block_attention import ref as ba_ref
    from repro.kernels.gae_project import ops as gp_ops
    from repro.kernels.gae_project import ref as gp_ref
    from repro.kernels.quantize import ops as qz_ops
    from repro.kernels.quantize import ref as qz_ref
except ImportError:      # the card's machine has no JAX: the cuda tests run there
    jnp = None

from repro_torch.kernels.block_attention import ops as t_ba
from repro_torch.kernels.gae_project import ops as t_gp
from repro_torch.kernels.quantize import ops as t_qz

QUANT_CASES = [((64, 128), 0.005), ((640, 16), 0.005), ((37, 80), 0.01),
               ((7,), 0.1), ((2, 4), 0.5)]
ATTN_CASES = [(4, 10, 128, 1), (5, 8, 128, 4), (3, 5, 32, 2)]
PROJ_CASES = [(37, 80, 80), (19, 256, 256), (9, 1521, 1521)]
# the kernel's tiling edges: row counts below one tile and ragged (1, 37,
# 129), a full S3D stripe, Dout != D on the resident path (80 -> 48), ragged
# widths on the tiled path (37 -> 100, D and Dout not multiples of 4), the
# tiled path at E3SM's and XGC's widths over several row tiles
PROJ_KERNEL_EDGES = [(1, 80, 80), (129, 80, 80), (37120, 80, 80),
                     (37, 80, 48), (101, 37, 100), (300, 256, 256),
                     (130, 1521, 1521)]


@pytest.fixture
def needs_jax():
    if jnp is None:
        pytest.skip("needs JAX, the reference package")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _quant_input(shape, bin_size, seed=0):
    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal(shape)).astype(np.float32)
    if bin_size == 0.5:            # exact half-way points: x / bin = k + 1/2
        x.flat[:] = np.array([0.25, 0.75, -0.25, 1.25, -1.75, 2.25, 0.0, 3.0],
                             np.float32)[:x.size]
    return x


def _attn_inputs(b, n, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n, d)).astype(np.float32) for _ in range(3)]


def _proj_inputs(n, d, dout, seed=0):
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((n, d)).astype(np.float32)
    u = (rng.standard_normal((d, dout)) / np.sqrt(d)).astype(np.float32)
    return r, u


# ---------------------------------------------------------------------------
# plain versions against the JAX oracle and the interpreted Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,bin_size", QUANT_CASES)
def test_quantize_plain_matches_jax(needs_jax, shape, bin_size):
    x = _quant_input(shape, bin_size)
    got = [t.numpy() for t in t_qz.quantize_fused(torch.from_numpy(x), bin_size)]
    assert got[0].dtype == np.int32
    for g, w in zip(got, qz_ref.quantize_fused_ref(jnp.asarray(x), bin_size)):
        np.testing.assert_array_equal(g, np.asarray(w))
    q, deq, err2 = (np.asarray(a) for a in
                    qz_ops.quantize_fused(jnp.asarray(x), bin_size))
    # The jitted Pallas interpreter on XLA's CPU backend divides by the
    # compile-time constant bin as a multiply by its reciprocal, which can
    # round a quotient within an ulp of a half-way point into the other bin
    # (ref.py and the port divide), and it contracts x - q*bin into one FMA,
    # so its err2 skips the rounding of deq.
    quot = x.astype(np.float64) / np.float64(np.float32(bin_size))
    near_half = np.abs(quot - np.floor(quot) - 0.5) <= 1e-6 * np.maximum(
        1.0, np.abs(quot))
    same = got[0] == q
    assert np.all(same | near_half)
    np.testing.assert_array_equal(got[1][same], deq[same])
    bound = 2 * np.sqrt(err2) * np.spacing(np.abs(deq)) + 4 * np.spacing(err2)
    assert np.all((np.abs(got[2] - err2) <= bound)[same])


@pytest.mark.parametrize("b,n,d,heads", ATTN_CASES)
def test_block_attention_plain_matches_jax(needs_jax, b, n, d, heads):
    q, k, v = _attn_inputs(b, n, d)
    got = t_ba.block_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               heads).numpy()
    args = [jnp.asarray(a) for a in (q, k, v)]
    for want in (ba_ref.block_attention_ref(*args, heads=heads),
                 ba_ops.block_attention(*args, heads=heads)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n,d,dout", PROJ_CASES)
def test_gae_project_plain_matches_jax(needs_jax, n, d, dout):
    r, u = _proj_inputs(n, d, dout)
    c, c2 = t_gp.gae_project(torch.from_numpy(r), torch.from_numpy(u))
    for want_c, want_c2 in (gp_ref.gae_project_ref(jnp.asarray(r), jnp.asarray(u)),
                            gp_ops.gae_project(jnp.asarray(r), jnp.asarray(u))):
        np.testing.assert_allclose(c.numpy(), np.asarray(want_c),
                                   atol=3e-5, rtol=3e-5)
        np.testing.assert_allclose(c2.numpy(), np.asarray(want_c2),
                                   atol=3e-5, rtol=3e-5)


def test_cpu_wrappers_do_not_count_launches():
    before = (t_qz.launches.value, t_ba.launches.value, t_gp.launches.value)
    x = torch.ones(4, 8)
    t_qz.quantize_fused(x, 0.1)
    t_ba.block_attention(x[None], x[None], x[None])
    t_gp.gae_project(x, torch.eye(8))
    assert (t_qz.launches.value, t_ba.launches.value,
            t_gp.launches.value) == before


def test_launch_counter_loses_no_update_across_threads():
    import sys
    import threading

    from repro_torch.kernels.build import LaunchCounter

    counter, n_threads, per_thread = LaunchCounter(), 32, 2000

    def work():
        for _ in range(per_thread):
            counter.add()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert counter.value == n_threads * per_thread
    counter.reset()
    assert counter.value == 0


# ---------------------------------------------------------------------------
# CUDA kernels against their plain versions (on the card only)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape,bin_size", QUANT_CASES)
def test_quantize_kernel_matches_plain(cuda_device, shape, bin_size):
    x = torch.from_numpy(_quant_input(shape, bin_size)).to(cuda_device)
    got = t_qz.quantize_fused(x, bin_size)
    want = t_qz.quantize_fused_plain(x, bin_size)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,heads", ATTN_CASES)
def test_block_attention_kernel_matches_plain(cuda_device, b, n, d, heads):
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _attn_inputs(b, n, d))
    torch.testing.assert_close(t_ba.block_attention(q, k, v, heads),
                               t_ba.block_attention_plain(q, k, v, heads),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,dout", PROJ_CASES + PROJ_KERNEL_EDGES)
def test_gae_project_kernel_matches_plain(cuda_device, n, d, dout):
    r, u = (torch.from_numpy(a).to(cuda_device) for a in _proj_inputs(n, d, dout))
    for g, w in zip(t_gp.gae_project(r, u), t_gp.gae_project_plain(r, u)):
        torch.testing.assert_close(g, w, atol=3e-5, rtol=3e-5)
