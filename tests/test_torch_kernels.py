"""The port's kernels against the JAX package's.

On the CPU each plain version (``*_plain``, what the wrapper runs for a CPU
tensor) is held against the JAX oracle ``ref.py`` and the Pallas kernel run
in interpret mode.  On a card (``-m cuda``) each CUDA kernel is held against
its plain version.

Tolerances: quantize is exact (elementwise, true division and half-to-even
rounding on both sides); block_attention 1e-5 in fp32 (sums in another
order); in bf16 5e-2 against the bf16 plain version and the JAX package's
bf16 (``test_kernels.py``'s ``_tol``: the plain version rounds its products
to bf16, the kernel computes in fp32), and 8e-3, one bf16 ulp, against the
fp32 plain version on the same bf16 inputs with its output rounded to bf16;
gae_project 3e-5, as ``test_kernels.py`` uses, for the summation order at
D = 1521.
"""
from __future__ import annotations

import math

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
# the JAX kernel sweep (test_kernels.py) and the main path's shapes: S3D's
# stripe and fit_basis's pass over the field, E3SM's and XGC's stripes
ATTN_SWEEP = [(37, 10, 128, 1), (256, 8, 64, 4), (5, 5, 32, 2), (1, 2, 16, 1),
              (300, 16, 128, 8)]
ATTN_PATH = [(64, 10, 128, 1), (1600, 10, 128, 1), (64, 5, 128, 1),
             (64, 8, 128, 1)]
# shapes only the general kernel takes: d / VEC not a power of two or above
# 32, d / heads below VEC, more key rows a lane than the warp kernel holds
ATTN_GENERAL = [(3, 10, 96, 1), (3, 10, 256, 1), (3, 10, 128, 64),
                (3, 17, 128, 1)]
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


def _quantize_fp32_formula(x: torch.Tensor, bin_size):
    """The TPU kernel's arithmetic, in numpy: x read as fp32, q = rint of the
    fp32 quotient, deq = q * bin in fp32 (stored in x's dtype), err2 from
    the fp32 deq."""
    x32 = x.float().numpy()
    b = np.float32(bin_size)
    q = np.rint(x32 / b)
    deq = q.astype(np.float32) * b
    return (q.astype(np.int32), torch.from_numpy(deq).to(x.dtype),
            np.square(x32 - deq))


def test_quantize_plain_bf16_follows_fp32_formula():
    x = torch.from_numpy(_quant_input((64, 128), 0.005)).to(torch.bfloat16)
    q, deq, err2 = t_qz.quantize_fused_plain(x, 0.005)
    assert (q.dtype, deq.dtype, err2.dtype) == (torch.int32, torch.bfloat16,
                                                torch.float32)
    want_q, want_deq, want_err2 = _quantize_fp32_formula(x, 0.005)
    np.testing.assert_array_equal(q.numpy(), want_q)
    assert torch.equal(deq, want_deq)
    np.testing.assert_array_equal(err2.numpy(), want_err2)


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


@pytest.mark.parametrize("lead,n,d", [((4, 9), 10, 64), ((64,), 10, 128)])
def test_block_attention_plain_bf16_matches_jax(needs_jax, lead, n, d):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((*lead, n, d)).astype(np.float32)
               for _ in range(3))
    got = t_ba.block_attention(*(torch.from_numpy(a).to(torch.bfloat16)
                                 for a in (q, k, v)))
    assert got.dtype == torch.bfloat16 and got.shape == (*lead, n, d)
    args = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    ref = ba_ref.block_attention_ref(*(a.reshape(-1, n, d) for a in args))
    for want in (ref.reshape(*lead, n, d), ba_ops.block_attention(*args)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,d,heads", ATTN_CASES + ATTN_SWEEP + ATTN_PATH)
def test_block_attention_sweep_and_paths_take_warp_kernel(b, n, d, heads,
                                                          dtype):
    plan = t_ba.launch_plan(b, n, d, d, heads, dtype)
    assert plan.path == "warp"
    assert (dtype.itemsize, plan.kpl) in t_ba.WARP_TILES
    assert plan.qpw <= t_ba.WARP_TILES[dtype.itemsize, plan.kpl]
    assert plan.qpw * plan.wph >= n > plan.qpw * (plan.wph - 1)
    if b >= t_ba.WARPS_PER_SM * 132:        # K and V read by one warp
        assert plan.wph == 1
    if (b, n, d) == (64, 10, 128):          # the stripe covers the 132 SMs
        assert b * plan.wph >= 2 * 132


@pytest.mark.parametrize("b,n,dk,dv,heads,dtype,aligned", [
    (3, 10, 96, 96, 1, torch.float32, True),        # d / VEC = 24
    (3, 10, 256, 256, 1, torch.float32, True),      # d / VEC = 64 > 32
    (3, 10, 12, 12, 1, torch.float32, True),        # d / VEC = 3
    (3, 10, 128, 128, 64, torch.float32, True),     # d / heads = 2 < VEC
    (3, 17, 128, 128, 1, torch.float32, True),      # 17 key rows a lane
    (3, 10, 128, 64, 1, torch.float32, True),       # dk != dv
    (3, 10, 128, 128, 1, torch.float32, False),     # misaligned
    (3, 10, 96, 96, 1, torch.bfloat16, True),       # d / VEC = 12
    (3, 10, 128, 128, 32, torch.bfloat16, True),    # d / heads = 4 < VEC
    (3, 10, 256, 256, 1, torch.bfloat16, True),     # 10 key rows a lane
    (3, 9, 64, 64, 1, torch.bfloat16, False),       # misaligned
])
def test_block_attention_general_kernel_takes_only_listed_shapes(
        b, n, dk, dv, heads, dtype, aligned):
    assert t_ba.launch_plan(b, n, dk, dv, heads, dtype,
                            aligned).path == "general"


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
def test_quantize_kernel_bf16_matches_fp32_formula(cuda_device):
    x = torch.from_numpy(_quant_input((64, 128), 0.005)).to(torch.bfloat16)
    q, deq, err2 = t_qz.quantize_fused(x.to(cuda_device), 0.005)
    want_q, want_deq, want_err2 = _quantize_fp32_formula(x, 0.005)
    np.testing.assert_array_equal(q.cpu().numpy(), want_q)
    assert deq.dtype == torch.bfloat16 and torch.equal(deq.cpu(), want_deq)
    np.testing.assert_array_equal(err2.cpu().numpy(), want_err2)
    for g, w in zip((q, deq, err2), t_qz.quantize_fused_plain(
            x.to(cuda_device), 0.005)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,heads",
                         ATTN_CASES + ATTN_SWEEP + ATTN_PATH + ATTN_GENERAL)
def test_block_attention_kernel_matches_plain(cuda_device, b, n, d, heads):
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _attn_inputs(b, n, d))
    torch.testing.assert_close(t_ba.block_attention(q, k, v, heads),
                               t_ba.block_attention_plain(q, k, v, heads),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("lead,n,d,path", [((4, 9), 10, 64, "warp"),
                                           ((64,), 10, 128, "warp"),
                                           ((4, 9), 10, 96, "general")])
def test_block_attention_kernel_bf16(cuda_device, lead, n, d, path):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((*lead, n, d)).astype(
        np.float32)).to(cuda_device, torch.bfloat16) for _ in range(3))
    assert t_ba.launch_plan(math.prod(lead), n, d, d, 1,
                            torch.bfloat16).path == path
    got = t_ba.block_attention(q, k, v)
    assert got.dtype == torch.bfloat16 and got.shape == (*lead, n, d)
    torch.testing.assert_close(got.float(),
                               t_ba.block_attention_plain(q, k, v).float(),
                               atol=5e-2, rtol=5e-2)
    # the kernel's fp32 arithmetic: the fp32 plain version on the same
    # bf16-rounded inputs, rounded to bf16, is at most one bf16 ulp away
    want = t_ba.block_attention_plain(q.float(), k.float(), v.float())
    torch.testing.assert_close(got.float(), want.to(torch.bfloat16).float(),
                               atol=8e-3, rtol=8e-3)


@pytest.mark.cuda
def test_block_attention_kernel_misaligned_inputs(cuda_device):
    b, n, d = 5, 10, 128
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _attn_inputs(b, n, d))
    # the same values at an address 4 bytes past a 16-byte boundary
    q1 = torch.empty(q.numel() + 1, device=cuda_device)[1:].view(b, n, d)
    q1.copy_(q)
    assert q1.is_contiguous() and q1.data_ptr() % 16
    torch.testing.assert_close(t_ba.block_attention(q1, k, v),
                               t_ba.block_attention_plain(q, k, v),
                               atol=1e-5, rtol=1e-5)


def _misaligned(x):
    """The same values, contiguous, at an address 4 bytes past a 16-byte
    boundary."""
    out = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    out = out.view(x.shape).copy_(x)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out


@pytest.mark.cuda
def test_wrappers_take_views_and_misaligned_inputs(cuda_device):
    """As the TPU wrappers, quantize, block_attention and gae_project take a
    non-contiguous view (copied) and a contiguous input off a 16-byte
    boundary, with the plain version's answer on the same values: quantize
    bit for bit, the other two at their tolerances above."""
    x = torch.from_numpy(_quant_input((64, 256), 0.005)).to(cuda_device)
    view = x.t()
    for xin in (view, _misaligned(x)):
        before = t_qz.launches.value
        for g, w in zip(t_qz.quantize_fused(xin, 0.005),
                        t_qz.quantize_fused_plain(xin, 0.005)):
            assert torch.equal(g, w)
        assert t_qz.launches.value == before + 1
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in _attn_inputs(8, 10, 256))
    qv, kv, vv = (t[..., ::2] for t in (q, k, v))      # (8, 10, 128) views
    assert not qv.is_contiguous()
    torch.testing.assert_close(t_ba.block_attention(qv, kv, vv),
                               t_ba.block_attention_plain(qv, kv, vv),
                               atol=1e-5, rtol=1e-5)
    r, u = (torch.from_numpy(a).to(cuda_device)
            for a in _proj_inputs(300, 256, 256))
    for rin, uin in ((r.t().contiguous().t(), u.t().contiguous().t()),
                     (_misaligned(r), _misaligned(u))):
        for g, w in zip(t_gp.gae_project(rin, uin),
                        t_gp.gae_project_plain(rin, uin)):
            torch.testing.assert_close(g, w, atol=3e-5, rtol=3e-5)


@pytest.mark.cuda
def test_gae_project_kernel_takes_bf16(cuda_device):
    """As the TPU kernel, which casts its tiles to fp32 in its body: bf16
    residuals and basis give the fp32 call's outputs on the upcast values,
    in fp32."""
    r, u = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
            for a in _proj_inputs(4096, 256, 256))
    got = t_gp.gae_project(r, u)
    want = t_gp.gae_project(r.float(), u.float())
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)
    for g, w in zip(got, t_gp.gae_project_plain(r, u)):
        torch.testing.assert_close(g, w, atol=3e-5, rtol=3e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,dout", PROJ_CASES + PROJ_KERNEL_EDGES)
def test_gae_project_kernel_matches_plain(cuda_device, n, d, dout):
    r, u = (torch.from_numpy(a).to(cuda_device) for a in _proj_inputs(n, d, dout))
    for g, w in zip(t_gp.gae_project(r, u), t_gp.gae_project_plain(r, u)):
        torch.testing.assert_close(g, w, atol=3e-5, rtol=3e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [64, 1600])
def test_block_attention_kernel_gradients_match_plain(cuda_device, b):
    """The autograd Function around the kernel against autograd through the
    plain version, at the S3D stripe and fit_basis's pass, at 1e-5 of the
    largest gradient."""
    q, k, v, w = (torch.from_numpy(a).to(cuda_device)
                  for a in _attn_inputs(b, 10, 128) + _attn_inputs(b, 10, 128,
                                                                    seed=1)[:1])
    grads = {}
    for name, fn in (("kernel", t_ba.block_attention),
                     ("plain", t_ba.block_attention_plain)):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        before = t_ba.launches.value
        grads[name] = torch.autograd.grad(torch.sum(fn(*ins, 1) * w), ins)
        assert t_ba.launches.value - before == (name == "kernel")
    scale = max(g.abs().max().item() for g in grads["plain"])
    for g, h in zip(grads["kernel"], grads["plain"]):
        torch.testing.assert_close(g, h, rtol=0, atol=1e-5 * scale)
