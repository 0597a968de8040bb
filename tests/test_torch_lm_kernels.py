"""The port's LM kernels against the JAX package's.

On the CPU each plain version (what the wrapper runs for a CPU tensor) is
held against the JAX oracles and the Pallas kernel run in interpret mode, as
``tests/test_kernels.py`` runs it.  On a card (``-m cuda``) each CUDA kernel
is held against its plain version.

Tolerances, as ``test_kernels.py`` states them: flash attention 3e-5 in fp32
(sums in another order) and 5e-2 in bf16 (scores and weights rounded to bf16
in one version, kept in fp32 in the other); the SSD scan 3e-4 (exp of
cumulative sums over a chunk, summed in another order).  The bf16 CUDA
kernel runs on the tensor cores: fp32 scores and softmax, p split into two
bf16 parts (hi + lo, about 2^-17 of p; one bf16 p, as FlashAttention rounds
it, is off by up to 2^-9 |v| in a row with few live keys), fp32
accumulation, one rounding of the output.  It is held to the fp32 plain
version on the same inputs, rounded to bf16, at atol 1e-3 / rtol 1e-2: the
output's own rounding is at most 2^-8 relative.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.kernels.flash_attention import ops as fa_ops
    from repro.kernels.flash_attention import ref as fa_ref
    from repro.kernels.ssd_scan import ops as ssd_ops
    from repro.kernels.ssd_scan import ref as ssd_ref
    from repro.models import ssd as j_ssd
except ImportError:      # the card's machine has no JAX: the cuda tests run there
    jnp = None

from repro_torch.kernels.flash_attention import ops as t_fa
from repro_torch.kernels.ssd_scan import ops as t_ssd

FA_TOL = dict(atol=3e-5, rtol=3e-5)
FA_BF16_TOL = dict(atol=5e-2, rtol=5e-2)
# one bf16 rounding apart: bf16 keeps 8 significant bits, a relative step of
# at most 2^-7 = 0.0078
FA_BF16_KERNEL_TOL = dict(atol=1e-3, rtol=1e-2)
SSD_TOL = dict(atol=3e-4, rtol=3e-4)

# test_kernels.py's flash sweep: (b, s, t, h, kv, hd) x (causal, window),
# with recurrentgemma-9b's heads (16 query heads on one kv head of 256) and
# a head size the kernel is not built for (96, zero-padded to 128)
FA_SHAPES = [(2, 256, 256, 4, 2, 64), (1, 200, 200, 8, 1, 32),
             (2, 128, 128, 4, 4, 128), (1, 64, 192, 2, 2, 16),
             (1, 96, 96, 6, 3, 48), (1, 128, 128, 16, 1, 256),
             (1, 80, 80, 4, 2, 96)]
FA_MASKS = [(True, 0), (False, 0), (True, 64)]
# test_kernels.py's SSD sweep (b, s, h, p, g, n, chunk), with ragged S and G = 2
SSD_CASES = [(2, 64, 4, 16, 1, 8, 16), (1, 100, 2, 8, 2, 4, 32),
             (1, 128, 8, 32, 1, 16, 64), (3, 32, 2, 64, 2, 128, 16),
             (1, 300, 4, 64, 2, 128, 256)]
# the chunk-parallel kernel's edges: one chunk (S <= chunk), many chunks
# (S 2048, chunk 64), B 2 with G 2, P 48 and N 6 (neither a multiple of a
# tile), P over one tile of 64 with N 64, a chunk that is not a multiple of
# the 64-row tile
SSD_EDGE_CASES = [(1, 200, 4, 64, 1, 128, 256), (1, 2048, 4, 64, 1, 128, 64),
                  (2, 256, 4, 64, 2, 128, 64), (1, 300, 4, 48, 2, 6, 64),
                  (1, 130, 2, 80, 1, 64, 64), (1, 250, 2, 16, 1, 16, 100)]
# state sizes above one tile of 128 (the kernel cuts N in tiles of 128):
# N 256 (two tiles, G 2, chunk 256) and N 200 (a ragged second tile)
SSD_WIDE_N = [(1, 300, 4, 64, 2, 256, 256), (1, 200, 2, 32, 1, 200, 64)]


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


def _fa_inputs(b, s, t, h, kv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, hd)).astype(np.float32),
            rng.standard_normal((b, t, kv, hd)).astype(np.float32),
            rng.standard_normal((b, t, kv, hd)).astype(np.float32))


def _ssd_inputs(b, s, h, p, g, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a_log = rng.uniform(0.0, 1.0, (h,)).astype(np.float32)
    bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    return x, dt, a_log, bm, cm


def _pad_s(arrays, pad):
    """dt = 0 padding of the sequence axis (axis 1), as the JAX wrapper does;
    ``a_log`` (1-D) is left as it is."""
    return [a if a.ndim == 1 else
            np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
            for a in arrays]


# ---------------------------------------------------------------------------
# plain versions against the JAX oracles and the interpreted Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window", FA_MASKS)
@pytest.mark.parametrize("b,s,t,h,kv,hd", FA_SHAPES)
def test_flash_plain_matches_jax(needs_jax, b, s, t, h, kv, hd, causal, window):
    q, k, v = _fa_inputs(b, s, t, h, kv, hd)
    got = t_fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=causal, window=window).numpy()
    args = [jnp.asarray(a) for a in (q, k, v)]
    for want in (fa_ref.flash_attention_ref(*args, causal=causal, window=window),
                 fa_ops.flash_attention(*args, causal=causal, window=window)):
        np.testing.assert_allclose(got, np.asarray(want), **FA_TOL)


@pytest.mark.parametrize("causal,window", FA_MASKS)
@pytest.mark.parametrize("b,s,t,h,kv,hd", FA_SHAPES)
def test_flash_plain_matches_jax_bf16(needs_jax, b, s, t, h, kv, hd, causal,
                                      window):
    q, k, v = _fa_inputs(b, s, t, h, kv, hd, seed=1)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = t_fa.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    args = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    for want in (fa_ref.flash_attention_ref(*args, causal=causal,
                                            window=window),
                 fa_ops.flash_attention(*args, causal=causal, window=window)):
        np.testing.assert_allclose(got.to(torch.float32).numpy(),
                                   np.asarray(want, np.float32), **FA_BF16_TOL)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk",
                         SSD_CASES + SSD_EDGE_CASES + SSD_WIDE_N)
def test_ssd_plain_matches_jax(needs_jax, b, s, h, p, g, n, chunk):
    ins = _ssd_inputs(b, s, h, p, g, n)
    y, st = (a.numpy() for a in t_ssd.ssd(*(torch.from_numpy(a) for a in ins),
                                          chunk=chunk))
    jins = [jnp.asarray(a) for a in ins]
    q = min(chunk, s)
    x, dt, a_log, bm, cm = _pad_s(ins, -s % q)
    ye, ste = jax.jit(ssd_ref.ssd_scan_ref, static_argnums=5)(
        *(jnp.asarray(a) for a in (x, dt, a_log, bm, cm)), q)
    for want_y, want_st in ((np.asarray(ye)[:, :s], ste),
                            jax.jit(j_ssd.ssd_ref,
                                    static_argnames="chunk")(*jins, chunk=chunk),
                            ssd_ops.ssd(*jins, chunk=chunk)):
        np.testing.assert_allclose(y, np.asarray(want_y), **SSD_TOL)
        np.testing.assert_allclose(st, np.asarray(want_st), **SSD_TOL)


def test_ssd_plain_ragged_tail_is_a_noop():
    """A ragged S leaves the final state of the dt = 0 padded call."""
    ins = _ssd_inputs(1, 40, 2, 8, 1, 4, seed=2)
    y, st = t_ssd.ssd(*(torch.from_numpy(a) for a in ins), chunk=16)
    y2, st2 = t_ssd.ssd(*(torch.from_numpy(a) for a in _pad_s(ins, 8)),
                        chunk=16)
    assert torch.equal(st, st2)
    assert torch.equal(y, y2[:, :40])


def test_cpu_wrappers_do_not_count_launches():
    before = (t_fa.launches.value, t_ssd.launches.value)
    q, k, v = (torch.from_numpy(a) for a in _fa_inputs(1, 8, 8, 2, 1, 16))
    t_fa.flash_attention(q, k, v)
    t_ssd.ssd(*(torch.from_numpy(a) for a in _ssd_inputs(1, 8, 2, 8, 1, 4)),
              chunk=4)
    assert (t_fa.launches.value, t_ssd.launches.value) == before


# ---------------------------------------------------------------------------
# CUDA kernels against their plain versions (on the card only)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", FA_MASKS)
@pytest.mark.parametrize("b,s,t,h,kv,hd", FA_SHAPES)
def test_flash_kernel_matches_plain(cuda_device, b, s, t, h, kv, hd, causal,
                                    window):
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in _fa_inputs(b, s, t, h, kv, hd))
    torch.testing.assert_close(
        t_fa.flash_attention(q, k, v, causal=causal, window=window),
        t_fa.flash_attention_plain(q, k, v, causal=causal, window=window),
        **FA_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", FA_MASKS)
@pytest.mark.parametrize("b,s,t,h,kv,hd",
                         FA_SHAPES + [(1, 300, 300, 12, 2, 128),
                                      (1, 300, 300, 16, 1, 256)])
def test_flash_kernel_matches_plain_bf16(cuda_device, b, s, t, h, kv, hd,
                                         causal, window):
    """The tensor-core path (every head size takes it): held to the fp32
    plain version on the same bf16 inputs, rounded to bf16."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in _fa_inputs(b, s, t, h, kv, hd, seed=1))
    got = t_fa.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    want = t_fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                      causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.to(torch.bfloat16).float(),
                               **FA_BF16_KERNEL_TOL)


# whisper-medium's attention: the encoder's non-causal T = S = 1500 (a
# ragged last key tile: 92 keys at a tile of 128, 28 at 64) and the cross
# layers' 448 queries on the 1500 frames; 16 heads on 16 kv heads of 64
WHISPER_SHAPES = [(1, 1500, 1500, 16, 16, 64), (2, 448, 1500, 16, 16, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,kv,hd", WHISPER_SHAPES)
def test_flash_kernel_matches_plain_at_whisper_shapes(cuda_device, b, s, t, h,
                                                      kv, hd, dtype):
    """Non-causal, group 1, hd 64: fp32 at ``FA_TOL``, bf16 against the
    fp32 plain version on the same bf16 inputs, rounded to bf16, at
    ``FA_BF16_KERNEL_TOL``."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _fa_inputs(b, s, t, h, kv, hd, seed=2))
    got = t_fa.flash_attention(q, k, v, causal=False)
    want = t_fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                      causal=False).to(dtype)
    tol = FA_TOL if dtype == torch.float32 else FA_BF16_KERNEL_TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_zeroes_rows_no_key_reaches(cuda_device, dtype):
    """Causal with S > T: the first S - T query rows see no key.  The kernel
    gives them zeros, as the TPU kernel does; the other rows match (bf16 at
    the bf16 kernel tolerance, against the fp32 plain version)."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _fa_inputs(1, 96, 64, 4, 2, 32))
    got = t_fa.flash_attention(q, k, v, causal=True)
    assert torch.equal(got[:, :32], torch.zeros_like(got[:, :32]))
    want = t_fa.flash_attention_plain(q.float(), k.float(), v.float())
    torch.testing.assert_close(
        got[:, 32:].float(), want[:, 32:].to(dtype).float(),
        **(FA_TOL if dtype == torch.float32 else FA_BF16_KERNEL_TOL))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_copies_misaligned_inputs(cuda_device, dtype):
    """TMA and cp.async read 16-byte aligned rows: a contiguous view that
    starts off such a boundary is copied, and gives the kernel's answer on
    the aligned inputs bit for bit."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _fa_inputs(1, 64, 64, 2, 1, 16))
    flat = torch.empty(q.numel() + 1, dtype=dtype, device=cuda_device)
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.data_ptr() % 16
    torch.testing.assert_close(t_fa.flash_attention(shifted, k, v),
                               t_fa.flash_attention(q, k, v), atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_takes_non_contiguous_inputs(cuda_device, dtype):
    """q, k, v as head-major tensors transposed to (B, S, H, hd), strided
    views: copied, then the kernel's answer on contiguous copies."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype).transpose(1, 2)
               .contiguous().transpose(1, 2)
               for a in _fa_inputs(1, 96, 96, 4, 2, 256, seed=2))
    assert not q.is_contiguous()
    got = t_fa.flash_attention(q, k, v, window=32)
    want = t_fa.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), window=32)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.cuda
def test_flash_kernel_refuses_head_dim_above_256(cuda_device):
    """wgmma's N and a block's shared memory end at 256 head columns."""
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in _fa_inputs(1, 16, 16, 2, 1, 320))
    before = t_fa.launches.value
    with pytest.raises(ValueError, match="head_dim 320"):
        t_fa.flash_attention(q, k, v)
    assert t_fa.launches.value == before


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,g,n,chunk",
                         SSD_CASES + SSD_EDGE_CASES + SSD_WIDE_N)
def test_ssd_kernel_matches_plain(cuda_device, b, s, h, p, g, n, chunk):
    ins = [torch.from_numpy(a).to(cuda_device)
           for a in _ssd_inputs(b, s, h, p, g, n)]
    for got, want in zip(t_ssd.ssd(*ins, chunk=chunk),
                         t_ssd.ssd_plain(*ins, chunk=chunk)):
        # 3e-4 of the output's scale: at chunk 256 cum reaches about -500,
        # and exp of differences of such fp32 sums carries ~1e-5 relative
        # error that depends on the order the cumsum was taken in
        scale = max(1.0, want.abs().max().item())
        torch.testing.assert_close(got, want, atol=3e-4 * scale, rtol=3e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,g,n,chunk",
                         SSD_CASES + SSD_EDGE_CASES + SSD_WIDE_N)
def test_ssd_kernel_phases_match_plain_phases(cuda_device, b, s, h, p, g, n,
                                              chunk):
    """Each CUDA kernel of the op against its plain phase, fed the kernel's
    own upstream outputs, so that a mismatch names the phase."""
    ins = [torch.from_numpy(a).to(cuda_device)
           for a in _ssd_inputs(b, s, h, p, g, n)]
    for name, got, want in t_ssd.phase_pairs(*ins, chunk=chunk):
        scale = max(1.0, want.abs().max().item())
        torch.testing.assert_close(got, want, atol=3e-4 * scale, rtol=3e-4,
                                   msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.cuda
def test_ssd_kernel_takes_bf16_inputs(cuda_device):
    """As the TPU kernel: bf16 x, b, c are read as fp32, y comes back in bf16
    and the state in fp32; both equal the fp32 call on the upcast inputs
    (y rounded to bf16)."""
    x, dt, a_log, bm, cm = (torch.from_numpy(a).to(cuda_device) for a in
                            _ssd_inputs(1, 300, 4, 64, 2, 128, seed=5))
    x, bm, cm = (t.to(torch.bfloat16) for t in (x, bm, cm))
    y, st = t_ssd.ssd(x, dt, a_log, bm, cm, chunk=64)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    y32, st32 = t_ssd.ssd(x.float(), dt, a_log, bm.float(), cm.float(),
                          chunk=64)
    assert torch.equal(y, y32.to(torch.bfloat16))
    assert torch.equal(st, st32)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 256])
def test_ssd_kernel_takes_views_and_misaligned_inputs(cuda_device, n):
    """Non-contiguous x, b, c (slices of wider tensors) and a contiguous x
    that starts off a 16-byte boundary: copied or read as they are, with
    the answer of the plain version on the same values."""
    x, dt, a_log, bm, cm = (torch.from_numpy(a).to(cuda_device) for a in
                            _ssd_inputs(1, 300, 4, 64, 2, n, seed=6))
    wide = torch.stack([x, x], dim=-1)[..., 0]          # a strided view
    bw, cw = (torch.cat([m, m], dim=2)[:, :, :2] for m in (bm, cm))
    assert not (wide.is_contiguous() or bw.is_contiguous())
    assert torch.equal(wide, x) and torch.equal(bw, bm)
    odd = torch.empty(x.numel() + 1, device=cuda_device)[1:].view(x.shape)
    odd.copy_(x)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    want = t_ssd.ssd_plain(x, dt, a_log, bm, cm, chunk=256)
    for xin, bin_, cin in ((wide, bw, cw), (odd, bm, cm)):
        before = t_ssd.launches.value
        got = t_ssd.ssd(xin, dt, a_log, bin_, cin, chunk=256)
        assert t_ssd.launches.value == before + 1
        for g, w in zip(got, want):
            scale = max(1.0, w.abs().max().item())
            torch.testing.assert_close(g, w, atol=3e-4 * scale, rtol=3e-4)


@pytest.mark.cuda
def test_ssd_kernel_ragged_state_bit_identical_to_padded(cuda_device):
    ins = _ssd_inputs(1, 1000, 4, 64, 1, 128, seed=3)
    y, st = t_ssd.ssd(*(torch.from_numpy(a).to(cuda_device) for a in ins),
                      chunk=256)
    y2, st2 = t_ssd.ssd(*(torch.from_numpy(a).to(cuda_device)
                          for a in _pad_s(ins, 24)), chunk=256)
    assert torch.equal(st, st2)
    assert torch.equal(y, y2[:, :1000])


def _grads_through(fn, ins, ws):
    """Gradients of sum(out * w) over fn's outputs, for fresh leaves."""
    leaves = [t.clone().requires_grad_() for t in ins]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(sum(torch.sum(o * w) for o, w in zip(outs, ws)),
                               leaves)


def _assert_grads_close(got, want):
    """At 1e-5 of the largest gradient."""
    scale = max(g.abs().max().item() for g in want)
    for g, h in zip(got, want):
        torch.testing.assert_close(g, h, rtol=0, atol=1e-5 * scale)


@pytest.mark.cuda
def test_flash_kernel_gradients_match_plain(cuda_device):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 128, 4, 64, generator=g).to(cuda_device)
    k, v = (torch.randn(1, 128, 2, 64, generator=g).to(cuda_device)
            for _ in range(2))
    w = torch.randn(q.shape, generator=g).to(cuda_device)
    before = t_fa.launches.value
    got = _grads_through(lambda *a: t_fa.flash_attention(*a, window=32),
                         (q, k, v), (w,))
    assert t_fa.launches.value == before + 1
    _assert_grads_close(got, _grads_through(
        lambda *a: t_fa.flash_attention_plain(*a, window=32), (q, k, v),
        (w,)))


@pytest.mark.cuda
def test_ssd_kernel_gradients_match_plain(cuda_device):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 100, 2, 16, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(1, 100, 2, generator=g))
    a_log = torch.rand(2, generator=g)
    b, c = (torch.randn(1, 100, 1, 8, generator=g) for _ in range(2))
    ins = [t.to(cuda_device) for t in (x, dt, a_log, b, c)]
    ws = (torch.randn(1, 100, 2, 16, generator=g).to(cuda_device),
          torch.randn(1, 2, 16, 8, generator=g).to(cuda_device))
    before = t_ssd.launches.value
    got = _grads_through(lambda *a: t_ssd.ssd(*a, chunk=32), ins, ws)
    assert t_ssd.launches.value == before + 1
    _assert_grads_close(got, _grads_through(
        lambda *a: t_ssd.ssd_plain(*a, chunk=32), ins, ws))


@pytest.mark.cuda
def test_cuda_wrappers_count_one_launch_per_call(cuda_device):
    before = (t_fa.launches.value, t_ssd.launches.value)
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in _fa_inputs(1, 8, 8, 2, 1, 16))
    t_fa.flash_attention(q, k, v)
    t_ssd.ssd(*(torch.from_numpy(a).to(cuda_device)
                for a in _ssd_inputs(1, 8, 2, 8, 1, 4)), chunk=4)
    torch.cuda.synchronize()
    assert (t_fa.launches.value, t_ssd.launches.value) == (before[0] + 1,
                                                           before[1] + 1)


def test_flash_plain_unreached_rows_follow_ref(needs_jax):
    """Causal with S > T: rows that no key reaches get ``ref.py``'s uniform
    average from the plain version (the kernel gives zeros, as the TPU
    kernel does; see the cuda test above)."""
    q, k, v = _fa_inputs(1, 48, 32, 2, 1, 16, seed=4)
    got = t_fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    want = fa_ref.flash_attention_ref(*(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FA_TOL)
    np.testing.assert_allclose(got.numpy()[:, :16],
                               np.broadcast_to(v.mean(axis=1, keepdims=True),
                                               (1, 16, 1, 16))
                               .repeat(2, axis=2), **FA_TOL)
