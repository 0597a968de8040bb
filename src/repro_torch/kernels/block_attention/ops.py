"""Hyper-block self-attention: softmax(Q K^T / sqrt(d_h)) V per hyper-block.

Replaces the TPU kernel ``_block_attn_kernel`` (``block_attention_fwd``,
``src/repro/kernels/block_attention/kernel.py``).  The CUDA kernels are in
``csrc/block_attention.cu``; its note says what bounds them and how.

``block_attention`` takes the plain version for CPU tensors and launches a
kernel for CUDA tensors: fp32 or bf16 q, k, v, computed in fp32 and written
in the input's dtype, as the TPU kernel does.  ``launch_plan`` is the shape
rule that picks the kernel (the warp path, or the general path for what the
warp path cannot take); ``launches`` counts kernel launches only.

On CUDA the launch sits inside a ``torch.autograd.Function``, so a loss
through the kernel has gradients for q, k and v.  Its backward is
``block_attention_backward_plain``, the softmax's gradient in torch ops (the
JAX package has no backward kernel and trains through its jnp path).
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build

Tensor = torch.Tensor

launches = build.LaunchCounter()

_MAX_SMEM = 232448      # bytes of shared memory a block may use on Hopper
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The warp kernel's instantiations, as in csrc/block_attention.cu: (bytes of
# an element, key rows a lane holds) -> the most query rows a warp holds.
WARP_TILES = {(4, 2): 4, (4, 4): 8, (4, 5): 10, (4, 8): 10, (4, 10): 10,
              (4, 16): 8,
              (2, 2): 4, (2, 4): 8, (2, 5): 10, (2, 8): 8}
# warps the launch aims for per SM (one per scheduler) when the batch is
# small: a hyper-block's query rows are then split over several warps
WARPS_PER_SM = 4


class Launch(NamedTuple):
    path: str          # "warp" or "general"
    kpl: int = 0       # key rows a lane holds: the warp kernel's instantiation
    qpw: int = 0       # query rows a warp owns
    wph: int = 0       # warps a hyper-block


def launch_plan(batch: int, n: int, dk: int, dv: int, heads: int,
                dtype: torch.dtype, aligned: bool = True,
                sms: int = 132) -> Launch:
    """The kernel that takes these shapes, and the warp path's launch.

    The warp path needs dk == dv == d, 16-byte rows split into d / VEC lanes
    (VEC = 4 fp32 or 8 bf16) with d / VEC a power of two <= 32, heads of
    whole lanes (d / heads a multiple of VEC), at most the largest
    instantiation's key rows a lane, and 16-byte aligned pointers; anything
    else takes the general path.
    """
    size = dtype.itemsize
    vec = 16 // size
    lanes = dk // vec
    if (dk != dv or not aligned or dk % vec or lanes > 32
            or lanes & (lanes - 1) or dk % heads or (dk // heads) % vec):
        return Launch("general")
    need = -(-n // (32 // lanes))
    fits = sorted(kpl for s, kpl in WARP_TILES if s == size and kpl >= need)
    if not fits:
        return Launch("general")
    kpl = fits[0]
    qmax = WARP_TILES[size, kpl]
    wph = max(-(-n // qmax), min(n, -(-WARPS_PER_SM * sms // max(batch, 1))))
    qpw = -(-n // wph)
    qpw = min(qmax, qpw + qpw % 2)      # the kernel runs query rows in pairs
    return Launch("warp", kpl, qpw, -(-n // qpw))


def block_attention_plain(q: Tensor, k: Tensor, v: Tensor,
                          heads: int = 1) -> Tensor:
    """q/k: (..., n, dk), v: (..., n, dv) -> (..., n, dv); softmax in fp32,
    the products in the input's dtype (as ``ref.py``)."""
    *lead, n, dk = q.shape
    dv = v.shape[-1]
    hq = q.reshape(*lead, n, heads, dk // heads)
    hk = k.reshape(*lead, n, heads, dk // heads)
    hv = v.reshape(*lead, n, heads, dv // heads)
    scores = torch.einsum("...qhd,...khd->...hqk", hq, hk) / math.sqrt(dk // heads)
    w = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    ctx = torch.einsum("...hqk,...khd->...qhd", w, hv)
    return ctx.reshape(*lead, n, dv)


def block_attention_backward_plain(q: Tensor, k: Tensor, v: Tensor,
                                   heads: int, d_out: Tensor
                                   ) -> tuple[Tensor, Tensor, Tensor]:
    """Gradients ``(dq, dk, dv)`` of ``block_attention(q, k, v, heads)`` for
    the output's gradient ``d_out``, per head, in fp32 (the softmax in fp32,
    as the plain forward has it; the kernel computes in fp32), returned in
    the inputs' dtypes:

        P = softmax(Q K^T / sqrt(d_h)),  dV = P^T dO,  dP = dO V^T,
        dS = P * (dP - rowsum(dP * P)),
        dQ = dS K / sqrt(d_h),  dK = dS^T Q / sqrt(d_h).
    """
    *lead, n, dk = q.shape
    dv = v.shape[-1]
    scale = math.sqrt(dk // heads)

    def split(t: Tensor) -> Tensor:
        return t.reshape(*lead, n, heads, t.shape[-1] // heads).to(torch.float32)

    hq, hk, hv, hdo = (split(t) for t in (q, k, v, d_out))
    p = torch.softmax(torch.einsum("...qhd,...khd->...hqk", hq, hk) / scale,
                      dim=-1)
    d_v = torch.einsum("...hqk,...qhd->...khd", p, hdo)
    d_p = torch.einsum("...qhd,...khd->...hqk", hdo, hv)
    d_s = p * (d_p - torch.sum(d_p * p, dim=-1, keepdim=True))
    d_q = torch.einsum("...hqk,...khd->...qhd", d_s, hk) / scale
    d_k = torch.einsum("...hqk,...qhd->...khd", d_s, hq) / scale
    return (d_q.reshape(*lead, n, dk).to(q.dtype),
            d_k.reshape(*lead, n, dk).to(k.dtype),
            d_v.reshape(*lead, n, dv).to(v.dtype))


def _declare(lib: ctypes.CDLL) -> None:
    lib.block_attention_warp.argtypes = [ctypes.c_int] + [
        ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.block_attention_warp.restype = ctypes.c_int
    lib.block_attention_general.argtypes = [ctypes.c_int] + [
        ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.block_attention_general.restype = ctypes.c_int


def block_attention(q: Tensor, k: Tensor, v: Tensor, heads: int = 1) -> Tensor:
    """q/k: (..., n, dk), v: (..., n, dv) -> (..., n, dv)."""
    if q.device.type == "cpu":
        return block_attention_plain(q, k, v, heads)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"block_attention: q, k, v on {q.device}, {k.device}, "
                         f"{v.device}; the kernel takes one CUDA device")
    if not (q.dtype == k.dtype == v.dtype and q.dtype in _DTYPES):
        raise TypeError(f"block_attention: kernel takes float32 or bfloat16 "
                        f"q, k, v, not {q.dtype}, {k.dtype}, {v.dtype}")
    *lead, n, dk = q.shape
    dv = v.shape[-1]
    if k.shape != q.shape or v.shape[:-1] != q.shape[:-1]:
        raise ValueError(f"block_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if heads < 1 or dk % heads or dv % heads:
        raise ValueError(f"block_attention: heads={heads} must divide "
                         f"dk={dk} and dv={dv}")
    # views are copied, as the TPU wrapper takes any array; a contiguous
    # input that is not 16-byte aligned takes the general kernel
    return _BlockAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), heads)


class _BlockAttention(torch.autograd.Function):
    """The kernel's launch, with ``block_attention_backward_plain`` as its
    backward."""

    @staticmethod
    def forward(ctx, q: Tensor, k: Tensor, v: Tensor, heads: int) -> Tensor:
        ctx.heads = heads
        ctx.save_for_backward(q, k, v)
        return _launch(q, k, v, heads)

    @staticmethod
    def backward(ctx, d_out: Tensor):
        q, k, v = ctx.saved_tensors
        return (*block_attention_backward_plain(q, k, v, ctx.heads, d_out),
                None)


def _launch(q: Tensor, k: Tensor, v: Tensor, heads: int) -> Tensor:
    """One kernel launch on checked CUDA q, k, v."""
    *lead, n, dk = q.shape
    dv = v.shape[-1]
    batch = math.prod(lead)
    aligned = not any(x.data_ptr() % 16 for x in (q, k, v))
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = launch_plan(batch, n, dk, dv, heads, q.dtype, aligned, sms)
    if plan.path == "general":
        smem = 4 * (n * (dk + 1) * 2 + n * (dv + 1) + heads * n * n)
        if smem > _MAX_SMEM:
            raise ValueError(f"block_attention: n={n} needs {smem} bytes of "
                             f"shared memory, more than {_MAX_SMEM}")
    out = torch.empty(*lead, n, dv, dtype=q.dtype, device=q.device)
    lib = build.library("block_attention", _declare)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    with torch.cuda.device(q.device):
        stream = build.stream_ptr(q.device)
        if plan.path == "warp":
            status = lib.block_attention_warp(
                _DTYPES[q.dtype], *ptrs, batch, n, dk, heads, plan.kpl,
                plan.qpw, plan.wph, stream)
        else:
            status = lib.block_attention_general(
                _DTYPES[q.dtype], *ptrs, batch, n, dk, dv, heads, stream)
    build.check(status, f"block_attention_{plan.path}")
    launches.add()
    return out
