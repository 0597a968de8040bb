"""Hyper-block self-attention: softmax(Q K^T / sqrt(d_h)) V per hyper-block.

Replaces the TPU kernel ``_block_attn_kernel`` (``block_attention_fwd``,
``src/repro/kernels/block_attention/kernel.py``).  The CUDA kernel is
``csrc/block_attention.cu``; its note says what bounds it and how.

``block_attention`` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors; ``launches`` counts kernel launches only.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

Tensor = torch.Tensor

launches = build.LaunchCounter()

_MAX_SMEM = 232448      # bytes of shared memory a block may use on Hopper


def block_attention_plain(q: Tensor, k: Tensor, v: Tensor,
                          heads: int = 1) -> Tensor:
    """q/k: (..., n, dk), v: (..., n, dv) -> (..., n, dv); softmax in fp32."""
    *lead, n, dk = q.shape
    dv = v.shape[-1]
    hq = q.reshape(*lead, n, heads, dk // heads)
    hk = k.reshape(*lead, n, heads, dk // heads)
    hv = v.reshape(*lead, n, heads, dv // heads)
    scores = torch.einsum("...qhd,...khd->...hqk", hq, hk) / math.sqrt(dk // heads)
    w = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    ctx = torch.einsum("...hqk,...khd->...qhd", w, hv)
    return ctx.reshape(*lead, n, dv)


def _declare(lib: ctypes.CDLL) -> None:
    lib.block_attention_f32.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.block_attention_f32.restype = ctypes.c_int


def block_attention(q: Tensor, k: Tensor, v: Tensor, heads: int = 1) -> Tensor:
    """q/k: (..., n, dk), v: (..., n, dv) -> (..., n, dv)."""
    if q.device.type == "cpu":
        return block_attention_plain(q, k, v, heads)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"block_attention: q, k, v on {q.device}, {k.device}, "
                         f"{v.device}; the kernel takes one CUDA device")
    if not (q.dtype == k.dtype == v.dtype == torch.float32):
        raise TypeError("block_attention: kernel takes float32 q, k, v")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("block_attention: kernel takes contiguous q, k, v")
    *lead, n, dk = q.shape
    dv = v.shape[-1]
    if k.shape != q.shape or v.shape[:-1] != q.shape[:-1]:
        raise ValueError(f"block_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if heads < 1 or dk % heads or dv % heads:
        raise ValueError(f"block_attention: heads={heads} must divide "
                         f"dk={dk} and dv={dv}")
    smem = 4 * (n * (dk + 1) * 2 + n * (dv + 1) + heads * n * n)
    if smem > _MAX_SMEM:
        raise ValueError(f"block_attention: n={n} needs {smem} bytes of "
                         f"shared memory, more than {_MAX_SMEM}")
    batch = math.prod(lead)
    out = torch.empty(*lead, n, dv, dtype=q.dtype, device=q.device)
    lib = build.library("block_attention", _declare)
    with torch.cuda.device(q.device):
        status = lib.block_attention_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            batch, n, dk, dv, heads, build.stream_ptr(q.device))
    build.check(status, "block_attention_f32")
    launches.add()
    return out
