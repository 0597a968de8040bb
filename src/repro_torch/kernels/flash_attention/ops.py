"""Forward attention with online softmax: causal or not, optional sliding
window, grouped-query heads, queries suffix-aligned to the end of the keys.

Replaces the TPU kernel ``_attn_kernel`` (``flash_attention_fwd``,
``src/repro/kernels/flash_attention/kernel.py``).  The CUDA kernel is
``csrc/flash_attention.cu``; its note says what bounds it and how.

``flash_attention`` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors; ``launches`` counts kernel launches only.  The
kernel has two paths, chosen by dtype alone: bfloat16 runs on the tensor
cores (``wgmma``) for every head size in ``HEAD_DIMS`` and rounds p to
bfloat16 before the P.V product, as FlashAttention does; float32 runs in
fp32 FMA.

One divergence, as in the JAX package: a query row that no key reaches
(causal with S > T) gets zeros from the kernel, as from the TPU kernel, and a
uniform average over all keys from the plain version, as from ``ref.py``.
With T >= S no row is unreached.

On CUDA the launch sits inside a ``torch.autograd.Function`` whose backward
is ``flash_attention_backward_plain``: the plain version recomputed and
differentiated (the JAX package has no backward kernel).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

Tensor = torch.Tensor

launches = build.LaunchCounter()

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 48, 64, 128)     # the head sizes the kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def grouped_attention(q: Tensor, k: Tensor, v: Tensor,
                      mask: Optional[Tensor]) -> Tensor:
    """q: (B,S,H,hd), k/v: (B,T,KV,hd); grouped einsum without repeating KV.
    ``mask`` broadcasts against the (B, KV, H/KV, S, T) scores."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k) / math.sqrt(hd)
    scores = scores.to(torch.float32)
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.einsum("bkgst,btkd->bskgd", w, v)
    return ctx.reshape(b, s, h, hd)


def attention_mask(s: int, t: int, causal: bool, window: int,
                   device) -> Tensor:
    """(S, T) bool: query i sits at absolute time i + (T - S)."""
    i = torch.arange(s, device=device)[:, None] + (t - s)
    j = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (j <= i)
    if window:
        mask = mask & (i - j < window)
    return mask


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor, *,
                          causal: bool = True, window: int = 0) -> Tensor:
    """q: (B,S,H,hd), k/v: (B,T,KV,hd) -> (B,S,H,hd); follows ``ref.py``."""
    mask = attention_mask(q.shape[1], k.shape[1], causal, window, q.device)
    return grouped_attention(q, k, v, mask[None, None, None])


def flash_attention_backward_plain(q: Tensor, k: Tensor, v: Tensor,
                                   d_out: Tensor, *, causal: bool = True,
                                   window: int = 0
                                   ) -> tuple[Tensor, Tensor, Tensor]:
    """Gradients ``(dq, dk, dv)`` for the output's gradient ``d_out``: the
    plain version recomputed and differentiated.  The rows no key reaches
    (causal with S > T) are zeros in the kernel's forward, so their output
    gradient is dropped first."""
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    unreached = q.shape[1] - k.shape[1]
    if causal and unreached > 0:
        d_out = d_out.clone()
        d_out[:, :unreached] = 0
    with torch.enable_grad():
        out = flash_attention_plain(*ins, causal=causal, window=window)
    return torch.autograd.grad(out, ins, d_out)


def _declare(lib: ctypes.CDLL) -> None:
    lib.flash_attention_fwd.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.flash_attention_fwd.restype = ctypes.c_int


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int = 0) -> Tensor:
    """q: (B, S, H, hd), k/v: (B, T, KV, hd) -> (B, S, H, hd)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q, k, v on {q.device}, {k.device}, "
                         f"{v.device}; the kernel takes one CUDA device")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: kernel takes float32 or bfloat16 "
                        f"q, k, v of one type, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: kernel takes contiguous q, k, v")
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if (k.shape != (b, t, kvh, hd) or v.shape != k.shape or kvh < 1
            or h % kvh):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention: kernel takes q, k, v that start "
                         "on 16-byte boundaries (TMA and cp.async)")
    return _FlashAttention.apply(q, k, v, causal, window)


class _FlashAttention(torch.autograd.Function):
    """The kernel's launch; the backward differentiates the plain version."""

    @staticmethod
    def forward(ctx, q: Tensor, k: Tensor, v: Tensor, causal: bool,
                window: int) -> Tensor:
        ctx.causal, ctx.window = causal, window
        ctx.save_for_backward(q, k, v)
        return _launch(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, d_out: Tensor):
        return (*flash_attention_backward_plain(
            *ctx.saved_tensors, d_out, causal=ctx.causal, window=ctx.window),
            None, None)


def _launch(q: Tensor, k: Tensor, v: Tensor, causal: bool,
            window: int) -> Tensor:
    """One kernel launch on checked CUDA q, k, v."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = build.library("flash_attention", _declare)
    with torch.cuda.device(q.device):
        status = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, s, t, h, kvh, hd, int(causal), window,
            build.stream_ptr(q.device))
    build.check(status, "flash_attention_fwd")
    launches.add()
    return out
