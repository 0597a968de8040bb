"""Fused quantize: one read of x gives the int32 bin, the dequantized value
and the squared quantization error.

Replaces the TPU kernel ``_quantize_kernel`` (``quantize_fused_fwd``,
``src/repro/kernels/quantize/kernel.py``).  The CUDA kernel is
``csrc/quantize.cu``; its note says what bounds it and how it is built.

``quantize_fused`` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors; ``launches`` counts kernel launches only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantization import dequantize, quantize
from repro_torch.kernels import build

Tensor = torch.Tensor

launches = build.LaunchCounter()


def quantize_fused_plain(x: Tensor, bin_size) -> tuple[Tensor, Tensor, Tensor]:
    """x: any shape, float32 or bfloat16 -> (q int32, deq in x's dtype, err2
    float32), computed in float32 as the TPU kernel computes it."""
    x32 = x.to(torch.float32)
    q = quantize(x32, bin_size)
    deq = dequantize(q, bin_size)
    return q, deq.to(x.dtype), torch.square(x32 - deq)


_ENTRY = {torch.float32: "quantize_f32", torch.bfloat16: "quantize_bf16"}


def _declare(lib: ctypes.CDLL) -> None:
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int


def quantize_fused(x: Tensor, bin_size) -> tuple[Tensor, Tensor, Tensor]:
    """x: any shape -> (q int32, deq in x's dtype, err2 float32), all shaped
    like x."""
    if x.device.type == "cpu":
        return quantize_fused_plain(x, bin_size)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_fused: unsupported device {x.device}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"quantize_fused: kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("quantize_fused: kernel takes a contiguous tensor")
    q = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    deq = torch.empty_like(x)
    err2 = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    lib = build.library("quantize", _declare)
    with torch.cuda.device(x.device):
        status = getattr(lib, _ENTRY[x.dtype])(
            x.data_ptr(), q.data_ptr(), deq.data_ptr(), err2.data_ptr(),
            x.numel(), float(bin_size), build.stream_ptr(x.device))
    build.check(status, _ENTRY[x.dtype])
    launches.add()
    return q, deq, err2
