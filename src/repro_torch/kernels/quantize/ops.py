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
    """x: any shape float32 -> (q int32, deq float32, err2 float32)."""
    q = quantize(x, bin_size)
    deq = dequantize(q, bin_size, dtype=x.dtype)
    return q, deq, torch.square(x - deq)


def _declare(lib: ctypes.CDLL) -> None:
    lib.quantize_f32.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
    lib.quantize_f32.restype = ctypes.c_int


def quantize_fused(x: Tensor, bin_size) -> tuple[Tensor, Tensor, Tensor]:
    """x: any shape -> (q int32, deq, err2), all shaped like x."""
    if x.device.type == "cpu":
        return quantize_fused_plain(x, bin_size)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_fused: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"quantize_fused: kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("quantize_fused: kernel takes a contiguous tensor")
    q = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    deq = torch.empty_like(x)
    err2 = torch.empty_like(x)
    lib = build.library("quantize", _declare)
    with torch.cuda.device(x.device):
        status = lib.quantize_f32(
            x.data_ptr(), q.data_ptr(), deq.data_ptr(), err2.data_ptr(),
            x.numel(), float(bin_size), build.stream_ptr(x.device))
    build.check(status, "quantize_f32")
    launches.add()
    return q, deq, err2
