"""GAE projection: c = R @ U and c2 = c^2 in one pass, in IEEE fp32.

Replaces the TPU kernel ``_gae_project_kernel`` (``gae_project_fwd``,
``src/repro/kernels/gae_project/kernel.py``).  The CUDA kernel is
``csrc/gae_project.cu``; its note says what bounds it and how.

``gae_project`` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors; ``launches`` counts kernel launches only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

Tensor = torch.Tensor

launches = build.LaunchCounter()


def gae_project_plain(residuals: Tensor, basis: Tensor) -> tuple[Tensor, Tensor]:
    """residuals: (N, D), basis: (D, Dout) -> (c, c2), both (N, Dout)."""
    c = residuals.to(torch.float32) @ basis.to(torch.float32)
    return c, torch.square(c)


def _declare(lib: ctypes.CDLL) -> None:
    lib.gae_project_f32.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.gae_project_f32.restype = ctypes.c_int


def gae_project(residuals: Tensor, basis: Tensor) -> tuple[Tensor, Tensor]:
    """residuals: (N, D), basis: (D, Dout) -> (c, c2), both (N, Dout) fp32."""
    if residuals.device.type == "cpu":
        return gae_project_plain(residuals, basis)
    if residuals.device.type != "cuda" or basis.device != residuals.device:
        raise ValueError(f"gae_project: residuals on {residuals.device}, "
                         f"basis on {basis.device}; the kernel takes one "
                         f"CUDA device")
    if residuals.dtype != torch.float32 or basis.dtype != torch.float32:
        raise TypeError("gae_project: kernel takes float32 inputs")
    if residuals.dim() != 2 or basis.dim() != 2 \
            or residuals.shape[1] != basis.shape[0]:
        raise ValueError(f"gae_project: shapes {tuple(residuals.shape)} @ "
                         f"{tuple(basis.shape)} do not chain")
    if not (residuals.is_contiguous() and basis.is_contiguous()):
        raise ValueError("gae_project: kernel takes contiguous inputs")
    n, d = residuals.shape
    dout = basis.shape[1]
    c = torch.empty(n, dout, dtype=torch.float32, device=residuals.device)
    c2 = torch.empty_like(c)
    lib = build.library("gae_project", _declare)
    with torch.cuda.device(residuals.device):
        status = lib.gae_project_f32(
            residuals.data_ptr(), basis.data_ptr(), c.data_ptr(),
            c2.data_ptr(), n, d, dout, build.stream_ptr(residuals.device))
    build.check(status, "gae_project_f32")
    launches.add()
    return c, c2
