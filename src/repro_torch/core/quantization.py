"""Uniform quantization (paper Sec. II-E), in PyTorch.

Values are binned into uniform bins of width ``bin_size``; every value in a bin
is represented by the bin's central value.  ``quantize`` returns int32 bin
indices (storable / entropy-codable), ``dequantize`` maps back to centers.

These are the plain formulas.  The compressor's hot path quantizes through
the fused kernel ``repro_torch.kernels.quantize.ops.quantize_fused``, whose
plain version is built from the functions here.

The bin width is always a float32 tensor on ``x``'s device, never a Python
scalar: on CUDA, PyTorch divides by a CPU scalar as a multiply by its
reciprocal, which moves half-way points into the other bin.  ``x / bin`` here
is a true float32 division, as ``jnp.round(x / bin_size)`` is in the JAX
package, and ``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def bin_tensor(bin_size, like: Tensor) -> Tensor:
    """``bin_size`` as a float32 scalar tensor on ``like``'s device."""
    return torch.as_tensor(bin_size, dtype=torch.float32, device=like.device)


def quantize(x: Tensor, bin_size) -> Tensor:
    """float -> int32 bin index (round-to-nearest, half to even)."""
    return torch.round(x / bin_tensor(bin_size, x)).to(torch.int32)


def dequantize(q: Tensor, bin_size, dtype=torch.float32) -> Tensor:
    return (q.to(torch.float32) * bin_tensor(bin_size, q)).to(dtype)


def quantize_dequantize(x: Tensor, bin_size) -> Tensor:
    """Fused round-trip: the value the decoder will see."""
    return dequantize(quantize(x, bin_size), bin_size, dtype=x.dtype)


def quantization_error_bound(bin_size: float, n: int) -> float:
    """Worst-case l2 error of uniformly quantizing an n-vector: sqrt(n)*bin/2."""
    return float(bin_size) * 0.5 * float(n) ** 0.5
