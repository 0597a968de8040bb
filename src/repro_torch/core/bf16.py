"""bf16 across the numpy boundary: the one module that knows its format.

numpy has no bfloat16 of its own.  ``jax.device_get`` gives a bf16 array as
ml_dtypes' ``bfloat16`` (kind ``V``, two bytes a value, which torch cannot
read), and the JAX package's checkpoints hold those two bytes under the
manifest dtype "bfloat16" (``|V2`` when read back).  The port carries a bf16
value as the same two bytes viewed as ``uint16``, and never imports
ml_dtypes.
"""
from __future__ import annotations

import numpy as np
import torch

NAME = "bfloat16"     # the dtype's name in numpy (ml_dtypes) and manifests


def is_bf16(leaf) -> bool:
    """A bf16 tensor, or a numpy array of ml_dtypes' bfloat16."""
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype == torch.bfloat16
    return getattr(getattr(leaf, "dtype", None), "name", None) == NAME


def to_bits(leaf) -> np.ndarray:
    """The uint16 bits of a bf16 tensor (on any device) or ml_dtypes array,
    in a host copy that shares no memory with ``leaf``."""
    if isinstance(leaf, torch.Tensor):
        host = leaf.detach().to("cpu", copy=True)
        return host.view(torch.int16).numpy().view(np.uint16)
    return np.array(leaf).view(np.uint16)


def from_bits(bits: np.ndarray) -> torch.Tensor:
    """The bf16 tensor whose two bytes a value ``bits`` holds (ml_dtypes'
    bfloat16, its ``|V2`` bytes, or uint16), bit for bit."""
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.uint16)).view(
        torch.bfloat16)
