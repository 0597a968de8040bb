"""Blocking / hyper-block grouping / normalization for gridded scientific data.

Mirrors the paper's Sec. III data preparation:
  * S3D  : 4D (species 58, T 50, H 640, W 640) -> blocks (58,5,4,4); 10
           consecutive temporal blocks form one hyper-block; per-species
           normalization to mean 0 / range 1; GAE at (5,4,4) per species.
  * E3SM : (T 720, H 240, W 1440) -> blocks (6,16,16); 5 consecutive temporal
           blocks per hyper-block; z-score normalization; GAE at (16,16).
  * XGC  : (planes 8, nodes, 39, 39) -> each (39,39) histogram is a block; the
           8 planes at one node form a hyper-block; z-score; GAE per histogram.

``block_nd``/``unblock_nd`` are exact inverses for any divisible shape.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class BlockMeta:
    data_shape: tuple[int, ...]
    block_shape: tuple[int, ...]
    grid_shape: tuple[int, ...]


def block_nd(data: np.ndarray, block_shape: Sequence[int]) -> tuple[np.ndarray, BlockMeta]:
    """(d1..dn) -> (n_blocks, prod(block_shape)), row-major over the block grid."""
    shape = data.shape
    bs = tuple(block_shape)
    assert len(bs) == data.ndim, (shape, bs)
    assert all(s % b == 0 for s, b in zip(shape, bs)), f"{shape} not divisible by {bs}"
    grid = tuple(s // b for s, b in zip(shape, bs))
    # interleave grid and block axes, then bring grid axes first
    inter = []
    for g, b in zip(grid, bs):
        inter.extend([g, b])
    x = data.reshape(inter)
    n = data.ndim
    x = x.transpose(*range(0, 2 * n, 2), *range(1, 2 * n, 2))
    blocks = x.reshape(int(np.prod(grid)), int(np.prod(bs)))
    return np.ascontiguousarray(blocks), BlockMeta(tuple(shape), bs, grid)


def unblock_nd(blocks: np.ndarray, meta: BlockMeta) -> np.ndarray:
    grid, bs = meta.grid_shape, meta.block_shape
    n = len(bs)
    x = blocks.reshape(*grid, *bs)
    perm = []
    for i in range(n):
        perm.extend([i, n + i])
    x = x.transpose(*perm)
    return np.ascontiguousarray(x.reshape(meta.data_shape))


def group_hyperblocks(blocks: np.ndarray, k: int) -> np.ndarray:
    """(N, D) -> (N//k, k, D): k consecutive blocks per hyper-block (the paper
    groups along the leading/temporal grid axis; block_nd's row-major grid
    ordering makes consecutive blocks temporal neighbours when the temporal
    axis is the fastest-varying grid axis — callers arrange axes accordingly)."""
    n, d = blocks.shape
    assert n % k == 0, (n, k)
    return blocks.reshape(n // k, k, d)


def ungroup_hyperblocks(hblocks: np.ndarray) -> np.ndarray:
    nh, k, d = hblocks.shape
    return hblocks.reshape(nh * k, d)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Normalizer:
    """Invertible affine normalization with stored statistics.

    mode='range'  : per-channel mean 0, range 1 (paper's S3D per-species setup)
    mode='zscore' : global z-score (paper's E3SM / XGC setup)
    """
    mode: str
    offset: np.ndarray
    scale: np.ndarray
    axis: int | None

    @staticmethod
    def fit(data: np.ndarray, mode: str = "zscore", axis: int | None = None) -> "Normalizer":
        if mode == "zscore":
            off = np.asarray(data.mean(), np.float32)
            sc = np.asarray(max(float(data.std()), 1e-12), np.float32)
            return Normalizer("zscore", off, sc, None)
        if mode == "range":
            assert axis is not None
            red = tuple(i for i in range(data.ndim) if i != axis)
            mean = data.mean(axis=red, keepdims=True).astype(np.float32)
            rng = (data.max(axis=red, keepdims=True) - data.min(axis=red, keepdims=True))
            rng = np.maximum(rng, 1e-12).astype(np.float32)
            return Normalizer("range", mean, rng, axis)
        raise ValueError(mode)

    def forward(self, data: np.ndarray) -> np.ndarray:
        return ((data - self.offset) / self.scale).astype(np.float32)

    def inverse(self, data: np.ndarray) -> np.ndarray:
        return (data * self.scale + self.offset).astype(np.float32)


def nrmse(original: np.ndarray, recon: np.ndarray) -> float:
    """Paper Eq. 11."""
    rng = float(original.max() - original.min())
    rng = max(rng, 1e-30)
    return float(np.sqrt(np.mean(np.square(original - recon))) / rng)
