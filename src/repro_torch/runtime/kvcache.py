"""Paged KV cache with error-bounded compression of frozen pages: the
paper's PCA-GAE machinery applied to the serving-time KV cache, in PyTorch.

A page is 16 consecutive tokens of one layer's K (or V) tensor — shape
(page, KV, hd), flattened to a vector.  Frozen pages are compressed against
a PCA basis fit over the page vectors, keeping per page the minimal number
of quantized leading coefficients such that ||page - page^G||_2 <= tau — a
guaranteed bound on the KV perturbation entering attention.

``quantize_kv_bounded`` is the in-loop path the serving engine uses: uniform
quantization through the fused quantize kernel, with a per-token l2 bound.
``compress_pages`` / ``decompress_pages`` and ``CompressedKVStore`` are the
host-side page archive on top of ``core.gae`` and ``core.entropy``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import entropy, gae
from repro_torch.core.exec import resolve_device, upload
from repro_torch.kernels.quantize.ops import quantize_fused

Tensor = torch.Tensor

PAGE_TOKENS = 16


def paginate(kv: np.ndarray, page: int = PAGE_TOKENS) -> np.ndarray:
    """(B, S, KV, hd) -> (B, n_pages, page*KV*hd); S must divide into pages."""
    b, s, kvh, hd = kv.shape
    if s % page:
        raise ValueError(f"paginate: {s} tokens do not divide into pages of "
                         f"{page}")
    return kv.reshape(b, s // page, page * kvh * hd)


def unpaginate(pages: np.ndarray, kvh: int, hd: int,
               page: int = PAGE_TOKENS) -> np.ndarray:
    b, n_pages, d = pages.shape
    if d != page * kvh * hd:
        raise ValueError(f"unpaginate: page vectors of {d} values, expected "
                         f"{page} x {kvh} x {hd}")
    return pages.reshape(b, n_pages * page, kvh, hd)


@dataclasses.dataclass
class CompressedKVStore:
    """Frozen-page archive for one layer's K or V stream."""
    basis: np.ndarray                 # (D, D)
    codes: list[gae.GAEBlockCode]
    n_pages: int
    page_shape: tuple                 # (page, KV, hd)
    tau: float
    bin_size: float
    dtype: np.dtype

    def nbytes(self) -> int:
        """Archive cost: quantized coefficients (Huffman) + index bitmasks +
        per-page bin exponents.  The basis is amortized across the serving
        session, as the paper amortizes model cost."""
        coeffs = np.concatenate([c.qcoeffs for c in self.codes]) \
            if self.codes else np.zeros(0, np.int64)
        total = entropy.huffman_size_bits(coeffs) // 8 if coeffs.size else 0
        total += len(entropy.encode_index_sets(
            [np.sort(c.indices) for c in self.codes], self.basis.shape[0]))
        total += len(self.codes)  # bin_exp bytes
        return total

    def raw_nbytes(self) -> int:
        d = int(np.prod(self.page_shape))
        return self.n_pages * d * self.dtype.itemsize


def compress_pages(pages: np.ndarray, *, tau: float, bin_size: float = 1e-3,
                   basis: Optional[np.ndarray] = None,
                   page_shape: tuple = (PAGE_TOKENS, 1, 64), device=None
                   ) -> tuple[np.ndarray, CompressedKVStore]:
    """pages: (N, D) flattened frozen pages.  Returns (reconstruction with the
    per-page guarantee, archive).  The basis fit and the batched selection
    run on ``device`` (the card by default)."""
    device = resolve_device(device)
    pages = np.asarray(pages, np.float32)
    if basis is None:
        basis = gae.fit_pca_basis(upload(pages, device)).cpu().numpy()
    zeros = np.zeros_like(pages)
    recon, codes = gae.gae_encode_blocks(pages, zeros, basis, tau, bin_size,
                                         device=device)
    store = CompressedKVStore(basis=basis, codes=codes, n_pages=pages.shape[0],
                              page_shape=page_shape, tau=tau,
                              bin_size=bin_size, dtype=np.dtype(np.float32))
    return recon, store


def decompress_pages(store: CompressedKVStore) -> np.ndarray:
    d = store.basis.shape[0]
    zeros = np.zeros((store.n_pages, d), np.float32)
    return gae.gae_decode_blocks(zeros, store.basis, store.codes,
                                 store.bin_size)


def attention_perturbation_bound(tau: float, page_elems: int,
                                 n_pages: int) -> float:
    """Worst-case l2 perturbation of the attention *input* (the concatenated
    KV) given per-page ||dK||_2 <= tau: sqrt(n_pages) * tau (pages are
    disjoint coordinates).  Normalized per element: tau / sqrt(page_elems)."""
    return float(np.sqrt(n_pages) * tau)


def quantize_kv_bounded(kv: Tensor, tau_per_token: float) -> Tensor:
    """Uniform KV quantization with a per-token l2 guarantee: bin =
    2 tau / sqrt(KV*hd) makes the worst-case per-token quantization error
    exactly tau.  kv: (..., KV, hd).  The dequantized values come from the
    fused quantize kernel (its plain version on the CPU) on the
    (..., KV*hd) view, in float32; a bf16 cache goes in as it is (the
    kernel reads it into float32 and rounds the dequantized value to bf16
    once, as a cast before and after it would)."""
    d = kv.shape[-1] * kv.shape[-2]
    bin_size = 2.0 * tau_per_token / float(np.sqrt(d))
    flat = kv.reshape(*kv.shape[:-2], d)
    if flat.dtype != torch.bfloat16:
        flat = flat.to(torch.float32)
    _, deq, _ = quantize_fused(flat.contiguous(), bin_size)
    return deq.reshape(kv.shape).to(kv.dtype)
