"""GAE — Guaranteed-error-bound post-processing (paper Sec. II-D, Algorithm 1),
in PyTorch.

Given original blocks x, autoencoder reconstructions x^R and a user bound tau,
GAE projects each block residual onto a PCA basis U (fit on the residuals of
the whole dataset), keeps the top-M *quantized* coefficients per block with M
minimal such that ||x - x^G||_2 <= tau, and corrects x^G = x^R + U_s c_q.

Three implementations, held equal by tests:

* ``gae_reference_loop`` — a literal per-block port of the paper's Algorithm 1
  (numpy).  The oracle.
* ``select_host`` — the numpy twin of the batched selection (the JAX
  package's host encoder).  Kept as an oracle.
* ``gae_select`` — the batched selection on tensors.  Because U is
  orthonormal, the post-correction error decomposes exactly in coefficient
  space as

      err^2(M) = sum_{k>M} c_(k)^2  +  sum_{k<=M} (c_(k) - q(c_(k)))^2

  over magnitude-sorted coefficients, so minimal M for every block falls out
  of one projection (the ``gae_project`` kernel), one sort, the fused
  quantize kernel and two cumulative sums.  On CUDA it runs on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import exec as exec_mod
from repro_torch.core.errors import GuaranteeUnsatisfiable
from repro_torch.kernels.gae_project.ops import gae_project
from repro_torch.kernels.quantize.ops import quantize_fused

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# PCA basis
# ---------------------------------------------------------------------------

def fit_pca_basis(residuals: Tensor) -> Tensor:
    """PCA basis of block residuals.

    residuals: (N, D).  Returns U (D, D) with eigenvectors as COLUMNS, sorted
    by descending eigenvalue; coefficients are c = U^T r (paper Eq. 9).
    Eigenvector signs are arbitrary, as with ``jnp.linalg.eigh``.
    """
    r = residuals.to(torch.float32)
    cov = r.T @ r                                     # (D, D)
    _, vecs = torch.linalg.eigh(cov)                  # ascending eigenvalues
    return torch.flip(vecs, dims=[1])


# ---------------------------------------------------------------------------
# one-shot batched selection
# ---------------------------------------------------------------------------

class GAESelection(NamedTuple):
    m: Tensor           # (N,)   minimal M per block (0 = block already within tau)
    order: Tensor       # (N, D) basis indices sorted by coefficient magnitude desc
    q_sorted: Tensor    # (N, D) quantized (int32) coefficients in sorted order
    corrected: Tensor   # (N, D) corrected residual reconstruction  U_s c_q
    err: Tensor         # (N,)   actual l2 error after correction
    ok: Tensor          # (N,)   bool, err <= tau achievable with this bin size


def gae_select(residuals: Tensor, basis: Tensor, tau: float,
               bin_size: float) -> GAESelection:
    """Batched minimal-M selection. residuals: (N, D); basis: (D, D)."""
    r = residuals.to(torch.float32).contiguous()
    d = r.shape[-1]
    c, c2 = gae_project(r, basis)

    # stable, as jnp.argsort is: equal magnitudes keep index order
    order = torch.argsort(-c2, dim=-1, stable=True)
    c_sorted = torch.gather(c, -1, order)
    c2_sorted = torch.gather(c2, -1, order)

    q_sorted, deq, qerr2 = quantize_fused(c_sorted, bin_size)

    total = torch.sum(c2_sorted, dim=-1, keepdim=True)         # err^2(0) = ||r||^2
    tail2 = total - torch.cumsum(c2_sorted, dim=-1)             # err tail for M=1..D
    kept2 = torch.cumsum(qerr2, dim=-1)                         # quant err for M=1..D
    err2 = torch.cat([total, tail2 + kept2], dim=-1)            # index M = 0..D

    ok_any = err2 <= tau * tau
    m = torch.argmax(ok_any.to(torch.uint8), dim=-1)            # first M satisfying
    ok = torch.any(ok_any, dim=-1)
    m = torch.where(ok, m, torch.full_like(m, d))               # fall back to full-D

    # corrected residual: U @ (masked quantized coeffs scattered back to
    # index order; the indices of a row are a permutation, so the scatter is
    # exact)
    keep = torch.arange(d, device=r.device)[None, :] < m[:, None]
    deq_masked = torch.where(keep, deq, torch.zeros_like(deq))
    c_hat = torch.zeros_like(deq).scatter_(-1, order, deq_masked)
    corrected = c_hat @ basis.T
    err = torch.linalg.vector_norm(r - corrected, dim=-1)
    return GAESelection(m=m, order=order, q_sorted=q_sorted, corrected=corrected,
                        err=err, ok=ok)


def select_host(residuals: np.ndarray, basis: np.ndarray, tau: float,
                bin_size: float) -> GAESelection:
    """Numpy twin of ``gae_select`` (the JAX package's host encoder), kept
    as an oracle.  Same math, same rounding (round-half-to-even, float32
    dequantize), same fields, as numpy arrays."""
    r = np.asarray(residuals, np.float32)
    u = np.asarray(basis, np.float32)
    d = r.shape[-1]
    c = r @ u
    c2 = np.square(c)
    order = np.argsort(-c2, axis=-1)
    c_sorted = np.take_along_axis(c, order, axis=-1)
    c2_sorted = np.take_along_axis(c2, order, axis=-1)
    q_sorted = np.round(c_sorted / bin_size).astype(np.int32)
    deq = q_sorted.astype(np.float32) * np.float32(bin_size)
    qerr2 = np.square(c_sorted - deq)
    total = c2_sorted.sum(axis=-1, keepdims=True)
    tail2 = total - np.cumsum(c2_sorted, axis=-1)
    kept2 = np.cumsum(qerr2, axis=-1)
    err2 = np.concatenate([total, tail2 + kept2], axis=-1)
    ok_any = err2 <= tau * tau
    m = np.argmax(ok_any, axis=-1)
    ok = ok_any.any(axis=-1)
    m = np.where(ok, m, d)
    keep = np.arange(d)[None, :] < m[:, None]
    c_hat = np.zeros_like(deq)
    np.put_along_axis(c_hat, order, np.where(keep, deq, np.float32(0.0)),
                      axis=-1)
    corrected = c_hat @ u.T
    err = np.linalg.norm(r - corrected, axis=-1)
    return GAESelection(m=m, order=order, q_sorted=q_sorted,
                        corrected=corrected, err=err, ok=ok)


# ---------------------------------------------------------------------------
# literal Algorithm 1 (oracle; host-side, per block)
# ---------------------------------------------------------------------------

def gae_reference_loop(x: np.ndarray, x_r: np.ndarray, basis: np.ndarray,
                       tau: float, bin_size: float) -> tuple[np.ndarray, list[int]]:
    """Direct port of paper Algorithm 1. x, x_r: (N, D); returns (x^G, M list)."""
    x = np.asarray(x, np.float32)
    x_r = np.asarray(x_r, np.float32)
    u = np.asarray(basis, np.float32)
    out = x_r.copy()
    ms = []
    for i in range(x.shape[0]):
        xi, xr = x[i], x_r[i]
        delta = float(np.linalg.norm(xi - xr))
        if delta <= tau:
            ms.append(0)
            continue
        c = u.T @ (xi - xr)                            # line 6
        order = np.argsort(-np.square(c))              # sort c_k^2 desc
        m = 1
        while True:                                    # lines 8-14
            sel = order[:m]
            cq = np.round(c[sel] / bin_size) * bin_size
            xg = xr + u[:, sel] @ cq
            delta = float(np.linalg.norm(xi - xg))
            if delta <= tau or m >= x.shape[1]:
                break
            m += 1
        out[i] = xg
        ms.append(m)
    return out, ms


# ---------------------------------------------------------------------------
# encoder with HARD guarantee (per-block bin fallback)
# ---------------------------------------------------------------------------

class GAEBlockCode(NamedTuple):
    m: int                  # number of kept coefficients
    indices: np.ndarray     # (m,) basis indices (int32), ASCENDING index order
    qcoeffs: np.ndarray     # (m,) quantized ints at bin_size / 2**bin_exp
    bin_exp: int            # per-block bin refinement exponent (usually 0)


def gae_encode_blocks(x: np.ndarray, x_r: np.ndarray, basis: np.ndarray,
                      tau: float, bin_size: float, *, device,
                      max_refine: int = 20) -> tuple[np.ndarray, list[GAEBlockCode]]:
    """Encode every block with a HARD ||x - x^G||_2 <= tau guarantee.

    The batched selection ``gae_select`` runs on ``device`` (the kernels on
    CUDA, their plain versions on the CPU).  Then the realized error of every
    block is verified against the *actual* reconstruction (guarding numerical
    non-orthonormality of the eigh basis) and, for any block that cannot meet
    tau at the global bin size, more coefficients are kept and then the bin
    is halved (per-block ``bin_exp``) until it does.  If the budget is
    exhausted with ``err > tau``, raises ``GuaranteeUnsatisfiable`` instead
    of emitting a block that violates the bound.
    """
    x = np.asarray(x, np.float32)
    x_r = np.asarray(x_r, np.float32)
    u = np.asarray(basis, np.float32)
    n, d = x.shape

    sel = gae_select(exec_mod.upload(x - x_r, device),
                     exec_mod.upload(u, device), tau, bin_size)
    out = x_r + sel.corrected.cpu().numpy()

    # batch extraction in ascending index order: scatter the kept-coefficient
    # membership and quantized values from sorted-magnitude space back to
    # index space, then one np.nonzero walks every block's set in index order.
    ms = sel.m.cpu().numpy().astype(np.int64)
    order64 = sel.order.cpu().numpy().astype(np.int64)
    keep = np.arange(d)[None, :] < ms[:, None]            # sorted-mag space
    mask = np.zeros((n, d), bool)
    np.put_along_axis(mask, order64, keep, axis=1)
    q_idx_space = np.zeros((n, d), np.int32)
    np.put_along_axis(q_idx_space, order64, sel.q_sorted.cpu().numpy(), axis=1)
    rows, cols = np.nonzero(mask)                          # row-major: ascending
    idx_all = cols.astype(np.int32)
    q_all = q_idx_space[rows, cols].astype(np.int64)
    bounds = np.zeros(n + 1, np.int64)
    np.cumsum(mask.sum(axis=1), out=bounds[1:])
    errs = np.linalg.norm(x - out, axis=1)

    codes: list[GAEBlockCode] = []
    ms_list = ms.tolist()
    bounds_list = bounds.tolist()
    for i in range(n):
        m = ms_list[i]
        bin_exp = 0
        b = bin_size
        idx = idx_all[bounds_list[i]:bounds_list[i + 1]]
        q = q_all[bounds_list[i]:bounds_list[i + 1]]
        err = errs[i]
        # verify & repair (numerical safety + coarse-bin fallback)
        while err > tau and bin_exp < max_refine:
            if m < d:
                m = min(d, m + max(1, d // 32))
            else:
                bin_exp += 1
                b = bin_size / (2 ** bin_exp)
            c = u.T @ (x[i] - x_r[i])
            order = np.argsort(-np.square(c))
            idx = np.sort(order[:m]).astype(np.int32)
            q = np.round(c[idx] / b).astype(np.int64)
            rec = x_r[i] + u[:, idx] @ (q.astype(np.float32) * b)
            err = float(np.linalg.norm(x[i] - rec))
            out[i] = rec
        if err > tau:
            raise GuaranteeUnsatisfiable(block=i, err=err, tau=tau,
                                         max_refine=max_refine)
        codes.append(GAEBlockCode(m, idx, q, bin_exp))
    return out, codes


def gae_decode_blocks(x_r: np.ndarray, basis: np.ndarray, codes: list[GAEBlockCode],
                      bin_size: float) -> np.ndarray:
    """Inverse of gae_encode_blocks given the AE reconstruction x^R (numpy).

    All blocks' dequantized coefficients scatter into one dense (N, D) matrix
    (index sets are unique per block) and the correction is one
    ``@ basis.T`` matmul.
    """
    u = np.asarray(basis, np.float32)
    out = np.asarray(x_r, np.float32).copy()
    if not codes:
        return out
    ms = np.fromiter((c.m for c in codes), np.int64, len(codes))
    if not ms.sum():
        return out
    rows = np.repeat(np.arange(len(codes)), ms)
    cols = np.concatenate([c.indices for c in codes]).astype(np.int64)
    qs = np.concatenate([c.qcoeffs for c in codes]).astype(np.float32)
    binexps = np.fromiter((c.bin_exp for c in codes), np.int64, len(codes))
    b_vals = (bin_size / np.exp2(binexps.astype(np.float64)))[rows]
    coeffs = np.zeros(out.shape, np.float32)
    coeffs[rows, cols] = qs * b_vals.astype(np.float32)
    out += coeffs @ u.T
    return out
