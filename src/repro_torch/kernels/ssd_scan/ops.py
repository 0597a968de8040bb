"""Mamba-2 chunked SSD scan with an fp32 state carried across chunks.

Replaces the TPU kernel ``_ssd_kernel`` (``ssd_scan_fwd``,
``src/repro/kernels/ssd_scan/kernel.py``).  The CUDA kernel is
``csrc/ssd_scan.cu``; its note says what bounds it and how.

``ssd`` takes the plain version for CPU tensors and launches the kernel for
CUDA tensors; ``launches`` counts kernel launches only, one per call (a
call's two CUDA kernels, C.B^T and the scan, are one launch of the op).  A
sequence length that is not a multiple of the chunk is handled as a dt = 0
tail, which is an exact no-op (decay exp(0) = 1, input x * 0 = 0): the plain
version pads, the kernel masks its loads.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

Tensor = torch.Tensor

launches = build.LaunchCounter()

MAX_N = 128                     # the state size the kernel is built for
_MAX_SMEM = 232448              # bytes of shared memory a block may use on Hopper


def ssd_plain(x: Tensor, dt: Tensor, a_log: Tensor, b: Tensor, c: Tensor, *,
              chunk: int) -> tuple[Tensor, Tensor]:
    """x: (B,S,H,P)  dt: (B,S,H)  a_log: (H,) [A = -exp(a_log)]
    b, c: (B,S,G,N) with G groups broadcast over heads.
    Returns (y (B,S,H,P), final_state (B,H,P,N) fp32); follows ``ref.py``."""
    bsz, s_in, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    q = min(chunk, s_in)
    pad = -s_in % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    s = s_in + pad
    nc = s // q
    rep = h // g

    a = -torch.exp(a_log.to(torch.float32))                   # (H,) negative
    dt32 = dt.to(torch.float32)
    xdt = x.to(torch.float32) * dt32[..., None]
    cum = torch.cumsum((dt32 * a).reshape(bsz, nc, q, h), dim=2)   # (B,nc,Q,H)
    xc = xdt.reshape(bsz, nc, q, h, p)
    bc = b.reshape(bsz, nc, q, g, n).repeat_interleave(rep, dim=3).to(torch.float32)
    cc = c.reshape(bsz, nc, q, g, n).repeat_interleave(rep, dim=3).to(torch.float32)

    # intra-chunk: decay(s, t) = exp(cum_s - cum_t) for t <= s
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (B,nc,Q,Q,H)
    mask = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    decay = torch.where(mask[None, None, :, :, None], torch.exp(diff),
                        torch.zeros_like(diff))
    scores = torch.einsum("bcshn,bcthn->bcsth", cc, bc) * decay
    y = torch.einsum("bcsth,bcthp->bcshp", scores, xc)

    # chunk-boundary states and the inter-chunk recurrence
    edge = torch.exp(cum[:, :, -1:, :] - cum)                 # (B,nc,Q,H)
    cstate = torch.einsum("bcth,bcthn,bcthp->bchpn", edge, bc, xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # (B,nc,H)
    carry = torch.zeros(bsz, h, p, n, dtype=torch.float32, device=x.device)
    h_in = []
    for ci in range(nc):                                      # emit INCOMING state
        h_in.append(carry)
        carry = carry * chunk_decay[:, ci, :, None, None] + cstate[:, ci]
    h_in = torch.stack(h_in, dim=1)                           # (B,nc,H,P,N)

    y_inter = torch.einsum("bcsh,bcshn,bchpn->bcshp", torch.exp(cum), cc, h_in)
    y = (y + y_inter).reshape(bsz, s, h, p)[:, :s_in]
    return y.to(x.dtype), carry


def _declare(lib: ctypes.CDLL) -> None:
    lib.ssd_scan_fwd.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.ssd_scan_fwd.restype = ctypes.c_int
    lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.ssd_scan_smem_bytes.restype = ctypes.c_size_t


def ssd(x: Tensor, dt: Tensor, a_log: Tensor, b: Tensor, c: Tensor, *,
        chunk: int) -> tuple[Tensor, Tensor]:
    """x: (B,S,H,P)  dt: (B,S,H)  a_log: (H,)  b,c: (B,S,G,N).
    Returns (y (B,S,H,P), final_state (B,H,P,N) fp32)."""
    if x.device.type == "cpu":
        return ssd_plain(x, dt, a_log, b, c, chunk=chunk)
    ins = (x, dt, a_log, b, c)
    if x.device.type != "cuda" or any(t.device != x.device for t in ins):
        raise ValueError(f"ssd: inputs on {[str(t.device) for t in ins]}; "
                         f"the kernel takes one CUDA device")
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError(f"ssd: kernel takes float32 inputs, got "
                        f"{[t.dtype for t in ins]}")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("ssd: kernel takes contiguous inputs")
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if (dt.shape != (bsz, s, h) or a_log.shape != (h,) or g < 1 or h % g
            or b.shape != (bsz, s, g, n) or c.shape != b.shape):
        raise ValueError(f"ssd: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"a_log {tuple(a_log.shape)}, b {tuple(b.shape)}, "
                         f"c {tuple(c.shape)} disagree")
    if not 0 < n <= MAX_N:
        raise ValueError(f"ssd: kernel takes N <= {MAX_N}, got N={n}")
    if chunk < 1:
        raise ValueError(f"ssd: chunk {chunk} < 1")
    y = torch.empty_like(x)
    state = torch.empty(bsz, h, p, n, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return y, state.zero_()
    q = min(chunk, s)
    lib = build.library("ssd_scan", _declare)
    smem = lib.ssd_scan_smem_bytes(n, q)
    if smem > _MAX_SMEM:
        raise ValueError(f"ssd: chunk {q} needs {smem} bytes of shared memory, "
                         f"more than {_MAX_SMEM}")
    # C.B^T of every chunk, computed once per group and read by its heads
    cb = torch.empty(bsz, g, -(-s // q), q, q, dtype=torch.float32,
                     device=x.device)
    with torch.cuda.device(x.device):
        status = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
            c.data_ptr(), cb.data_ptr(), y.data_ptr(), state.data_ptr(), bsz,
            s, h, p, g, n, q, build.stream_ptr(x.device))
    build.check(status, "ssd_scan_fwd")
    launches.add()
    return y, state
