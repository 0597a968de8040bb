"""Mamba-2 chunked SSD scan with an fp32 state carried across chunks.

Replaces the TPU kernel ``_ssd_kernel`` (``ssd_scan_fwd``,
``src/repro/kernels/ssd_scan/kernel.py``).  The CUDA kernel is
``csrc/ssd_scan.cu``; its note says what bounds it and how.

``ssd`` takes the plain version for CPU tensors and launches the kernel for
CUDA tensors; ``launches`` counts kernel launches only, one per call (a
call's four CUDA kernels are one launch of the op).  A sequence length that
is not a multiple of the chunk is handled as a dt = 0 tail, which is an
exact no-op (decay exp(0) = 1, input x * 0 = 0): the plain version pads, the
kernel masks its loads.

The plain version runs in the four phases of the chunk-parallel form, one
function each: ``chunk_cumsum``, ``chunk_state``, ``state_passing`` and
``chunk_scan``.  The kernel's CUDA kernels follow them: ``ssd_cb_kernel``
(C.B^T, the first product of ``chunk_scan``), ``ssd_chunk_state_kernel``
(``chunk_cumsum`` and ``chunk_state``), ``ssd_state_passing_kernel`` and
``ssd_chunk_scan_kernel``; ``ssd_phases`` returns what each left behind.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

Tensor = torch.Tensor

launches = build.LaunchCounter()

MAX_N = 128                     # the state size the kernel is built for
_MAX_SMEM = 232448              # bytes of shared memory a block may use on Hopper


def chunk_cumsum(dt: Tensor, a_log: Tensor, *, q: int) -> Tensor:
    """Phase 1.  dt: (B,S,H) with S a multiple of q -> cum (B,nc,Q,H), the
    inclusive cumsum of dt * A within each chunk, A = -exp(a_log)."""
    bsz, s, h = dt.shape
    a = -torch.exp(a_log.to(torch.float32))                   # (H,) negative
    return torch.cumsum((dt.to(torch.float32) * a).reshape(bsz, s // q, q, h),
                        dim=2)


def _xdt(x: Tensor, dt: Tensor, cum: Tensor) -> Tensor:
    """x * dt in fp32, as (B,nc,Q,H,P)."""
    xdt = x.to(torch.float32) * dt.to(torch.float32)[..., None]
    return xdt.reshape(*cum.shape, x.shape[-1])


def _heads(m: Tensor, cum: Tensor) -> Tensor:
    """A group operand (b or c, (B,S,G,N)) broadcast over the heads of its
    group, as (B,nc,Q,H,N) fp32."""
    bsz, nc, q, h = cum.shape
    g, n = m.shape[2], m.shape[3]
    return m.reshape(bsz, nc, q, g, n).repeat_interleave(
        h // g, dim=3).to(torch.float32)


def chunk_state(x: Tensor, dt: Tensor, b: Tensor, cum: Tensor) -> Tensor:
    """Phase 2.  Each chunk's own contribution to the state, as if it started
    from 0: sum_t exp(cum_last - cum_t) (x dt)_t b_t^T -> (B,nc,H,P,N)."""
    xc, bc = _xdt(x, dt, cum), _heads(b, cum)
    edge = torch.exp(cum[:, :, -1:, :] - cum)                 # (B,nc,Q,H)
    return torch.einsum("bcth,bcthn,bcthp->bchpn", edge, bc, xc)


def state_passing(cstate: Tensor, cum: Tensor) -> tuple[Tensor, Tensor]:
    """Phase 3.  The inter-chunk recurrence: returns the state entering each
    chunk (B,nc,H,P,N) and the final state (B,H,P,N)."""
    bsz, nc, h, p, n = cstate.shape
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # (B,nc,H)
    carry = torch.zeros(bsz, h, p, n, dtype=torch.float32, device=cstate.device)
    h_in = []
    for ci in range(nc):                                      # emit INCOMING state
        h_in.append(carry)
        carry = carry * chunk_decay[:, ci, :, None, None] + cstate[:, ci]
    return torch.stack(h_in, dim=1), carry


def chunk_scan(x: Tensor, dt: Tensor, b: Tensor, c: Tensor, cum: Tensor,
               h_in: Tensor) -> Tensor:
    """Phase 4.  y (B,S,H,P) fp32: the causal intra-chunk product plus the
    incoming state read through C."""
    bsz, nc, q, h = cum.shape
    xc, bc, cc = _xdt(x, dt, cum), _heads(b, cum), _heads(c, cum)
    # intra-chunk: decay(s, t) = exp(cum_s - cum_t) for t <= s.  The mask
    # goes in before the exp (exp(-inf) = 0, the same forward values as
    # ref.py's where after it): above the diagonal cum_s - cum_t is large
    # and positive, its exp overflows to inf, and a where after the exp
    # would make the gradient 0 * inf = nan
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (B,nc,Q,Q,H)
    mask = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                                  torch.full_like(diff, -torch.inf)))
    scores = torch.einsum("bcshn,bcthn->bcsth", cc, bc) * decay
    y = torch.einsum("bcsth,bcthp->bcshp", scores, xc)
    y_inter = torch.einsum("bcsh,bcshn,bchpn->bcshp", torch.exp(cum), cc, h_in)
    return (y + y_inter).reshape(bsz, nc * q, h, x.shape[-1])


def pad_to_chunks(x: Tensor, dt: Tensor, b: Tensor, c: Tensor, q: int):
    """x, dt, b, c with the sequence padded to a multiple of q with zeros (a
    dt = 0 tail, an exact no-op)."""
    pad = -x.shape[1] % q
    if not pad:
        return x, dt, b, c
    return (F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)),
            F.pad(b, (0, 0, 0, 0, 0, pad)), F.pad(c, (0, 0, 0, 0, 0, pad)))


def ssd_plain(x: Tensor, dt: Tensor, a_log: Tensor, b: Tensor, c: Tensor, *,
              chunk: int) -> tuple[Tensor, Tensor]:
    """x: (B,S,H,P)  dt: (B,S,H)  a_log: (H,) [A = -exp(a_log)]
    b, c: (B,S,G,N) with G groups broadcast over heads.
    Returns (y (B,S,H,P), final_state (B,H,P,N) fp32); follows ``ref.py``,
    in the four phases the kernel runs."""
    s_in = x.shape[1]
    q = min(chunk, s_in)
    x, dt, b, c = pad_to_chunks(x, dt, b, c, q)
    cum = chunk_cumsum(dt, a_log, q=q)
    h_in, final = state_passing(chunk_state(x, dt, b, cum), cum)
    y = chunk_scan(x, dt, b, c, cum, h_in)[:, :s_in]
    return y.to(x.dtype), final


def ssd_backward_plain(x: Tensor, dt: Tensor, a_log: Tensor, b: Tensor,
                       c: Tensor, d_y: Tensor, d_state: Tensor, *,
                       chunk: int) -> tuple[Tensor, ...]:
    """Gradients of ``(x, dt, a_log, b, c)`` for the gradients of y and of
    the final state: ``ssd_plain`` recomputed and differentiated."""
    ins = [t.detach().requires_grad_() for t in (x, dt, a_log, b, c)]
    with torch.enable_grad():
        outs = ssd_plain(*ins, chunk=chunk)
    return torch.autograd.grad(outs, ins, (d_y, d_state))


def _declare(lib: ctypes.CDLL) -> None:
    lib.ssd_scan_fwd.argtypes = [ctypes.c_void_p] * 11 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.ssd_scan_fwd.restype = ctypes.c_int
    lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.ssd_scan_smem_bytes.restype = ctypes.c_size_t


class Phases(NamedTuple):
    """What the kernel's four phases leave on the card, in the plain phase
    functions' layouts (``cstate`` and ``h_in`` are views of (B,nc,H,N,P)
    buffers)."""
    cb: Tensor          # (B,G,nc,Q,Q): C.B^T, written on and below the
    #                     diagonal 64 x 64 tiles only
    cum: Tensor         # (B,nc,Q,H)
    cstate: Tensor      # (B,nc,H,P,N)
    h_in: Tensor        # (B,nc,H,P,N)
    y: Tensor           # (B,S,H,P)
    state: Tensor       # (B,H,P,N)


def ssd_phases(x: Tensor, dt: Tensor, a_log: Tensor, b: Tensor, c: Tensor, *,
               chunk: int) -> Phases:
    """Launch the kernel (one launch of the op, four CUDA kernels) on CUDA
    tensors and return its phases' outputs."""
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
    q = max(1, min(chunk, s))
    nc = -(-s // q)
    dev = x.device

    def empty(*shape):
        return torch.empty(*shape, dtype=torch.float32, device=dev)

    cb, cum = empty(bsz, g, nc, q, q), empty(bsz, nc, q, h)
    cstate, h_in = empty(bsz, nc, h, n, p), empty(bsz, nc, h, n, p)
    y, state = torch.empty_like(x), empty(bsz, h, p, n)
    if x.numel() == 0:
        state.zero_()
    else:
        lib = build.library("ssd_scan", _declare)
        smem = lib.ssd_scan_smem_bytes(n, q)
        if smem > _MAX_SMEM:
            raise ValueError(f"ssd: chunk {q} needs {smem} bytes of shared "
                             f"memory, more than {_MAX_SMEM}")
        with torch.cuda.device(dev):
            status = lib.ssd_scan_fwd(
                x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
                c.data_ptr(), cb.data_ptr(), cum.data_ptr(),
                cstate.data_ptr(), h_in.data_ptr(), y.data_ptr(),
                state.data_ptr(), bsz, s, h, p, g, n, q,
                build.stream_ptr(dev))
        build.check(status, "ssd_scan_fwd")
        launches.add()
    return Phases(cb, cum, cstate.transpose(-1, -2), h_in.transpose(-1, -2),
                  y, state)


def ssd(x: Tensor, dt: Tensor, a_log: Tensor, b: Tensor, c: Tensor, *,
        chunk: int) -> tuple[Tensor, Tensor]:
    """x: (B,S,H,P)  dt: (B,S,H)  a_log: (H,)  b,c: (B,S,G,N).
    Returns (y (B,S,H,P), final_state (B,H,P,N) fp32)."""
    if x.device.type == "cpu":
        return ssd_plain(x, dt, a_log, b, c, chunk=chunk)
    return _Ssd.apply(x, dt, a_log, b, c, chunk)


class _Ssd(torch.autograd.Function):
    """The kernel's launch; the backward differentiates ``ssd_plain``."""

    @staticmethod
    def forward(ctx, x: Tensor, dt: Tensor, a_log: Tensor, b: Tensor,
                c: Tensor, chunk: int) -> tuple[Tensor, Tensor]:
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, a_log, b, c)
        # As the TPU kernel does (src/repro/kernels/ssd_scan/kernel.py:40-44,
        # :72): any input dtype is read as fp32, y comes back in x's dtype
        # and the final state stays fp32.  The CUDA kernels take fp32, so a
        # bf16 x, b or c is cast here before the launch.
        out = ssd_phases(*(t.float() for t in (x, dt, a_log, b, c)),
                         chunk=chunk)
        return out.y.to(x.dtype), out.state

    @staticmethod
    def backward(ctx, d_y: Tensor, d_state: Tensor):
        return (*ssd_backward_plain(*ctx.saved_tensors, d_y, d_state,
                                    chunk=ctx.chunk), None)


def phase_pairs(x: Tensor, dt: Tensor, a_log: Tensor, b: Tensor, c: Tensor, *,
                chunk: int) -> list[tuple[str, Tensor, Tensor]]:
    """Each CUDA kernel's output beside its plain phase computed from the
    kernel's own inputs, as ``(name, kernel, plain)``, for the checks on the
    card: a mismatch names the phase.  One launch of the op."""
    k = ssd_phases(x, dt, a_log, b, c, chunk=chunk)
    bsz, nc, q, _ = k.cum.shape
    g = b.shape[2]
    xp, dtp, bp, cp = pad_to_chunks(x, dt, b, c, q)
    cb = torch.einsum("bcsgn,bctgn->bgcst", cp.reshape(bsz, nc, q, g, -1),
                      bp.reshape(bsz, nc, q, g, -1))
    # the kernel writes C.B^T only in the 64 x 64 tiles on and below the
    # diagonal; the scan reads it where t <= s
    tril = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    h_in, final = state_passing(k.cstate, k.cum)
    return [
        ("ssd_cb_kernel: C.B^T", k.cb[..., tril], cb[..., tril]),
        ("ssd_chunk_state_kernel: chunk_cumsum", k.cum,
         chunk_cumsum(dtp, a_log, q=q)),
        ("ssd_chunk_state_kernel: chunk_state", k.cstate,
         chunk_state(xp, dtp, bp, k.cum)),
        ("ssd_state_passing_kernel: h_in", k.h_in, h_in),
        ("ssd_state_passing_kernel: final state", k.state, final),
        ("ssd_chunk_scan_kernel: chunk_scan", k.y,
         chunk_scan(xp, dtp, bp, cp, k.cum, k.h_in)[:, :x.shape[1]]),
    ]
