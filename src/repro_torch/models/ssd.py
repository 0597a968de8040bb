"""Mamba-2 (SSD — state-space duality) blocks, attention-free, in PyTorch.

The SSD layer computes  y_s = sum_{t<=s} C_s^T B_t (dt_t x_t) exp(cum_s-cum_t)
with per-head scalar decay A.  Prefill uses the chunked form through the
``ssd_scan`` wrapper (the kernel on CUDA, its plain version on the CPU);
``ssd_ref`` is the model's own oracle, the chunked plain version.

Decode is a single state update: h = exp(A dt) h + B (dt x); y = C.h + D x.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.common import (apply_stack, compute_dtype, embed,
                                       lecun_init, randn, rmsnorm,
                                       rmsnorm_init, uniform)

Tensor = torch.Tensor

# the model's oracle: the chunked scan in plain PyTorch (ref.py's math, with
# a dt = 0 tail for a ragged length)
ssd_ref = ssd_ops.ssd_plain


def _dims(cfg: ModelConfig) -> dict:
    d_inner = cfg.expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_headdim
    return {"d_inner": d_inner, "H": n_heads, "P": cfg.ssm_headdim,
            "N": cfg.ssm_state, "G": cfg.ssm_ngroups,
            "conv_ch": d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state}


def ssd_decode_step(h: Tensor, x: Tensor, dt: Tensor, a_log: Tensor, b: Tensor,
                    c: Tensor) -> tuple[Tensor, Tensor]:
    """One-token update. h: (B,H,P,N); x: (B,H,P); dt: (B,H); b,c: (B,G,N)."""
    rep = h.shape[1] // b.shape[1]
    bf = b.to(torch.float32).repeat_interleave(rep, dim=1)      # (B,H,N)
    cf = c.to(torch.float32).repeat_interleave(rep, dim=1)
    a = -torch.exp(a_log.to(torch.float32))
    decay = torch.exp(dt.to(torch.float32) * a)                 # (B,H)
    xdt = x.to(torch.float32) * dt.to(torch.float32)[..., None]
    h_new = h * decay[:, :, None, None] + torch.einsum("bhp,bhn->bhpn", xdt, bf)
    y = torch.einsum("bhpn,bhn->bhp", h_new, cf)
    return y.to(x.dtype), h_new


# ---------------------------------------------------------------------------
# block
# ---------------------------------------------------------------------------

def _split_proj(cfg: ModelConfig, proj: Tensor):
    dm = _dims(cfg)
    di, gn = dm["d_inner"], dm["G"] * dm["N"]
    z = proj[..., :di]
    xin = proj[..., di:2 * di]
    b = proj[..., 2 * di:2 * di + gn]
    c = proj[..., 2 * di + gn:2 * di + 2 * gn]
    dt = proj[..., 2 * di + 2 * gn:]
    return z, xin, b, c, dt


def _gated_out(p: dict, cfg: ModelConfig, x: Tensor, y: Tensor,
               xs: Tensor, z: Tensor) -> Tensor:
    """y + D x, gated rmsnorm with silu(z), out_proj, residual."""
    di = _dims(cfg)["d_inner"]
    y = y + xs * p["ssd"]["D"].to(x.dtype)[:, None]
    y = y.reshape(*x.shape[:-1], di)
    y = rmsnorm({"scale": p["ssd"]["norm_scale"]}, y * F.silu(z), cfg.norm_eps)
    return x + y @ p["ssd"]["out_proj"].to(x.dtype)


def _block_forward(p: dict, cfg: ModelConfig, x: Tensor) -> Tensor:
    dm = _dims(cfg)
    dt_ = x.dtype
    bsz, s = x.shape[0], x.shape[1]
    h = rmsnorm(p["ln"], x, cfg.norm_eps)
    proj = h @ p["ssd"]["in_proj"].to(dt_)
    z, xin, b, c, dtp = _split_proj(cfg, proj)
    # causal conv + silu over [x, B, C]
    conv_in = torch.cat([xin, b, c], dim=-1)
    cw = cfg.conv_width
    padded = F.pad(conv_in, (0, 0, cw - 1, 0))
    conv = sum(padded[:, i:i + s] * p["ssd"]["conv_w"][i].to(dt_)
               for i in range(cw)) + p["ssd"]["conv_b"].to(dt_)
    conv = F.silu(conv)
    di, gn = dm["d_inner"], dm["G"] * dm["N"]
    xs = conv[..., :di].reshape(bsz, s, dm["H"], dm["P"]).contiguous()
    bs = conv[..., di:di + gn].reshape(bsz, s, dm["G"], dm["N"]).contiguous()
    cs = conv[..., di + gn:].reshape(bsz, s, dm["G"], dm["N"]).contiguous()
    dt_act = F.softplus(dtp.to(torch.float32) + p["ssd"]["dt_bias"]).contiguous()
    y, _ = ssd_ops.ssd(xs, dt_act, p["ssd"]["A_log"], bs, cs,
                       chunk=cfg.ssm_chunk)
    return _gated_out(p, cfg, x, y, xs, z)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, run: RunConfig, generator: torch.Generator,
                device) -> dict:
    """Seeded random params with the JAX init's shapes and scales (not its
    numbers), drawn on the generator's device and moved to ``device``."""
    dm = _dims(cfg)
    vocab = cfg.padded_vocab(run.tp)
    lead = (cfg.n_layers,)
    proj_out = dm["d_inner"] * 2 + 2 * dm["G"] * dm["N"] + dm["H"]
    g = generator
    ssd = {
        "in_proj": lecun_init(g, (*lead, cfg.d_model, proj_out), device),
        "conv_w": lecun_init(g, (*lead, cfg.conv_width, dm["conv_ch"]), device,
                             fan_in=cfg.conv_width),
        "conv_b": torch.zeros(*lead, dm["conv_ch"], device=device),
        "A_log": torch.log(uniform(g, (*lead, dm["H"]), 1.0, 16.0, device)),
        "dt_bias": torch.log(torch.expm1(
            uniform(g, (*lead, dm["H"]), 1e-3, 1e-1, device))),
        "D": torch.ones(*lead, dm["H"], device=device),
        "norm_scale": torch.ones(*lead, dm["d_inner"], device=device),
        "out_proj": lecun_init(g, (*lead, dm["d_inner"], cfg.d_model), device,
                               fan_in=dm["d_inner"]),
    }
    return {"embed": {"w": randn(g, (vocab, cfg.d_model), device) * 0.02},
            "final_norm": rmsnorm_init(cfg.d_model, device),
            "unembed": {"w": lecun_init(g, (cfg.d_model, vocab), device)},
            "layers": {"ln": rmsnorm_init(cfg.d_model, device, lead),
                       "ssd": ssd}}


def _logits(params: dict, cfg: ModelConfig, run: RunConfig, x: Tensor) -> Tensor:
    logits = x @ params["unembed"]["w"].to(x.dtype)
    if cfg.padded_vocab(run.tp) != cfg.vocab:
        keep = torch.arange(logits.shape[-1], device=x.device) < cfg.vocab
        logits = logits + torch.where(keep, 0.0, -1e30).to(x.dtype)
    return logits


def forward(params: dict, cfg: ModelConfig, run: RunConfig,
            tokens: Tensor) -> Tensor:
    """tokens (B, S) -> logits (B, S, padded_vocab)."""
    x = embed(params["embed"], tokens).to(compute_dtype(run))
    x = apply_stack(lambda h, lp: _block_forward(lp, cfg, h), x,
                    params["layers"])
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, run, x)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

class SsdState(NamedTuple):
    conv_buf: Tensor   # (..., B, cw-1, conv_ch)
    h: Tensor          # (..., B, H, P, N) fp32


class DecodeState(NamedTuple):
    layers: SsdState   # stacked over the leading layer axis
    pos: int


def init_decode_state(params: dict, cfg: ModelConfig, run: RunConfig,
                      batch: int, max_len: int) -> DecodeState:
    del max_len
    dm = _dims(cfg)
    device = params["embed"]["w"].device
    n = cfg.n_layers
    st = SsdState(
        conv_buf=torch.zeros(n, batch, cfg.conv_width - 1, dm["conv_ch"],
                             dtype=compute_dtype(run), device=device),
        h=torch.zeros(n, batch, dm["H"], dm["P"], dm["N"], dtype=torch.float32,
                      device=device))
    return DecodeState(layers=st, pos=0)


def decode_step(params: dict, cfg: ModelConfig, run: RunConfig, token: Tensor,
                state: DecodeState) -> tuple[Tensor, DecodeState]:
    """token (B, 1) int -> (logits (B, 1, V), new state).  The layer states
    are updated in place; the returned state shares their tensors."""
    dm = _dims(cfg)
    dt = compute_dtype(run)
    x = embed(params["embed"], token).to(dt)

    def body(h, sl):
        lp, conv_buf, hs = sl["p"], sl["conv_buf"], sl["h"]
        z0 = rmsnorm(lp["ln"], h, cfg.norm_eps)
        proj = z0 @ lp["ssd"]["in_proj"].to(dt)
        z, xin, b, c, dtp = _split_proj(cfg, proj)
        conv_in = torch.cat([xin, b, c], dim=-1)[:, 0]           # (B, conv_ch)
        hist = torch.cat([conv_buf, conv_in[:, None]], dim=1)
        conv = sum(hist[:, i] * lp["ssd"]["conv_w"][i].to(dt)
                   for i in range(cfg.conv_width)) + lp["ssd"]["conv_b"].to(dt)
        conv = F.silu(conv)
        di, gn = dm["d_inner"], dm["G"] * dm["N"]
        xs = conv[:, :di].reshape(-1, dm["H"], dm["P"])
        bs = conv[:, di:di + gn].reshape(-1, dm["G"], dm["N"])
        cs = conv[:, di + gn:].reshape(-1, dm["G"], dm["N"])
        dt_act = F.softplus(dtp[:, 0].to(torch.float32) + lp["ssd"]["dt_bias"])
        y, h_new = ssd_decode_step(hs, xs, dt_act, lp["ssd"]["A_log"], bs, cs)
        conv_buf.copy_(hist[:, 1:])
        hs.copy_(h_new)
        return _gated_out(lp, cfg, h, y.reshape(-1, 1, dm["H"], dm["P"]),
                          xs[:, None], z)

    st = state.layers
    x = apply_stack(body, x, {"p": params["layers"], "conv_buf": st.conv_buf,
                              "h": st.h})
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, run, x), DecodeState(layers=st,
                                                     pos=state.pos + 1)
