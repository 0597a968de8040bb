"""Block-wise residual AutoEncoder (BAE) — paper Sec. II-C (Eqs. 7-8), in
PyTorch.

Operates on per-block residuals r_i = x_i - y_i from the HBAE.  Residual values
are small, so the paper applies layer normalization to rescale them before the
encoder; the decoder learns to emit the *unnormalized* residual, which is added
back onto y_i:

    L_b  = E(norm(x_i - y_i))          (Eq. 7)
    x^R  = D(L_b) + y_i                (Eq. 8)

Shapes: residuals are (B, in_dim) flattened blocks; latent (B, latent).
"""
from __future__ import annotations

import torch

from repro_torch.core.attention import layernorm, layernorm_init
from repro_torch.core.hbae import mlp2, mlp2_init

Tensor = torch.Tensor


def bae_init(gen: torch.Generator, *, in_dim: int, hidden: int = 256,
             latent: int = 16) -> dict:
    return {
        "ln": layernorm_init(in_dim),
        "enc": mlp2_init(gen, in_dim, hidden, latent),
        "dec": mlp2_init(gen, latent, hidden, in_dim),
    }


def bae_encode(params: dict, residual: Tensor) -> Tensor:
    return mlp2(params["enc"], layernorm(params["ln"], residual))


def bae_decode(params: dict, latent: Tensor) -> Tensor:
    return mlp2(params["dec"], latent)


def bae_apply(params: dict, residual: Tensor) -> tuple[Tensor, Tensor]:
    """Returns (reconstructed residual r_hat, latent L_b)."""
    latent = bae_encode(params, residual)
    return bae_decode(params, latent), latent
