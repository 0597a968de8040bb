"""Training loops for the compressor (paper Sec. III-C), in PyTorch.

The HBAE is trained first, then the BAE on the HBAE residuals (stacked BAE
stages for the StackAE ablation).  MSE loss, Adam lr=1e-3 as in the paper,
with the JAX package's minibatch order: ``_minibatches`` draws from
``np.random.default_rng(seed)`` exactly as ``repro.core.training`` does.

The data goes to the device once, and so do all the minibatches' indices;
each step gathers its batch on the device.  The loop waits on the device
only where ``log`` reads a loss (every 50 HBAE steps, every 100 BAE steps).
On a card, every HBAE step runs the block_attention kernel in its forward
(``enc_attn`` and ``dec_attn``) and its plain backward.

Initial weights come from a ``torch.Generator`` on the CPU and are moved to
the device.  The returned params are detached: ``requires_grad`` is off.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.core import bae as bae_mod
from repro_torch.core import exec as exec_mod
from repro_torch.core import hbae as hbae_mod
from repro_torch.train import optim as optim_mod

Tensor = torch.Tensor
Data = Union[np.ndarray, Tensor]


def _minibatches(rng: np.random.Generator, n: int, batch: int, epochs: int):
    for _ in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n - batch + 1, batch):
            yield order[i:i + batch]


def _value_and_grad(loss_fn: Callable, params: dict, x: Tensor
                    ) -> tuple[Tensor, dict]:
    leaves = [p.requires_grad_() for p in optim_mod.tree_leaves(params)]
    loss = loss_fn(params, x)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), optim_mod.tree_unflatten(params, grads)


def _fit(init: Callable[[torch.Generator], dict], step_fn: Callable,
         gen: torch.Generator, data: Data, *, epochs: int, batch: int,
         lr: float, seed: int, every: int,
         log: Optional[Callable[[int, float], None]], device) -> dict:
    """The loop both trainers share: init on the CPU, move, Adam over the
    minibatches of ``_minibatches(default_rng(seed))``."""
    device = exec_mod.resolve_device(device)
    data = (data.to(device) if isinstance(data, Tensor)
            else exec_mod.upload(data, device))
    params = optim_mod.tree_map(lambda t: t.to(device), init(gen))
    opt = optim_mod.adam(lr=lr)
    opt_state = opt.init(params)
    n = data.shape[0]
    order = list(_minibatches(np.random.default_rng(seed), n, min(batch, n),
                              epochs))
    if order:
        idx = torch.from_numpy(np.stack(order)).to(device)
        for step in range(len(order)):
            params, opt_state, loss = step_fn(params, opt_state,
                                              data[idx[step]], opt)
            if log is not None and step % every == 0:
                log(step, float(loss))
    for p in optim_mod.tree_leaves(params):
        p.requires_grad_(False)
    return params


# ---------------------------------------------------------------------------
# HBAE
# ---------------------------------------------------------------------------

def hbae_loss(params: dict, x: Tensor) -> Tensor:
    y, _ = hbae_mod.hbae_apply(params, x)
    return torch.mean(torch.square(y - x))


def _hbae_step(params, opt_state, x, opt):
    loss, grads = _value_and_grad(hbae_loss, params, x)
    params, opt_state, _ = opt.update(grads, opt_state, params)
    return params, opt_state, loss


def train_hbae(gen: torch.Generator, hyperblocks: Data, *, emb: int = 128,
               hidden: int = 256, latent: int = 128, heads: int = 1,
               use_attention: bool = True, epochs: int = 30, batch: int = 64,
               lr: float = 1e-3, seed: int = 0,
               log: Optional[Callable[[int, float], None]] = None,
               device=None) -> dict:
    _, k, d = hyperblocks.shape
    return _fit(lambda g: hbae_mod.hbae_init(
                    g, in_dim=d, k=k, emb=emb, hidden=hidden, latent=latent,
                    heads=heads, use_attention=use_attention),
                _hbae_step, gen, hyperblocks, epochs=epochs, batch=batch,
                lr=lr, seed=seed, every=50, log=log, device=device)


# ---------------------------------------------------------------------------
# BAE
# ---------------------------------------------------------------------------

def bae_loss(params: dict, residual: Tensor) -> Tensor:
    r_hat, _ = bae_mod.bae_apply(params, residual)
    return torch.mean(torch.square(r_hat - residual))


def _bae_step(params, opt_state, r, opt):
    loss, grads = _value_and_grad(bae_loss, params, r)
    params, opt_state, _ = opt.update(grads, opt_state, params)
    return params, opt_state, loss


def train_bae(gen: torch.Generator, residuals: Data, *, hidden: int = 256,
              latent: int = 16, epochs: int = 30, batch: int = 256,
              lr: float = 1e-3, seed: int = 0,
              log: Optional[Callable[[int, float], None]] = None,
              device=None) -> dict:
    d = residuals.shape[1]
    return _fit(lambda g: bae_mod.bae_init(g, in_dim=d, hidden=hidden,
                                           latent=latent),
                _bae_step, gen, residuals, epochs=epochs, batch=batch, lr=lr,
                seed=seed, every=100, log=log, device=device)
