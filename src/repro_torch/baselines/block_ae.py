"""'Baseline' of the paper's ablation (Sec. III-D / Fig. 4-5), in PyTorch.

A block-based compressor that divides data into blocks and compresses each
block independently with cascaded fully-connected layers (GBAE-style [16]) —
no hyper-blocks, no attention, no residual stage.  Latents are quantized +
Huffman coded with the same bitstream machinery as the main pipeline so the
comparison isolates the architecture, not the entropy coder.

The JAX package's ``repro.baselines.block_ae`` on the port's modules: it
trains through ``train/optim.adam`` with the JAX package's minibatch order,
quantizes with ``core/quantization.py``, and its payload is the JAX
package's format.  It runs on the card unless ``device="cpu"`` is given.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Optional

import numpy as np
import torch

from repro_torch.baselines import codec as codec_mod
from repro_torch.core import entropy
from repro_torch.core import exec as exec_mod
from repro_torch.core.attention import linear, linear_init
from repro_torch.core.errors import MalformedStream
from repro_torch.core.quantization import dequantize, quantize
from repro_torch.train import optim as optim_mod

_MAGIC = b"BAE1"

Tensor = torch.Tensor


def block_ae_init(gen: torch.Generator, in_dim: int, hidden: int, latent: int,
                  depth: int = 2) -> dict:
    """Cascaded FC encoder/decoder: depth hidden layers each side."""
    dims = [in_dim] + [hidden] * depth + [latent]
    enc = [linear_init(gen, dims[i], dims[i + 1]) for i in range(len(dims) - 1)]
    dims_d = [latent] + [hidden] * depth + [in_dim]
    dec = [linear_init(gen, dims_d[i], dims_d[i + 1])
           for i in range(len(dims_d) - 1)]
    return {"enc": enc, "dec": dec}


def _cascade(layers: list, h: Tensor) -> Tensor:
    for i, p in enumerate(layers):
        h = linear(p, h)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def block_ae_encode(params: dict, x: Tensor) -> Tensor:
    return _cascade(params["enc"], x)


def block_ae_decode(params: dict, z: Tensor) -> Tensor:
    return _cascade(params["dec"], z)


def block_ae_apply(params: dict, x: Tensor) -> Tensor:
    return block_ae_decode(params, block_ae_encode(params, x))


def _loss(params, x):
    return torch.mean(torch.square(block_ae_apply(params, x) - x))


def _step(params, opt_state, x, opt):
    leaves = [p.requires_grad_() for p in optim_mod.tree_leaves(params)]
    loss = _loss(params, x)
    grads = optim_mod.tree_unflatten(params, torch.autograd.grad(loss, leaves))
    params, opt_state, _ = opt.update(grads, opt_state, params)
    return params, opt_state, loss.detach()


def _device_of(params: dict) -> torch.device:
    return params["enc"][0]["w"].device


@dataclasses.dataclass
class BlockAEBaseline:
    """fit/compress on (N, D) flattened blocks."""
    in_dim: int
    hidden: int = 256
    latent: int = 32
    depth: int = 2
    bin_size: float = 0.005
    epochs: int = 30
    batch: int = 256
    lr: float = 1e-3
    device: Optional[str] = None       # None: the card
    params: Optional[dict] = None

    def fit(self, blocks: np.ndarray, seed: int = 0) -> "BlockAEBaseline":
        n, d = blocks.shape
        if d != self.in_dim:
            raise ValueError(f"blocks of width {d}, model in_dim {self.in_dim}")
        device = exec_mod.resolve_device(self.device)
        gen = torch.Generator().manual_seed(seed)
        self.params = optim_mod.tree_map(
            lambda t: t.to(device),
            block_ae_init(gen, d, self.hidden, self.latent, self.depth))
        opt = optim_mod.adam(lr=self.lr)
        opt_state = opt.init(self.params)
        rng = np.random.default_rng(seed)
        data = exec_mod.upload(blocks, device)
        b = min(self.batch, n)
        for _ in range(self.epochs):
            order = torch.from_numpy(rng.permutation(n)).to(device)
            for i in range(0, n - b + 1, b):
                self.params, opt_state, _ = _step(self.params, opt_state,
                                                  data[order[i:i + b]], opt)
        for p in optim_mod.tree_leaves(self.params):
            p.requires_grad_(False)
        return self

    def compress(self, blocks: np.ndarray, quantize_latent: bool = True
                 ) -> tuple[np.ndarray, int]:
        """Returns (reconstruction, compressed_bytes)."""
        if quantize_latent:
            c = self.codec()
            enc = c.compress(blocks, self.bin_size)
            return c.decompress(enc), enc.nbytes
        with torch.inference_mode():
            z = block_ae_encode(self.params, exec_mod.upload(
                blocks, _device_of(self.params)))
            recon = block_ae_decode(self.params, z)
        return recon.cpu().numpy(), z.numel() * 4

    def codec(self) -> "BlockAECodec":
        """Unified-protocol view of this fitted baseline (model cost is
        carried by the codec object, like the main pipeline's weights)."""
        if self.params is None:
            raise ValueError("BlockAEBaseline.codec(): call fit() first")
        return BlockAECodec(baseline=self)


@dataclasses.dataclass(frozen=True)
class BlockAECodec:
    """``Codec``-protocol adapter over a fitted :class:`BlockAEBaseline`.

    ``bound`` is the latent quantization bin size; the payload ships the
    quantized latents (header + Huffman stream) and ``decompress`` runs
    dequantize + the decoder network — so it only decodes payloads produced
    with the SAME fitted weights.
    """
    baseline: BlockAEBaseline
    name: str = "block-ae"

    def compress(self, data: np.ndarray, bound: float) -> codec_mod.Encoded:
        bin_size = float(bound)
        if not bin_size > 0:
            raise ValueError(f"block-ae bin size must be > 0, got {bin_size}")
        params = self.baseline.params
        with torch.inference_mode():
            z = block_ae_encode(params, exec_mod.upload(data,
                                                        _device_of(params)))
            q = quantize(z, bin_size).cpu().numpy()
        from repro_torch.runtime import archive_io
        stream = entropy.huffman_compress(q.ravel()) if q.size else None
        head = _MAGIC + struct.pack("<QId", q.shape[0], q.shape[1], bin_size)
        return codec_mod.Encoded(
            codec=self.name, payload=head + archive_io._pack_stream(stream))

    def decompress(self, enc: codec_mod.Encoded) -> np.ndarray:
        from repro_torch.runtime import archive_io
        r = archive_io._Reader(enc.payload, "block-ae payload")
        if r.take(4) != _MAGIC:
            raise MalformedStream("block-ae payload: bad magic")
        n, latent, bin_size = struct.unpack("<QId", r.take(20))
        if latent != self.baseline.latent:
            raise MalformedStream(
                f"block-ae payload has latent dim {latent}, this codec's "
                f"model expects {self.baseline.latent}")
        if not bin_size > 0:
            raise MalformedStream(
                f"block-ae payload: bad bin size {bin_size}")
        stream = archive_io._unpack_stream(r)
        q = (entropy.huffman_decompress(stream) if stream is not None
             else np.zeros(0, np.int64))
        if q.size != n * latent:
            raise MalformedStream(
                f"block-ae stream has {q.size} latents, expected "
                f"{n * latent}")
        params = self.baseline.params
        with torch.inference_mode():
            z = dequantize(exec_mod.upload(q.reshape(n, latent),
                                           _device_of(params), np.int32),
                           bin_size)
            return block_ae_decode(params, z).cpu().numpy()
