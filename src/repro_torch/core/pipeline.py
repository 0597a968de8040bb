"""End-to-end compressor pipeline (paper Fig. 1), in PyTorch.

``HierarchicalCompressor`` ties together:
  hyper-block AE (coarse)  ->  block-wise residual AE(s) (fine)  ->
  GAE PCA post-processing (guaranteed per-block l2 bound)  ->
  quantization + Huffman + index-bitmask/zlib bitstream.

Its parameters come from ``fit`` (HBAE, then each BAE stage on the HBAE
residuals, with Adam; ``core/training.py``), ``init_params`` (seeded random
weights), ``load`` (a ``repro-compressor-v2`` manifest, as the JAX package's
``save`` writes it) or ``params_from_jax``.  Then ``fit_basis`` ->
``compress`` -> archive -> ``decompress``.

The device work (AE stages, GAE selection, both through the port's CUDA
kernels on a card) runs on ``device``; the entropy coders and the container
are host numpy, byte-identical to the JAX package's.  ``Archive.
compressed_bytes()`` is the honest storage cost (AE latents + GAE
coefficients + index sets + framing); model weights and the PCA basis are
excluded unless passed to ``compression_ratio``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import math
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.core import bae as bae_mod
from repro_torch.core import entropy, gae
from repro_torch.core import exec as exec_mod
from repro_torch.core import hbae as hbae_mod
from repro_torch.core import training
from repro_torch.core.errors import (ArchiveError, ChecksumMismatch, ChunkDamage,
                                     ConfigError, DamageReport,
                                     GuaranteeUnsatisfiable, MalformedStream)
from repro_torch.core.options import CompressOptions
from repro_torch.parallel import mesh_exec

@dataclasses.dataclass
class CompressorConfig:
    block_elems: int                 # flattened AE block size
    k: int                           # blocks per hyper-block
    emb: int = 128
    hidden: int = 256
    hb_latent: int = 128             # paper: 128 S3D / 64 E3SM,XGC
    bae_hidden: int = 256
    bae_latent: int = 16             # paper: 16 for all datasets
    heads: int = 1
    use_attention: bool = True       # False => 'HBAE-woa' ablation
    use_bae: bool = True             # False => 'HBAE' ablation
    n_bae_stages: int = 1            # 2 => 'StackAE' ablation
    hb_bin: float = 0.005
    bae_bin: float = 0.005
    gae_bin: float = 0.01
    gae_block_elems: Optional[int] = None   # GAE may re-block (paper Sec. II-D)
    epochs_hbae: int = 30
    epochs_bae: int = 30
    batch: int = 64
    lr: float = 1e-3


@dataclasses.dataclass
class ArchiveChunk:
    """One hyper-block stripe: every stream needed to decode hyper-blocks
    ``[hb_start, hb_start + n_hyperblocks)`` independently of other chunks.

    A non-empty ``verbatim_blob`` marks a QUARANTINED stripe: the payload is
    the deflate-packed raw float32 stripe itself — losslessly decodable,
    hence trivially within any tau — and all latent/GAE streams are absent
    (``hb_stream is None``).
    """
    hb_start: int
    n_hyperblocks: int
    hb_stream: Optional[entropy.HuffmanStream]
    bae_streams: list[entropy.HuffmanStream]
    gae_coeff_stream: Optional[entropy.HuffmanStream]
    gae_index_blob: bytes
    gae_binexp_blob: bytes
    verbatim_blob: bytes = b""


@dataclasses.dataclass
class Archive:
    """Compressed representation, striped into independently-decodable chunks.

    ``chunks`` entries may be ``None`` after a tolerant container read
    (``archive_io.read_archive(strict=False)``): the stripe failed its digest
    or framing checks and ``chunk_errors[i]`` holds the reason.
    """
    n_hyperblocks: int
    n_values: int                    # original float32 count
    chunk_hyperblocks: int           # stripe width (hyper-blocks per chunk)
    gae_dim: int                     # PCA basis dimension (0 = no GAE section)
    chunks: list[Optional[ArchiveChunk]]
    chunk_errors: dict[int, str] = dataclasses.field(default_factory=dict)
    _size_cache: Optional[int] = dataclasses.field(
        default=None, repr=False, compare=False)

    def verbatim_chunks(self) -> list[int]:
        """Indices of quarantined (lossless verbatim-fallback) chunks."""
        return [i for i, c in enumerate(self.chunks)
                if c is not None and c.verbatim_blob]

    def compressed_bytes(self) -> int:
        """Exact size of the serialized container, from the section framing
        arithmetic (no full serialize), cached; mutators must call
        ``invalidate_size_cache``."""
        if self._size_cache is None:
            from repro_torch.runtime import archive_io   # runtime owns the container
            self._size_cache = archive_io.serialized_size(self)
        return self._size_cache

    def invalidate_size_cache(self) -> None:
        self._size_cache = None

    def compression_ratio(self, include_model_bytes: int = 0) -> float:
        return (self.n_values * 4) / (self.compressed_bytes() + include_model_bytes)


@dataclasses.dataclass
class _VerbatimStripe:
    """Decoded form of a quarantined chunk: the raw hyper-blocks."""
    data: np.ndarray


MODEL_FORMAT = "repro-compressor-v2"


def _sha(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


# Static (non-array) param-tree leaves that the manifest records by class
# name + field dict.  The JAX package's classes of the same names are read
# the same way, which is how ``params_from_jax`` carries them across.
def _static_registry() -> dict:
    from repro_torch.core.attention import AttnMeta
    from repro_torch.core.hbae import HbaeMeta
    return {"AttnMeta": AttnMeta, "HbaeMeta": HbaeMeta}


def _flatten_params(obj, prefix: str, leaves: list, statics: dict) -> None:
    """Walk dict/list param trees into (path, numpy array) leaves; registered
    static dataclasses are recorded as JSON-able entries in ``statics``."""
    if isinstance(obj, dict):
        for key in sorted(obj):
            _flatten_params(obj[key], f"{prefix}/{key}" if prefix else key,
                            leaves, statics)
    elif isinstance(obj, (list, tuple)):
        for i, item in enumerate(obj):
            _flatten_params(item, f"{prefix}/{i}" if prefix else str(i),
                            leaves, statics)
    elif type(obj).__name__ in _static_registry():
        statics[prefix] = {"class": type(obj).__name__,
                           "fields": dataclasses.asdict(obj)}
    elif isinstance(obj, torch.Tensor):
        leaves.append((prefix, obj.detach().cpu().numpy()))
    elif hasattr(obj, "shape") and hasattr(obj, "dtype"):
        leaves.append((prefix, np.asarray(obj)))
    else:
        raise TypeError(f"cannot serialize param leaf {prefix!r} "
                        f"of type {type(obj).__name__}")


def _assemble_params(entries: list, statics: dict) -> dict:
    """Rebuild the nested dict tree from (path, value) pairs + statics."""
    registry = _static_registry()
    root: dict = {}
    items = list(entries)
    for path, spec in statics.items():
        if spec.get("class") not in registry:
            raise MalformedStream(f"unknown static class {spec.get('class')!r}")
        items.append((path, registry[spec["class"]](**spec["fields"])))
    for path, value in items:
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise MalformedStream(f"conflicting manifest paths at {path!r}")
        node[parts[-1]] = value
    return root


def _to_device(tree, device: torch.device):
    """numpy or tensor leaves -> tensors on ``device``; statics pass through."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree)).to(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def _params_from_tree(tree: dict, n_bae: int, device: torch.device
                      ) -> tuple[dict, list[dict]]:
    hbae_params = _to_device(tree.get("hbae"), device)
    bae = tree.get("bae", {})
    return hbae_params, [_to_device(bae[str(i)], device) for i in range(n_bae)]


def params_from_jax(hbae_tree: dict, bae_trees: list, device=None
                    ) -> tuple[dict, list[dict]]:
    """The JAX package's param trees (numpy leaves, as ``jax.device_get``
    returns them) as this package's ``(hbae_params, bae_params)`` on
    ``device``.  Paths, layouts and statics carry over unchanged."""
    leaves: list[tuple[str, np.ndarray]] = []
    statics: dict[str, dict] = {}
    _flatten_params({"hbae": hbae_tree, "bae": list(bae_trees)}, "", leaves,
                    statics)
    tree = _assemble_params(leaves, statics)
    return _params_from_tree(tree, len(bae_trees),
                             exec_mod.resolve_device(device))


class HierarchicalCompressor:
    """fit / compress / decompress on hyper-block-shaped data (N, k, D).

    ``device`` defaults to the card; without one, pass ``device="cpu"``.
    """

    def __init__(self, config: CompressorConfig, device=None):
        self.cfg = config
        self.device = exec_mod.resolve_device(device)
        self.hbae_params: Optional[dict] = None
        self.bae_params: list[dict] = []
        self.basis: Optional[np.ndarray] = None

    # -- parameters ----------------------------------------------------------
    def init_params(self, seed: int = 0) -> "HierarchicalCompressor":
        """Seeded random HBAE and BAE weights (untrained), drawn on the CPU
        from one ``torch.Generator`` and moved to the device."""
        cfg = self.cfg
        gen = torch.Generator().manual_seed(seed)
        hbae = hbae_mod.hbae_init(
            gen, in_dim=cfg.block_elems, k=cfg.k, emb=cfg.emb,
            hidden=cfg.hidden, latent=cfg.hb_latent, heads=cfg.heads,
            use_attention=cfg.use_attention)
        baes = []
        if cfg.use_bae:
            baes = [bae_mod.bae_init(gen, in_dim=cfg.block_elems,
                                     hidden=cfg.bae_hidden,
                                     latent=cfg.bae_latent)
                    for _ in range(cfg.n_bae_stages)]
        self.hbae_params = _to_device(hbae, self.device)
        self.bae_params = [_to_device(p, self.device) for p in baes]
        return self

    # -- training ------------------------------------------------------------
    def fit(self, hyperblocks: np.ndarray, seed: int = 0,
            log: Optional[Callable[[int, float], None]] = None
            ) -> "HierarchicalCompressor":
        """Train the HBAE, then each BAE stage on the residuals of the
        unquantized HBAE forward, on the device.  Initial weights come from
        one ``torch.Generator(seed)``; minibatches follow the JAX package's
        ``seed`` (HBAE) and ``seed + s`` (BAE stage ``s``).  The stage
        counters ``hbae_train`` and ``bae_train`` time the two trainings."""
        cfg = self.cfg
        n, k, d = hyperblocks.shape
        if (k, d) != (cfg.k, cfg.block_elems):
            raise ValueError(f"hyper-blocks of shape {hyperblocks.shape} do "
                             f"not match k={cfg.k}, block_elems="
                             f"{cfg.block_elems}")
        gen = torch.Generator().manual_seed(seed)
        x = exec_mod.upload(hyperblocks, self.device)
        with exec_mod.stage("hbae_train", x.numel() * cfg.epochs_hbae):
            self.hbae_params = training.train_hbae(
                gen, x, emb=cfg.emb, hidden=cfg.hidden, latent=cfg.hb_latent,
                heads=cfg.heads, use_attention=cfg.use_attention,
                epochs=cfg.epochs_hbae, batch=cfg.batch, lr=cfg.lr, seed=seed,
                log=log, device=self.device)
            exec_mod.synchronize(self.device)
        self.bae_params = []
        if cfg.use_bae:
            with torch.no_grad():
                resid = (x - hbae_mod.hbae_apply(self.hbae_params, x)[0]
                         ).reshape(n * k, d)
            for s in range(cfg.n_bae_stages):
                with exec_mod.stage("bae_train", resid.numel() * cfg.epochs_bae):
                    p = training.train_bae(
                        gen, resid, hidden=cfg.bae_hidden,
                        latent=cfg.bae_latent, epochs=cfg.epochs_bae,
                        batch=max(cfg.batch * 4, 256), lr=cfg.lr,
                        seed=seed + s, log=log, device=self.device)
                    exec_mod.synchronize(self.device)
                self.bae_params.append(p)
                with torch.no_grad():
                    resid = resid - bae_mod.bae_apply(p, resid)[0]
        return self

    # -- forward helpers ----------------------------------------------------
    def _stage_params(self) -> list[dict]:
        return self.bae_params if self.cfg.use_bae else []

    def reconstruct_ae(self, hyperblocks: np.ndarray,
                       quantize_latents: bool = True) -> np.ndarray:
        """AE-only reconstruction (through quantized latents when requested)."""
        cfg = self.cfg
        if quantize_latents:
            # same front-end + decode back-end as ``compress``
            _, _, recon = exec_mod.run_compress_stage(
                self.hbae_params, self._stage_params(), hyperblocks,
                cfg.hb_bin, cfg.bae_bin)
            return recon
        return exec_mod.run_recon_stage(self.hbae_params, self._stage_params(),
                                        hyperblocks)

    def _resolve_mesh(self, mesh):
        """``mesh`` (anything ``parallel.mesh_exec.resolve_mesh`` takes) as a
        1-D ``Mesh`` of this compressor's device type, or ``None``."""
        return mesh_exec.resolve_mesh(mesh, device=self.device)

    # -- PCA basis -----------------------------------------------------------
    def fit_basis(self, hyperblocks: np.ndarray, mesh=None) -> np.ndarray:
        """PCA basis of AE residuals at GAE block granularity, fit on the
        device.

        With a ``mesh`` (anything ``parallel.mesh_exec.resolve_mesh``
        accepts) the D x D residual covariance is computed shard by shard
        on the mesh's devices and summed — O(D^2) traffic whatever N — by
        ``mesh_exec.fit_pca_basis_sharded``.
        """
        recon = self.reconstruct_ae(hyperblocks)
        resid = self._gae_view(hyperblocks - recon)
        resolved = self._resolve_mesh(mesh)
        if resolved is not None:
            self.basis = mesh_exec.fit_pca_basis_sharded(resid, resolved)
            return self.basis
        with torch.inference_mode():
            basis = gae.fit_pca_basis(exec_mod.upload(resid, self.device))
        self.basis = basis.cpu().numpy()
        return self.basis

    def _gae_view(self, blocks3d: np.ndarray) -> np.ndarray:
        """(N, k, D) -> (N_gae, D_gae): GAE may use a different block size."""
        d_gae = self.cfg.gae_block_elems or self.cfg.block_elems
        flat = blocks3d.reshape(-1)
        if flat.size % d_gae:
            raise ValueError(f"{flat.size} values do not tile GAE blocks "
                             f"of {d_gae}")
        return flat.reshape(-1, d_gae)

    def _gae_unview(self, gae_blocks: np.ndarray, shape3d: tuple) -> np.ndarray:
        return gae_blocks.reshape(shape3d)

    # -- compress / decompress ----------------------------------------------
    def _chunk_width(self, requested: int, with_gae: bool) -> int:
        """Stripe width in hyper-blocks, aligned so every chunk covers a whole
        number of GAE blocks (chunks must decode independently).  A
        non-positive request is a :class:`ConfigError`."""
        cfg = self.cfg
        width = int(requested)
        if width < 1:
            raise ConfigError(
                f"chunk_hyperblocks must be >= 1, got {requested!r} (a "
                f"zero-width stripe can never tile the hyper-block axis)")
        if with_gae:
            d_gae = cfg.gae_block_elems or cfg.block_elems
            per_hb = cfg.k * cfg.block_elems
            align = d_gae // math.gcd(d_gae, per_hb)   # chunk width multiple
            width = ((width + align - 1) // align) * align
        return width

    def stripe_spans(self, n_hyperblocks: int, chunk_hyperblocks: int,
                     with_gae: bool) -> list[tuple[int, int]]:
        """``[(hb_start, n_hb), ...]`` stripe tiling of ``n_hyperblocks`` at
        the GAE-aligned chunk width."""
        width = self._chunk_width(chunk_hyperblocks, with_gae=with_gae)
        return [(s, min(width, n_hyperblocks - s))
                for s in range(0, n_hyperblocks, width)]

    def encode_stripe_device(self, stripe: np.ndarray
                             ) -> tuple[np.ndarray, list[np.ndarray],
                                        np.ndarray]:
        """Device half of one stripe's encode: front-end + decode back-end
        on the stripe's hyper-blocks only."""
        return exec_mod.run_compress_stage(
            self.hbae_params, self._stage_params(), stripe,
            self.cfg.hb_bin, self.cfg.bae_bin)

    def encode_group_device(self, group, hyperblocks: np.ndarray, mesh
                            ) -> list[tuple]:
        """Device half of one shard GROUP's encode: ``len(group)``
        equal-width stripes, one a shard
        (``parallel.mesh_exec.plan_shard_groups`` guarantees the alignment).
        Returns per-stripe ``(q_lh, q_lbs, recon)`` tuples in span order —
        what ``encode_stripe_device`` gives for each stripe, so the host
        coders cannot tell the paths apart."""
        start, stop = mesh_exec.group_slice(group)
        return exec_mod.run_compress_stage_sharded(
            self.hbae_params, self._stage_params(), hyperblocks[start:stop],
            self.cfg.hb_bin, self.cfg.bae_bin, mesh)

    def encode_stripe_host(self, hb_start: int, stripe: np.ndarray,
                           q_lh: np.ndarray, q_lbs: list[np.ndarray],
                           recon: np.ndarray, tau: Optional[float],
                           gae_dim: int) -> ArchiveChunk:
        """Host half of one stripe's encode: GAE error-bound coding (its
        selection on the device) + chunk entropy coding, from the stripe's
        own data only."""
        cfg = self.cfg
        k, d = cfg.k, cfg.block_elems
        codes: list[gae.GAEBlockCode] = []
        if tau is not None:
            d_gae = cfg.gae_block_elems or d
            gae_per_hb = (k * d) // d_gae
            with exec_mod.stage("gae_encode", stripe.size):
                x_gae = self._gae_view(stripe)
                r_gae = self._gae_view(recon)
                try:
                    _, codes = gae.gae_encode_blocks(
                        x_gae, r_gae, self.basis, tau, cfg.gae_bin,
                        device=self.device)
                except GuaranteeUnsatisfiable as e:
                    # re-raise with the GLOBAL GAE block index so diagnostics
                    # are stripe-independent
                    raise GuaranteeUnsatisfiable(
                        block=hb_start * gae_per_hb + e.block, err=e.err,
                        tau=e.tau, max_refine=e.max_refine) from e
        with exec_mod.stage("entropy_encode", stripe.size):
            hb_stream = entropy.huffman_compress(q_lh)
            bae_streams = [entropy.huffman_compress(q_lb) for q_lb in q_lbs]
            coeff_stream = None
            index_blob = binexp_blob = b""
            if tau is not None:
                # GAEBlockCode stores indices/coefficients in ascending index
                # order — exactly the bitmask decode order
                all_coeffs, index_sets, binexps = [], [], []
                for c in codes:
                    index_sets.append(c.indices)
                    all_coeffs.append(c.qcoeffs)
                    binexps.append(c.bin_exp)
                coeffs = (np.concatenate(all_coeffs) if all_coeffs else
                          np.zeros(0, np.int64))
                if coeffs.size:
                    coeff_stream = entropy.huffman_compress(coeffs)
                index_blob = entropy.encode_index_sets(index_sets, gae_dim)
                binexp_blob = entropy.zlib_pack(
                    np.asarray(binexps, np.uint8).tobytes())
        return ArchiveChunk(
            hb_start=hb_start, n_hyperblocks=stripe.shape[0],
            hb_stream=hb_stream, bae_streams=bae_streams,
            gae_coeff_stream=coeff_stream, gae_index_blob=index_blob,
            gae_binexp_blob=binexp_blob)

    def encode_stripe_verbatim(self, hb_start: int,
                               stripe: np.ndarray) -> ArchiveChunk:
        """Guaranteed-bound fallback for a quarantined stripe: ship the raw
        float32 values (deflate-packed).  Lossless, so the per-block l2
        error is exactly 0 <= tau for any tau."""
        raw = np.ascontiguousarray(stripe, dtype="<f4").tobytes()
        return ArchiveChunk(
            hb_start=int(hb_start), n_hyperblocks=int(stripe.shape[0]),
            hb_stream=None, bae_streams=[], gae_coeff_stream=None,
            gae_index_blob=b"", gae_binexp_blob=b"",
            verbatim_blob=entropy.zlib_pack(raw))

    def decode_stripe_verbatim(self, chunk: ArchiveChunk) -> np.ndarray:
        """Inverse of ``encode_stripe_verbatim``; validates the payload size
        against the chunk's declared hyper-block range."""
        cfg = self.cfg
        raw = entropy.zlib_unpack(chunk.verbatim_blob)
        want = chunk.n_hyperblocks * cfg.k * cfg.block_elems * 4
        if len(raw) != want:
            raise MalformedStream(
                f"verbatim chunk holds {len(raw)} bytes for "
                f"{chunk.n_hyperblocks} hyper-blocks, expected {want}")
        return np.frombuffer(raw, "<f4").reshape(
            chunk.n_hyperblocks, cfg.k, cfg.block_elems).copy()

    def prepare_compress(self, hyperblocks: np.ndarray,
                         tau: Optional[float], mesh=None) -> int:
        """Shared compress preamble: fit the PCA basis if the caller asked
        for a guarantee and none exists yet (sharded over ``mesh`` when one
        is active).  Returns ``gae_dim``."""
        if tau is not None:
            if self.basis is None:
                self.fit_basis(hyperblocks, mesh=mesh)
            return int(self.basis.shape[0])
        return 0

    def compress(self, hyperblocks: np.ndarray,
                 options: Optional[CompressOptions] = None) -> Archive:
        """Batch compress: the device front-end runs stripe by stripe, then
        the host GAE/entropy coders fan out over the finished stripes on the
        codec pool.  ``repro_torch.stream.stream_compress`` runs the same
        per-stripe stages pipelined and produces byte-identical chunks.

        Configuration comes in as one ``CompressOptions``.  The streaming and
        fault-tolerance fields are not read here, as in the JAX package.
        With ``options.mesh`` set, aligned runs of stripes run as one shard
        group each — one stripe a shard — and the archive stays
        byte-identical to the single-device result (per-shard shapes equal
        per-stripe shapes, so the floats are bit-equal, and chunk boundaries
        never move).
        """
        opts = options if options is not None else CompressOptions()
        mesh = self._resolve_mesh(opts.mesh)
        tau = opts.tau
        n = hyperblocks.shape[0]
        gae_dim = self.prepare_compress(hyperblocks, tau, mesh=mesh)
        spans = self.stripe_spans(n, opts.chunk_hyperblocks,
                                  with_gae=tau is not None)

        # 1+2. device-resident AE front-end.  Unsharded: one stripe per call
        # (the stripe IS the archive chunk).  Sharded: aligned groups of
        # ``n_shards`` stripes, one stripe a shard; the ragged tail takes
        # the per-stripe path.
        latents: list[tuple] = []
        with exec_mod.stage("ae_encode", hyperblocks.size):
            tail = spans
            if mesh is not None:
                groups, tail = mesh_exec.plan_shard_groups(
                    spans, mesh_exec.mesh_shards(mesh))
                for group in groups:
                    latents.extend(self.encode_group_device(
                        group, hyperblocks, mesh))
            for s, w in tail:
                latents.append(self.encode_stripe_device(hyperblocks[s:s + w]))

        # 3+4. GAE + entropy coding, chunk-parallel over stripes
        def encode_chunk(i: int) -> ArchiveChunk:
            start, n_hb = spans[i]
            q_lh, q_lbs, recon = latents[i]
            return self.encode_stripe_host(
                start, hyperblocks[start:start + n_hb], q_lh, q_lbs, recon,
                tau, gae_dim)

        chunks: list[Optional[ArchiveChunk]] = exec_mod.map_parallel(
            encode_chunk, range(len(spans)))

        return Archive(n_hyperblocks=n, n_values=hyperblocks.size,
                       chunk_hyperblocks=self._chunk_width(
                           opts.chunk_hyperblocks, with_gae=tau is not None),
                       gae_dim=gae_dim, chunks=chunks)

    # -- decode helpers ------------------------------------------------------
    def _decode_chunk(self, chunk: ArchiveChunk, archive: Archive):
        """Decode one chunk's streams into quantized latents + GAE codes,
        cross-checking every count against the model configuration.  Raises
        a typed ``ArchiveError`` on any inconsistency.  A quarantined
        (verbatim) chunk short-circuits to a ``_VerbatimStripe``."""
        cfg = self.cfg
        if chunk.verbatim_blob:
            return _VerbatimStripe(self.decode_stripe_verbatim(chunk))
        if chunk.hb_stream is None:
            raise MalformedStream("chunk has neither latent streams nor a "
                                  "verbatim payload")
        n_hb, k, d = chunk.n_hyperblocks, cfg.k, cfg.block_elems
        want_hb = n_hb * cfg.hb_latent
        if chunk.hb_stream.count != want_hb:
            raise MalformedStream(
                f"hb stream has {chunk.hb_stream.count} symbols, "
                f"expected {want_hb}")
        q_lh = entropy.huffman_decompress(chunk.hb_stream)\
            .reshape(n_hb, cfg.hb_latent)
        if len(chunk.bae_streams) != len(self.bae_params):
            raise MalformedStream(
                f"{len(chunk.bae_streams)} BAE streams for "
                f"{len(self.bae_params)} BAE stages")
        q_lbs = []
        for stream in chunk.bae_streams:
            want = n_hb * k * cfg.bae_latent
            if stream.count != want:
                raise MalformedStream(
                    f"BAE stream has {stream.count} symbols, expected {want}")
            q_lbs.append(entropy.huffman_decompress(stream)
                         .reshape(n_hb * k, cfg.bae_latent))
        codes: list[gae.GAEBlockCode] = []
        if chunk.gae_index_blob:
            if archive.gae_dim <= 0:
                raise MalformedStream("GAE section present but gae_dim == 0")
            d_gae = cfg.gae_block_elems or d
            if (n_hb * k * d) % d_gae:
                raise MalformedStream(
                    f"chunk of {n_hb * k * d} values not divisible into "
                    f"GAE blocks of {d_gae}")
            n_gae = (n_hb * k * d) // d_gae
            index_sets = entropy.decode_index_sets(
                chunk.gae_index_blob, expect_dim=archive.gae_dim,
                expect_sets=n_gae)
            binexps = np.frombuffer(
                entropy.zlib_unpack(chunk.gae_binexp_blob), np.uint8)
            if binexps.size != n_gae:
                raise MalformedStream(
                    f"{binexps.size} bin exponents for {n_gae} GAE blocks")
            total = int(sum(s.size for s in index_sets))
            have = (chunk.gae_coeff_stream.count
                    if chunk.gae_coeff_stream is not None else 0)
            if have != total:
                raise MalformedStream(
                    f"coefficient stream has {have} values, index sets "
                    f"declare {total}")
            coeffs = (entropy.huffman_decompress(chunk.gae_coeff_stream)
                      if chunk.gae_coeff_stream is not None
                      else np.zeros(0, np.int64))
            pos = 0
            for i, idx in enumerate(index_sets):
                codes.append(gae.GAEBlockCode(
                    m=idx.size, indices=idx, qcoeffs=coeffs[pos:pos + idx.size],
                    bin_exp=int(binexps[i])))
                pos += idx.size
        return q_lh, q_lbs, codes

    def decompress(self, archive: Archive, strict: bool = True, mesh=None
                   ) -> Union[np.ndarray, tuple[np.ndarray, DamageReport]]:
        """Decode an archive back to hyper-blocks.

        ``strict=True`` (default) raises a typed ``ArchiveError`` on the first
        damaged or inconsistent chunk.  ``strict=False`` returns
        ``(reconstruction, DamageReport)``: damaged stripes decode from zeroed
        latents with no GAE correction (and no guarantee), every other stripe
        is digest-verified and still satisfies the per-block bound.

        ``mesh`` (anything ``parallel.mesh_exec.resolve_mesh`` accepts) runs
        the dequantize+decode back-end sharded over the hyper-block axis.  Its
        shards see other batch shapes than the single-device decode, so its
        floats can differ from it in the last ulp — well inside the
        ``tau * (1 + 1e-5)`` slack every guarantee check carries.  Entropy
        decode and GAE correction are unchanged.
        """
        cfg = self.cfg
        n, k, d = archive.n_hyperblocks, cfg.k, cfg.block_elems
        report = DamageReport(n_hyperblocks=n, n_chunks=len(archive.chunks))
        if archive.gae_dim and self.basis is None:
            raise MalformedStream("archive has a GAE section but this "
                                  "compressor has no fitted basis")
        if archive.gae_dim and self.basis.shape[0] != archive.gae_dim:
            raise MalformedStream(
                f"archive GAE dimension {archive.gae_dim} != basis "
                f"dimension {self.basis.shape[0]}")
        if archive.n_values != n * k * d:
            raise MalformedStream(
                f"archive declares {archive.n_values} values for "
                f"{n}x{k}x{d} hyper-blocks")

        q_lh = np.zeros((n, cfg.hb_latent), np.int64)
        q_lbs = [np.zeros((n * k, cfg.bae_latent), np.int64)
                 for _ in self.bae_params]
        gae_codes: dict[int, gae.GAEBlockCode] = {}   # global gae-block index
        verbatim_spans: list[tuple[int, int, np.ndarray]] = []
        d_gae = cfg.gae_block_elems or d
        gae_per_hb = (k * d) // d_gae if archive.gae_dim else 0

        # Chunks are independently decodable, so the entropy fan-out runs on
        # the shared pool; per-chunk errors are captured and re-raised in
        # chunk order to keep strict-mode behavior deterministic.
        def decode_one(chunk: Optional[ArchiveChunk]):
            if chunk is None:
                return None
            try:
                return self._decode_chunk(chunk, archive)
            except ArchiveError as e:
                return e

        with exec_mod.stage("entropy_decode", archive.n_values):
            decoded = exec_mod.map_parallel(decode_one, archive.chunks)

        covered = 0
        for ci, (chunk, result) in enumerate(zip(archive.chunks, decoded)):
            if chunk is None:
                start = covered
                n_hb = min(archive.chunk_hyperblocks, n - start)
                covered += n_hb
                err = archive.chunk_errors.get(ci, "chunk unreadable")
                if strict:
                    raise MalformedStream(f"chunk {ci} damaged: {err}")
                report.damaged.append(ChunkDamage(
                    chunk=ci, hb_start=start, n_hyperblocks=n_hb,
                    section="chunk", error=err))
                continue
            if chunk.hb_start != covered:
                raise MalformedStream(
                    f"chunk {ci} starts at hyper-block {chunk.hb_start}, "
                    f"expected {covered}")
            covered += chunk.n_hyperblocks
            if isinstance(result, ArchiveError):
                if strict:
                    raise result
                report.damaged.append(ChunkDamage(
                    chunk=ci, hb_start=chunk.hb_start,
                    n_hyperblocks=chunk.n_hyperblocks, section="decode",
                    error=repr(result)))
                continue
            if isinstance(result, _VerbatimStripe):
                # quarantined stripe: raw values land after the AE backend
                # runs (its latent rows stay zero; no GAE codes exist here)
                verbatim_spans.append((chunk.hb_start,
                                       chunk.hb_start + chunk.n_hyperblocks,
                                       result.data))
                continue
            c_lh, c_lbs, c_codes = result
            s, e = chunk.hb_start, chunk.hb_start + chunk.n_hyperblocks
            q_lh[s:e] = c_lh
            for stage_i, c_lb in enumerate(c_lbs):
                q_lbs[stage_i][s * k:e * k] = c_lb
            for j, code in enumerate(c_codes):
                gae_codes[s * gae_per_hb + j] = code
        if covered != n:
            raise MalformedStream(
                f"chunks cover {covered} hyper-blocks, archive declares {n}")

        # dequantize+decode back-end — the same function that produced the
        # reconstruction the GAE encoder verified against (over the mesh's
        # devices when one is active)
        resolved_mesh = self._resolve_mesh(mesh)
        with exec_mod.stage("ae_decode", archive.n_values):
            if resolved_mesh is not None:
                recon = exec_mod.run_decompress_stage_sharded(
                    self.hbae_params, self.bae_params, q_lh, q_lbs,
                    cfg.hb_bin, cfg.bae_bin, resolved_mesh)
            else:
                recon = exec_mod.run_decompress_stage(
                    self.hbae_params, self.bae_params, q_lh, q_lbs,
                    cfg.hb_bin, cfg.bae_bin)

        if archive.gae_dim and gae_codes:
            with exec_mod.stage("gae_decode", archive.n_values):
                r_gae = self._gae_view(recon)
                keys = sorted(gae_codes)
                idxs = np.fromiter(keys, np.int64, len(keys))
                sub = gae.gae_decode_blocks(r_gae[idxs], self.basis,
                                            [gae_codes[i] for i in keys],
                                            cfg.gae_bin)
                r_gae[idxs] = sub
                recon = self._gae_unview(r_gae, recon.shape)
        for s, e, data in verbatim_spans:
            recon[s:e] = data
        if strict:
            return recon
        return recon, report

    # -- persistence ---------------------------------------------------------
    # Manifest + npz layout (no pickle anywhere on the read path): one .npz
    # holding one array per tensor plus a JSON manifest (uint8 array) with
    # per-tensor sha256 digests.  The layout is the JAX package's, so either
    # package reads the other's file.
    def save(self, path: str) -> None:
        from repro_torch.runtime.archive_io import atomic_write_bytes

        leaves: list[tuple[str, np.ndarray]] = []
        statics: dict[str, dict] = {}
        _flatten_params({"hbae": self.hbae_params, "bae": self.bae_params},
                        "", leaves, statics)
        if self.basis is not None:
            leaves.append(("basis", np.asarray(self.basis)))
        manifest = {"format": MODEL_FORMAT,
                    "cfg": dataclasses.asdict(self.cfg),
                    "n_bae_stages": len(self.bae_params),
                    "has_basis": self.basis is not None,
                    "statics": statics, "tensors": []}
        arrays: dict[str, np.ndarray] = {}
        for i, (tpath, arr) in enumerate(leaves):
            arrays[f"t{i}"] = arr
            manifest["tensors"].append(
                {"key": f"t{i}", "path": tpath, "shape": list(arr.shape),
                 "dtype": str(arr.dtype), "sha256": _sha(arr)})
        arrays["__manifest__"] = np.frombuffer(
            json.dumps(manifest, sort_keys=True).encode(), np.uint8)
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        atomic_write_bytes(path, buf.getvalue())

    @classmethod
    def load(cls, path: str, device=None) -> "HierarchicalCompressor":
        try:
            data = np.load(path, allow_pickle=False)
        except Exception as e:
            raise MalformedStream(f"unreadable model file {path!r}: {e}") from e
        if "__manifest__" not in data:
            raise MalformedStream(f"{path!r} has no manifest (legacy pickle "
                                  "models are not supported on the read path)")
        try:
            manifest = json.loads(bytes(data["__manifest__"]).decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise MalformedStream(f"corrupt model manifest: {e}") from e
        if manifest.get("format") != MODEL_FORMAT:
            raise MalformedStream(
                f"unsupported model format {manifest.get('format')!r}")
        entries: list[tuple[str, np.ndarray]] = []
        for t in manifest["tensors"]:
            if t["key"] not in data:
                raise MalformedStream(f"model tensor {t['path']} missing")
            arr = data[t["key"]]
            if _sha(arr) != t["sha256"]:
                raise ChecksumMismatch(f"model tensor {t['path']} hash mismatch")
            entries.append((t["path"], arr))
        tree = _assemble_params(entries, manifest.get("statics", {}))
        obj = cls(CompressorConfig(**manifest["cfg"]), device=device)
        obj.hbae_params, obj.bae_params = _params_from_tree(
            tree, manifest["n_bae_stages"], obj.device)
        obj.basis = tree.get("basis") if manifest["has_basis"] else None
        return obj

    def model_bytes(self) -> int:
        """Storage cost of the decoder-side model (params + PCA basis), using
        each leaf's actual dtype width."""
        leaves: list[tuple[str, np.ndarray]] = []
        _flatten_params([self.hbae_params, self.bae_params], "", leaves, {})
        total = sum(a.size * a.dtype.itemsize for _, a in leaves)
        if self.basis is not None:
            total += self.basis.size * np.dtype(self.basis.dtype).itemsize
        return total
