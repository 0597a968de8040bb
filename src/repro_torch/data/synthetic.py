"""Synthetic surrogates for the paper's three datasets (S3D / E3SM / XGC).

The real datasets are not redistributable offline.  These generators match the
*structure* the paper's method exploits — strong spatiotemporal correlation,
strong inter-variable (species / plane) correlation, block-structured meshes —
at configurable sizes so tests run in seconds and benchmarks in minutes.
Absolute compression ratios therefore differ from the paper; relative orderings
are what EXPERIMENTS.md validates (see DESIGN.md §1).

All generators are deterministic in ``seed`` and return float32.

``make_dataset(name, quick=...)`` is the shared entry point (launchers,
benchmarks, examples): it generates the field, applies the paper's
normalization, blocks it at the paper's geometry and groups hyper-blocks,
returning (CompressorConfig, hyperblocks).
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _fourier_field(rng: np.random.Generator, t: int, h: int, w: int,
                   n_modes: int = 12, t_speed: float = 0.35,
                   warp: float = 0.6) -> np.ndarray:
    """Smooth multiscale advecting field (T,H,W): sum of random Fourier modes
    with 1/k amplitude decay and temporal phase advection.

    ``warp`` adds a nonlinear time-warp per mode (accelerating/decelerating
    advection, as in real ignition fronts): phase(t) = omega*(t + a*T*
    sin(2*pi*t/T + phi)).  Inter-block temporal relationships then VARY by
    position in the sequence — the structure content-based attention can
    exploit but a fixed linear cross-block mix cannot."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    field = np.zeros((t, h, w), np.float32)
    ts = np.arange(t, dtype=np.float64)[:, None, None]
    for _ in range(n_modes):
        kx = rng.integers(1, max(2, w // 8))
        ky = rng.integers(1, max(2, h // 8))
        amp = 1.0 / np.hypot(kx, ky)
        phase = rng.uniform(0, 2 * np.pi)
        omega = t_speed * rng.uniform(-1, 1)
        aw = warp * rng.uniform(0, 1)
        tw = ts + aw * t / (2 * np.pi) * np.sin(2 * np.pi * ts / t +
                                                rng.uniform(0, 2 * np.pi))
        arg = (2 * np.pi * (kx * xs / w + ky * ys / h))[None] + omega * tw + phase
        field += (amp * np.cos(arg)).astype(np.float32)
    return field


def s3d_like(n_species: int = 58, t: int = 50, h: int = 640, w: int = 640,
             rank: int = 8, noise: float = 1e-3, seed: int = 0) -> np.ndarray:
    """(species, T, H, W): species are nonlinear mixtures of ``rank`` latent
    fields, reproducing the strong inter-species correlation of S3D ([13] in
    the paper) that the hyper-block attention is designed to exploit."""
    rng = np.random.default_rng(seed)
    latents = np.stack([_fourier_field(rng, t, h, w) for _ in range(rank)])  # (r,T,H,W)
    mix = rng.normal(size=(n_species, rank)).astype(np.float32)
    mix /= np.linalg.norm(mix, axis=1, keepdims=True)
    base = np.tensordot(mix, latents, axes=(1, 0))                           # (S,T,H,W)
    # per-species monotone nonlinearity (species concentrations are positive,
    # exponentially distributed in magnitude like ignition chemistry)
    gains = rng.uniform(0.5, 2.0, size=n_species).astype(np.float32)
    scales = np.exp(rng.uniform(-3, 3, size=n_species)).astype(np.float32)
    out = np.empty_like(base)
    for s in range(n_species):
        out[s] = scales[s] * np.exp(gains[s] * np.tanh(base[s]))
    out += noise * rng.standard_normal(out.shape).astype(np.float32) * out.std()
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# dataset assembly at the paper's block/hyper-block geometry
# ---------------------------------------------------------------------------

# (full-size kwargs, quick kwargs) per dataset
_SIZES = {
    # quick sizes keep a full-length temporal axis (hyper-blocks group k
    # CONSECUTIVE TEMPORAL blocks per the paper, so t_grid must be >= k)
    "s3d": (dict(n_species=58, t=50, h=640, w=640),
            dict(n_species=58, t=50, h=48, w=48)),      # t_grid=10=k
    "e3sm": (dict(t=720, h=240, w=1440), dict(t=60, h=48, w=96)),  # t_grid=10
    "xgc": (dict(planes=8, nodes=16395, v=39),
            dict(planes=8, nodes=1024, v=39)),
}


def _temporal_major(blocks: np.ndarray, grid: tuple, t_axis: int) -> np.ndarray:
    """Reorder a row-major block grid so the TEMPORAL grid axis varies fastest
    — the paper groups k consecutive temporal blocks (same spatial location)
    into one hyper-block (Sec. III: 'Continuous, non-overlapping blocks ...
    along the temporal dimension')."""
    order = [i for i in range(len(grid)) if i != t_axis] + [t_axis]
    b = blocks.reshape(*grid, blocks.shape[1])
    b = np.transpose(b, order + [len(grid)])
    return np.ascontiguousarray(b.reshape(-1, blocks.shape[1]))


def make_dataset(name: str, *, quick: bool = True, seed: int = 0,
                 epochs_scale: float | None = None,
                 field: dict | None = None):
    """Generate + normalize + block a synthetic dataset at the paper's
    geometry.  Returns (CompressorConfig, hyperblocks (N, k, D) float32).

    ``quick`` shrinks the field (same block geometry) and the train epochs so
    tests/benchmarks run in minutes; S3D keeps all 58 species — the
    inter-species correlation is what the method exploits.

    ``field`` overrides the generator's size keywords (for example
    ``dict(h=160, w=160)`` for S3D) without touching the model config, so a
    run can cut the field while keeping the full-width model.
    """
    import dataclasses as _dc

    from repro_torch.configs import get_compressor_config
    from repro_torch.data import blocks as blocks_mod

    cfg = get_compressor_config(name)
    full, small = _SIZES[name]
    kwargs = dict(small if quick else full, **(field or {}))

    if name == "s3d":
        data = s3d_like(seed=seed, **kwargs)
        norm = blocks_mod.Normalizer.fit(data, mode="range", axis=0)
        data = norm.forward(data)
        blocks, meta = blocks_mod.block_nd(data, (data.shape[0], 5, 4, 4))
        # hyper-blocks = 10 consecutive TEMPORAL blocks (grid axis 1)
        blocks = _temporal_major(blocks, meta.grid_shape, t_axis=1)
    elif name == "e3sm":
        data = e3sm_like(seed=seed, **kwargs)
        norm = blocks_mod.Normalizer.fit(data, mode="zscore")
        data = norm.forward(data)
        blocks, meta = blocks_mod.block_nd(data, (6, 16, 16))
        # hyper-blocks = 5 consecutive TEMPORAL blocks (grid axis 0)
        blocks = _temporal_major(blocks, meta.grid_shape, t_axis=0)
    else:  # xgc
        data = xgc_like(seed=seed, **kwargs)
        norm = blocks_mod.Normalizer.fit(data, mode="zscore")
        data = norm.forward(data)
        # hyper-block = the 8 planes at one node: reorder to (nodes, planes)
        p, n, v, _ = data.shape
        blocks = data.transpose(1, 0, 2, 3).reshape(n * p, v * v)
    hb = blocks_mod.group_hyperblocks(blocks, cfg.k)
    if quick:
        cfg = _dc.replace(cfg, epochs_hbae=30, epochs_bae=20, hidden=256,
                          bae_hidden=256)
    if epochs_scale:
        cfg = _dc.replace(cfg, epochs_hbae=max(1, int(cfg.epochs_hbae * epochs_scale)),
                          epochs_bae=max(1, int(cfg.epochs_bae * epochs_scale)))
    return cfg, hb.astype(np.float32)


def e3sm_like(t: int = 720, h: int = 240, w: int = 1440, seed: int = 0,
              noise: float = 5e-4) -> np.ndarray:
    """(T,H,W) sea-level-pressure-like field: zonal banding + advecting eddies
    + a diurnal cycle (period 24 steps), matching the E3SM PSL structure."""
    rng = np.random.default_rng(seed)
    lat = np.linspace(-np.pi / 2, np.pi / 2, h)[None, :, None]
    zonal = 1013.0 + 8.0 * np.cos(2 * lat) - 3.0 * np.cos(4 * lat)
    eddies = 6.0 * _fourier_field(rng, t, h, w, n_modes=20, t_speed=0.2)
    diurnal = 1.5 * np.sin(2 * np.pi * np.arange(t) / 24.0)[:, None, None]
    out = zonal + eddies + diurnal
    out += noise * rng.standard_normal(out.shape) * out.std()
    return out.astype(np.float32)


def xgc_like(planes: int = 8, nodes: int = 16395, v: int = 39, seed: int = 0,
             plane_jitter: float = 0.02, noise: float = 1e-3) -> np.ndarray:
    """(planes, nodes, v, v) velocity-space histograms: per-node drifting
    anisotropic Maxwellians; the 8 toroidal planes are near-copies (the strong
    cross-plane correlation the paper groups into hyper-blocks)."""
    rng = np.random.default_rng(seed)
    vpar, vperp = np.meshgrid(np.linspace(-3, 3, v), np.linspace(-3, 3, v),
                              indexing="ij")
    # smooth node profiles (nodes ordered along a flux surface -> 1D smooth)
    def smooth_profile(lo, hi):
        raw = rng.standard_normal(nodes)
        kernel = np.exp(-0.5 * (np.arange(-50, 51) / 15.0) ** 2)
        kernel /= kernel.sum()
        sm = np.convolve(raw, kernel, mode="same")
        sm = (sm - sm.min()) / max(float(np.ptp(sm)), 1e-9)
        return (lo + (hi - lo) * sm).astype(np.float32)

    temp_par = smooth_profile(0.6, 1.6)[:, None, None]
    temp_perp = smooth_profile(0.6, 1.6)[:, None, None]
    drift = smooth_profile(-0.8, 0.8)[:, None, None]
    dens = smooth_profile(0.5, 2.0)[:, None, None]
    base = dens * np.exp(-((vpar[None] - drift) ** 2) / (2 * temp_par)
                         - (vperp[None] ** 2) / (2 * temp_perp))
    out = np.empty((planes, nodes, v, v), np.float32)
    for p in range(planes):
        pert = 1.0 + plane_jitter * rng.standard_normal((nodes, 1, 1)).astype(np.float32)
        shift = plane_jitter * rng.standard_normal()
        out[p] = base * pert * (1.0 + shift)
    out += noise * rng.standard_normal(out.shape).astype(np.float32) * out.std()
    return out.astype(np.float32)
