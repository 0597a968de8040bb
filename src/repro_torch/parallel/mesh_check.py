"""Multi-shard parity check of the sharded compress path.

    python -m repro_torch.parallel.mesh_check --device cpu   # 4 shards, CPU
    python -m repro_torch.parallel.mesh_check                # 4 shards, card
    REPRO_MESH_CHECK_DEVICES=2 python -m repro_torch.parallel.mesh_check

Runs ``REPRO_MESH_CHECK_DEVICES`` shards (default 4) over the named device
repeated (``make_compress_mesh(devices=[device] * N)``, the port's
counterpart of the JAX package's virtual devices); without ``--device`` it
needs the card.  On a small compressor with seeded random params and a
fitted PCA basis (24 hyper-blocks, chunk 4: one aligned group of 4 stripes
and a ragged 2-stripe tail), it checks:

1. **batch_parity** — ``compress`` with the mesh serializes to the exact
   bytes of the single-device archive;
2. **sharded_groups_ran** — the sharded group path ran, at the mesh's
   shard count;
3. **stream_parity** — ``stream_compress`` with the mesh gives the same
   bytes again, in memory AND on disk;
4. **replicas_reused** — a second sharded pass makes no new param replica;
5. **psum_basis_consistent** — the sharded PCA fit matches the
   single-device basis up to column sign (the sum's order differs);
6. **sharded_basis_honors_tau** — a basis fitted over the mesh drives a
   compress within tau;
7. **sharded_decompress** — the sharded decode matches the single decode
   within float32 tolerance and every GAE block holds tau.

Prints one JSON report; exits non-zero if any check fails.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from repro_torch.core import exec as exec_mod
from repro_torch.core import gae
from repro_torch.core.options import CompressOptions
from repro_torch.core.pipeline import CompressorConfig, HierarchicalCompressor
from repro_torch.parallel import mesh_exec
from repro_torch.runtime import archive_io
from repro_torch.stream import stream_compress

TAU = 0.5
NOT_PORTED = ("zero_retraces_after_warmup has no counterpart: the port runs "
              "eagerly and has no trace cache (core/exec.py); "
              "replicas_reused checks its param-replica cache instead. "
              "options_shim has no counterpart: the deprecated kwargs are "
              "not ported (ROADMAP.md Decisions).")


def _make_comp(device, n_hb: int = 24
               ) -> tuple[HierarchicalCompressor, np.ndarray]:
    cfg = CompressorConfig(block_elems=40, k=2, emb=16, hidden=32,
                           hb_latent=8, bae_hidden=32, bae_latent=4,
                           gae_block_elems=80, hb_bin=0.01, bae_bin=0.01,
                           gae_bin=0.02)
    comp = HierarchicalCompressor(cfg, device=device).init_params(seed=0)
    rng = np.random.default_rng(0)
    hb = 0.1 * rng.standard_normal(
        (n_hb, cfg.k, cfg.block_elems)).astype(np.float32)
    comp.fit_basis(hb)          # shared basis: parity is about the pipeline
    return comp, hb


def _max_block_err(comp, hb, recon) -> float:
    d_gae = comp.cfg.gae_block_elems or comp.cfg.block_elems
    return float(np.linalg.norm((hb - recon).reshape(-1, d_gae), axis=1).max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="device to repeat over the shards (default: the "
                    "card)")
    args = ap.parse_args(argv)
    want = int(os.environ.get("REPRO_MESH_CHECK_DEVICES", "4"))
    if want < 2:
        print(json.dumps({"ok": False, "shards": want,
                          "error": "need >= 2 shards"}))
        return 1
    try:
        device = exec_mod.resolve_device(args.device)
    except RuntimeError as e:
        print(json.dumps({"ok": False, "error": str(e)}))
        return 1
    mesh = mesh_exec.make_compress_mesh(devices=[device] * want)
    checks: list[dict] = []

    def check(name: str, ok: bool, detail: str = "") -> None:
        checks.append({"name": name, "ok": bool(ok), "detail": detail})

    comp, hb = _make_comp(device)
    base_opts = CompressOptions(tau=TAU, chunk_hyperblocks=4)
    mesh_opts = base_opts.replace(mesh=mesh)

    exec_mod.reset_stage_stats()
    single = comp.compress(hb, options=base_opts)
    sharded = comp.compress(hb, options=mesh_opts)
    blob_single = archive_io.serialize_archive(single)
    check("batch_parity",
          archive_io.serialize_archive(sharded) == blob_single,
          f"{len(blob_single)} bytes, {len(single.chunks)} chunks")

    cnt = exec_mod.counters()
    check("sharded_groups_ran", cnt.get("mesh.sharded_groups", 0) >= 1
          and cnt.get("mesh.shards", 0) == want,
          f"groups={cnt.get('mesh.sharded_groups', 0):g} "
          f"shards={cnt.get('mesh.shards', 0):g}")

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "mesh_check.rba")
        result = stream_compress(comp, hb, options=mesh_opts, out_path=out)
        with open(out, "rb") as f:
            disk = f.read()
    blob_stream = archive_io.serialize_archive(result.archive)
    check("stream_parity", blob_stream == blob_single and disk == blob_single,
          f"stream items={result.stats.n_items} "
          f"chunks={len(result.archive.chunks)}")

    before = exec_mod.counters().get("mesh.param_replicas", 0)
    comp.compress(hb, options=mesh_opts)
    comp.decompress(single, mesh=mesh)
    made = exec_mod.counters().get("mesh.param_replicas", 0) - before
    same = all(exec_mod.replicate_params(
        comp.hbae_params, comp.bae_params, d)[0] is comp.hbae_params
        for d in mesh.devices)
    check("replicas_reused", made == 0 and same,
          f"{made:g} new replica(s) on the second pass; every shard runs "
          f"on the params themselves: {same}")

    # the psum basis: a FULL-RANK covariance (rows >> dims), compared column
    # by column up to sign (eigh's per-column sign is a convention)
    rng = np.random.default_rng(7)
    resid = rng.standard_normal((400, 80)).astype(np.float32) * 0.1
    with torch.inference_mode():
        basis_single = gae.fit_pca_basis(
            exec_mod.upload(resid, device)).cpu().numpy()
    basis_sharded = mesh_exec.fit_pca_basis_sharded(resid, mesh)
    align = np.abs(np.sum(basis_single * basis_sharded, axis=0))
    check("psum_basis_consistent",
          basis_sharded.shape == basis_single.shape
          and bool(np.all(align > 1 - 1e-3)),
          f"min |col alignment| = {float(align.min()):.6f}")

    comp2, hb2 = _make_comp(device)
    comp2.basis = None
    comp2.fit_basis(hb2, mesh=mesh)
    err2 = _max_block_err(comp2, hb2, comp2.decompress(
        comp2.compress(hb2, options=base_opts)))
    check("sharded_basis_honors_tau", err2 <= TAU * (1 + 1e-5),
          f"max block l2 {err2:.4f} <= tau={TAU}")

    dec_single = comp.decompress(single)
    dec_sharded = comp.decompress(single, mesh=mesh)
    err = _max_block_err(comp, hb, dec_sharded)
    check("sharded_decompress",
          bool(np.allclose(dec_sharded, dec_single, rtol=1e-5, atol=1e-6))
          and err <= TAU * (1 + 1e-5),
          f"max block l2 {err:.4f} <= tau={TAU}, max |recon diff| = "
          f"{float(np.max(np.abs(dec_sharded - dec_single))):.3g}")

    ok = all(c["ok"] for c in checks)
    print(json.dumps({"ok": ok, "device": str(device), "shards": want,
                      "checks": checks, "detail": NOT_PORTED}, indent=2))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
