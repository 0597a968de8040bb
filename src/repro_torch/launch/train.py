"""LM training driver, on the card by default: deterministic data pipeline ->
train step -> checkpoint/restart -> failure-resilient loop.

  python -m repro_torch.launch.train --arch qwen2-1.5b --reduced --steps 20 \\
      --device cpu
  python -m repro_torch.launch.train --arch mamba2-370m --batch 1 --seq 4096 \\
      --steps 4 --grad-compression pca_ef --ckpt /tmp/ck --resume

  python -m repro_torch.launch.train --arch qwen2-1.5b --reduced --tp 2 \
      --device cuda:0,cuda:0 --steps 4 --grad-compression pca_ef

The flags and printed lines are the JAX package's (``resumed at step N``,
``[event] {...}``, ``done: steps a->b  loss=...  ... tok/s  restores=...``),
plus ``--device``.  As the JAX launcher, it builds the host mesh
``make_host_mesh(model=--tp)`` over the visible cards, or over ``--device``
(one device, or a comma-separated list where a device may repeat:
``--device cuda:0,cuda:0`` runs two shards on one card), and steps in the
GSPMD mode (``train.loop``): data-parallel over the mesh's rows and, with
``--tp`` above 1, tensor-parallel over each row's model shards (the dense,
moe, ssm and hybrid families; params padded for ``--tp``), with any
``--grad-compression`` (under ``--tp`` on the gradient's pieces);
``--batch`` must split over the data shards (exit 2).  On one device the
step is the one-device step.  The moe family trains over one data shard:
over more it exits 2.  SIGTERM and SIGINT checkpoint at the next step
boundary and stop.  Exit 2 at parse time also for the vlm and audio
families: their batches need a frontend (``vision_embeds``, ``frames``)
that the token pipeline does not make.  ``--resume`` reads a step directory written by
this launcher (with any ``--tp``: the arrays, the compression's error
buffers among them, are whole) or by the JAX package's
(``runtime.checkpoint``), placed over the mesh by the step's state specs
(``CheckpointManager.restore(mesh=, shardings=)``, as the JAX launcher
resumes).
"""
from __future__ import annotations

import argparse
import os
import signal
import tempfile
import time
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.core.errors import ConfigError
from repro_torch.core.exec import resolve_device
from repro_torch.data.tokens import SyntheticCorpus, TokenPipelineConfig
from repro_torch.launch.mesh import dp_size, make_host_mesh
from repro_torch.launch.serve import FRONTENDS
from repro_torch.models.registry import reduced_config
from repro_torch.parallel.sharding import train_state_specs
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.failures import ResilientRunner
from repro_torch.train import optim
from repro_torch.train.loop import (check_tensor_parallel, init_train_state,
                                    make_train_step, shard_train_state)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", default="none",
                    choices=("none", "pca_ef", "gae"))
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device, or a comma-separated list of the "
                         "data shards' devices (default: every card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if cfg.family in FRONTENDS:
        ap.error(f"--arch {args.arch}: the {cfg.family} family's batches "
                 f"need {FRONTENDS[cfg.family]} (its frontend), which the "
                 f"token pipeline does not make; train it through "
                 f"train.loop.make_train_step with them in the batch")
    run = RunConfig(tp=args.tp, gradient_compression=args.grad_compression)
    try:
        check_tensor_parallel(cfg, run)
    except NotImplementedError as e:
        ap.error(f"--tp {args.tp}: {e}")
    if args.reduced:
        cfg = reduced_config(cfg)
    if args.device is None:
        resolve_device()                    # no card: the error says so
        devices = None                      # every visible card
    else:
        devices = args.device.split(",")
    try:
        mesh = make_host_mesh(model=args.tp, devices=devices)
    except ConfigError as e:
        ap.error(str(e))
    dp = dp_size(mesh)
    if args.batch % dp:
        ap.error(f"--batch {args.batch} does not split over the {dp} data "
                 f"shards of the mesh")
    if dp > 1 and cfg.family == "moe":
        ap.error(f"--arch {args.arch}: the moe family trains over one data "
                 f"shard (its routing is over the batch; ROADMAP.md §3, "
                 f"divergence 10); {dp} data shards given: pass --device "
                 f"as one data shard's --tp devices")
    device = mesh.devices.flat[0]

    opt = optim.adamw(optim.warmup_cosine_schedule(args.lr, 20, args.steps),
                      weight_decay=0.01, max_grad_norm=1.0)
    state = init_train_state(torch.Generator(device).manual_seed(args.seed),
                             cfg, run, opt, device)
    # the tensor-parallel placement (JAX's launcher: param_partition_specs
    # at --tp, no FSDP); at --tp 1 the state stays whole on the first device
    state_specs = train_state_specs(state, mesh) if args.tp > 1 else None
    if state_specs is not None:
        state = shard_train_state(state, mesh, state_specs)
    step_fn = make_train_step(cfg, run, opt, microbatches=args.microbatches,
                              mesh=mesh, shardings=state_specs)
    corpus = SyntheticCorpus(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed))

    ckpt = CheckpointManager(
        args.ckpt or os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"),
        retention=3, device=device)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        start, state = ckpt.restore(mesh=mesh, shardings=state_specs)
        print(f"resumed at step {start}")

    runner = ResilientRunner(
        step_fn, ckpt, lambda s: iter(_gen(corpus, s)),
        save_every=args.save_every,
        on_event=lambda kind, info: print(f"[{kind}] {info}"))

    # SIGTERM (scheduler preemption) / SIGINT (ctrl-C) -> checkpoint at the
    # next step boundary and exit cleanly instead of dying mid-step.
    def _on_signal(signum, frame):
        print(f"[signal] {signal.Signals(signum).name}: preempting at "
              "next step boundary")
        runner.request_preemption()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _on_signal)

    t0 = time.time()
    state, end = runner.run(state, start, args.steps)
    dt = time.time() - t0
    ckpt.save(end, state, blocking=True)
    tok_rate = (end - start) * args.batch * args.seq / max(dt, 1e-9)
    print(f"done: steps {start}->{end}  loss={runner.stats.last_loss:.4f}  "
          f"{tok_rate:,.0f} tok/s  restores={runner.stats.restores}")


def _gen(corpus, start):
    s = start
    while True:
        yield corpus.batch_at(s)
        s += 1


if __name__ == "__main__":
    main()
