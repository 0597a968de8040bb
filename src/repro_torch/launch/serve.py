"""Serving entry point: batched prefill+decode with continuous batching and
the compressed-KV option (runtime/kvcache), on the card by default.

  python -m repro_torch.launch.serve --arch qwen2-1.5b
  python -m repro_torch.launch.serve --arch mamba2-370m --reduced --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.core.exec import resolve_device
from repro_torch.models.registry import init_params, reduced_config
from repro_torch.serve.engine import Request, ServeEngine


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--kv-tau", type=float, default=None)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    run = RunConfig()
    device = resolve_device(args.device)
    params = init_params(cfg, run, torch.Generator(device).manual_seed(args.seed),
                         device)
    engine = ServeEngine(cfg, run, params, batch_size=args.batch,
                         max_len=args.max_len, temperature=args.temperature,
                         kv_tau=args.kv_tau, seed=args.seed, device=device)

    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab,
                                        args.prompt_len).astype(np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    t0 = time.time()
    outs = engine.serve(reqs)
    dt = time.time() - t0
    gen = sum(len(c.tokens) for c in outs)
    print(f"{len(outs)} completions, {gen} tokens in {dt:.1f}s "
          f"({gen / dt:.1f} tok/s on {device}, kv_tau={args.kv_tau})")
    for c in outs[:3]:
        print(f"  req {c.rid}: {c.tokens[:10].tolist()}...")


if __name__ == "__main__":
    main()
