#!/usr/bin/env python3
"""The LM prefill on the card, fp32 then bf16, for one or more trees of the
port, each in its own process, in the order given.

    python3 scripts/prefill_ab.py [TREE ...]

A tree is a directory holding ``src/repro_torch`` (default: this checkout);
its kernels build into ``TREE/build/kernels``.  For comparing two commits on
one card, unpack the other one into a directory that ``.gitignore`` lists
and give the trees in turns: ``prefill_ab.py old . . old``.

For qwen2-1.5b and mamba2-370m at full width with seeded fp32 weights, each
process runs ``chip_smoke.lm_prefill`` (``forward`` over B 1 x S 4096
tokens after a warm-up; wall, tokens/s, profiled device busy time and the
kernel's part of it, one launch per layer checked) in fp32 and then with
``compute_dtype="bfloat16"``, and prints one line per prefill.  A prefill
that raises is reported as such, and the run goes on.
"""
from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(tree: str) -> int:
    import torch

    sys.path.insert(0, os.path.join(tree, "src"))
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as sd
    from repro_torch.models import registry

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    counters = {"flash_attention": fa.launches, "ssd_scan": sd.launches}
    for arch, kernel in cs.LM_MODELS:
        cfg = get_config(arch)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = registry.init_params(cfg, RunConfig(), gen, dev)
        api = registry.get_model(cfg)
        tokens = torch.randint(0, cfg.vocab, (1, cs.PREFILL_TOKENS),
                               generator=gen, device=dev)
        for dtype in ("float32", "bfloat16"):
            try:
                r = cs.lm_prefill(torch, api, params, cfg,
                                  RunConfig(compute_dtype=dtype), tokens,
                                  kernel, counters)
            except Exception as e:          # the report names what raised
                print(f"tree {tree}: lm {arch} prefill {dtype}: raised "
                      f"{type(e).__name__}: {e}", flush=True)
                continue
            print(f"tree {tree}: ", end="")
            cs.print_prefill(arch, kernel, dtype, r)
        del params
        torch.cuda.empty_cache()
    return 0


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        return one(os.path.abspath(argv[1]))
    rc = 0
    for tree in argv or [HERE]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", tree]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
