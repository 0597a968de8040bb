"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package ``repro``."""
from __future__ import annotations

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


PORT_MODULES = ("repro_torch.core.pipeline", "repro_torch.runtime.archive_io",
                "repro_torch.configs", "repro_torch.models.registry",
                "repro_torch.models.transformer", "repro_torch.models.ssd",
                "repro_torch.models.rglru", "repro_torch.models.moe",
                "repro_torch.kernels.flash_attention.ops",
                "repro_torch.kernels.ssd_scan.ops",
                "repro_torch.runtime.kvcache", "repro_torch.serve.engine",
                "repro_torch.launch.serve", "repro_torch.train.optim",
                "repro_torch.core.training", "repro_torch.launch.compress",
                "repro_torch.baselines.codec", "repro_torch.baselines.szlike",
                "repro_torch.baselines.zfplike",
                "repro_torch.baselines.block_ae", "repro_torch.stream",
                "repro_torch.runtime.stream_writer",
                "repro_torch.runtime.chaosinject",
                "repro_torch.runtime.faultinject",
                "repro_torch.train.loop", "repro_torch.data.tokens",
                "repro_torch.runtime.grad_compress",
                "repro_torch.runtime.checkpoint",
                "repro_torch.runtime.failures", "repro_torch.launch.train",
                "repro_torch.parallel.mesh_exec",
                "repro_torch.parallel.mesh_check",
                "repro_torch.launch.mesh", "repro_torch.parallel.sharding",
                "repro_torch.parallel.collectives",
                "repro_torch.parallel.pipeline")


def test_importing_the_port_loads_no_jax():
    code = (f"import sys, {', '.join(PORT_MODULES)};"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]"
