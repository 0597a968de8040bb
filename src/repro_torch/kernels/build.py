"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/kernels/<name>-<digest>.so`` at the repository root, where
``<digest>`` is the source's sha256 prefix, so an edited source never loads a
stale library.  A build starts at a kernel's first launch; ``build_all``
starts one ``nvcc`` per source at once and waits for all of them.

Flags: ``-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3``, and no
``--use_fast_math``: the kernels rely on IEEE division and ``expf``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
KERNELS = ("quantize", "block_attention", "gae_project", "flash_attention",
           "ssd_scan")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_DECLARED: set[str] = set()


class LaunchCounter:
    """Launches of one kernel: a plain int behind a lock, because the GAE
    encoder calls the kernels from the codec pool's worker threads."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return nvcc


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str) -> Optional[tuple[subprocess.Popen, Path, Path]]:
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)     # atomic: a concurrent build never sees half a file


def build_all(names=KERNELS) -> None:
    """Compile every kernel not built yet, one ``nvcc`` per source, all
    started together, then load them."""
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        jobs = [(n, _start(n)) for n in todo]
        for n, job in jobs:
            _finish(n, job)
        for n in todo:
            _LIBS[n] = ctypes.CDLL(str(_target(n)))


def library(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use;
    ``declare`` sets its functions' ``argtypes``/``restype`` once."""
    if name in _DECLARED:
        return _LIBS[name]
    build_all((name,))
    with _LOCK:
        lib = _LIBS[name]
        if name not in _DECLARED:
            declare(lib)
            _DECLARED.add(name)
    return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


def stream_ptr(device) -> ctypes.c_void_p:
    """The current CUDA stream of ``device`` for this thread."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
