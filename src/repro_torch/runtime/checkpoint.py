"""Checkpointing, in PyTorch: atomic, hashed, retained, async; and
error-bounded compressed checkpoints.

Layout on disk (one directory per step), the JAX package's ``npz-v1``::

    <dir>/step_00000042/
        manifest.json      # per-tensor path, shape, dtype, sha256, key
        arrays.npz         # logical arrays, as numpy
    <dir>/step_00000042.tmp.<pid>   # in-flight save (renamed on completion)

* **Atomicity** — writes go to a tmp directory, fsync'd, then ``os.replace``d
  into place; a crash mid-save leaves only a tmp dir that restore ignores.
* **Integrity** — every tensor is sha256-hashed in the manifest; restore
  re-hashes and falls back to the previous complete step on any mismatch.
* **Retention** — keep the newest ``retention`` steps.
* **Async** — ``save`` fetches the tensors to the host, then can hand the
  write to a background thread; ``wait()`` joins it.

A tree's paths are the JAX package's: dict keys (sorted), ``.field`` for a
``NamedTuple`` field and the index for a list item, joined by ``/``; a
``TrainState`` reads ``.params/embed/w``, ``.opt/.mu/...``, ``.step``.
``restore`` rebuilds the tree from the manifest's paths alone, with the
port's own ``NamedTuple`` classes (``TrainState``, ``AdamState``,
``SgdState``, ``GradCompressionState``; a field with no leaves, such as
``gc=None``, comes back as ``None``).  It never opens the JAX package's
``treedef.pkl``, so a step directory that the JAX ``CheckpointManager``
wrote restores here; the port writes no ``treedef.pkl``, so its steps do not
restore in the JAX package.  Cross-reading goes one way, JAX to port.

A leaf held as ``Sharded`` pieces over a mesh (a tensor-parallel train
state) is written whole, as the JAX package's ``np.asarray`` of a sharded
array writes it: its pieces are copied to the host and joined there, so
the step directory is the one-device layout, whatever the placement (an
FSDP state's cuts over ``"data"`` included).  ``restore`` gives whole
tensors back onto one device, or with ``mesh=, shardings=`` places each
array by its spec onto any mesh (the JAX package's elastic restore).

A bf16 leaf is written as its uint16 bits with ``"dtype": "bfloat16"`` in
the manifest, the two bytes a value and the name that the JAX package
writes (it stores ml_dtypes' ``|V2``); ``restore`` and
``restore_compressed`` rebuild ``torch.bfloat16`` from the manifest's dtype
whichever of the two the file holds.

``save_compressed`` writes the port's own container (one ``.npz`` file with
a JSON manifest; nothing pickled): every float tensor of at least
``min_size`` elements is encoded with the paper's PCA-GAE machinery such
that every ``block``-long piece is within ``tau`` in l2 on restore.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import threading
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import bf16, entropy, gae
from repro_torch.core.exec import resolve_device
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import Sharded
from repro_torch.runtime.grad_compress import GradCompressionState
from repro_torch.train.loop import TrainState
from repro_torch.train.optim import AdamState, SgdState

PyTree = Any
Tensor = torch.Tensor

_SEP = "/"


def _to_numpy(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that shares no memory with it (``.cpu()`` of
    a CPU tensor would be the tensor itself); a bf16 leaf as its uint16
    bits, the two bytes a value that the JAX package's files hold."""
    if bf16.is_bf16(leaf):
        return bf16.to_bits(leaf)
    if isinstance(leaf, Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _from_numpy(arr: np.ndarray, dtype: str) -> Tensor:
    """The tensor of a host array whose manifest dtype is ``dtype``: a bf16
    leaf from its two bytes a value, whether they were written as uint16
    (the port) or as ml_dtypes' ``|V2`` (the JAX package)."""
    if dtype == bf16.NAME:
        return bf16.from_bits(arr)
    return torch.from_numpy(arr)


def _flatten_with_paths(tree: PyTree) -> list[tuple[str, np.ndarray, str]]:
    """(path, host array, dtype) for every leaf, in ``jax.tree.flatten``
    order; the dtype is the manifest's (JAX's name), "bfloat16" for a bf16
    leaf held as its uint16 bits."""
    out: list = []
    _walk(tree, [], out)
    return out


def _walk(node, keys: list, out: list) -> None:
    # a module-level recursion: a nested one would hold itself, and with it
    # ``out`` and every host copy, in a reference cycle until the cyclic
    # collector ran
    if node is None:
        return
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], keys + [str(k)], out)
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for f, v in zip(node._fields, node):
            _walk(v, keys + ["." + f], out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _walk(v, keys + [str(i)], out)
    else:
        if isinstance(node, Sharded):
            node = node.host()      # a fresh host tensor: no second copy
            arr = bf16.to_bits(node) if bf16.is_bf16(node) else node.numpy()
        else:
            arr = _to_numpy(node)
        out.append((_SEP.join(keys), arr,
                    bf16.NAME if bf16.is_bf16(node) else str(arr.dtype)))


def _spec_paths(specs, keys: list, out: dict) -> None:
    """``out[path]`` = each spec of a spec tree, under the paths that
    ``_flatten_with_paths`` gives the tree's leaves."""
    if specs is None:
        return
    if sharding.is_spec(specs):
        out[_SEP.join(keys)] = specs
    elif isinstance(specs, dict):
        for k in sorted(specs):
            _spec_paths(specs[k], keys + [str(k)], out)
    elif isinstance(specs, tuple) and hasattr(specs, "_fields"):
        for f, v in zip(specs._fields, specs):
            _spec_paths(v, keys + ["." + f], out)
    elif isinstance(specs, (list, tuple)):
        for i, v in enumerate(specs):
            _spec_paths(v, keys + [str(i)], out)
    else:
        raise ValueError(f"{_SEP.join(keys) or 'the root'}: "
                         f"{type(specs).__name__} in a tree of specs")


def _namedtuple(fields: dict):
    """The port's ``NamedTuple`` with the fewest fields that holds all of
    ``fields``; its other fields are ``None``."""
    fits = [c for c in (SgdState, AdamState, GradCompressionState, TrainState)
            if set(fields) <= set(c._fields)]
    if not fits:
        raise ValueError(f"no NamedTuple of the port has the fields "
                         f"{sorted(fields)}")
    cls = min(fits, key=lambda c: len(c._fields))
    return cls(**{f: fields.get(f) for f in cls._fields})


def _unflatten_paths(leaves: list[tuple[str, Any]]) -> PyTree:
    """The tree whose ``_flatten_with_paths`` gives ``leaves``."""
    if len(leaves) == 1 and leaves[0][0] == "":
        return leaves[0][1]                        # the tree was one leaf
    root: dict = {}
    for path, leaf in leaves:
        keys = path.split(_SEP)
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf

    def build(node):
        if not isinstance(node, dict):
            return node
        kids = {k: build(v) for k, v in node.items()}
        if kids and all(k.startswith(".") for k in kids):
            return _namedtuple({k[1:]: v for k, v in kids.items()})
        if kids and sorted(kids) == sorted(map(str, range(len(kids)))):
            return [kids[str(i)] for i in range(len(kids))]
        return kids

    return build(root)


def _sha(arr: np.ndarray) -> str:
    """The sha256 of the array's bytes in C order (the JAX package's
    ``tobytes()`` digest), read in place where the array is contiguous."""
    flat = np.ascontiguousarray(arr).reshape(-1)
    return hashlib.sha256(flat.view(np.uint8)).hexdigest()


def _shas(arrays: list) -> list:
    """``_sha`` of each array, several at once (hashlib lets go of the GIL
    while it hashes a large buffer)."""
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        return list(ex.map(_sha, arrays))


def _npz_arrays(path: str, keys: list) -> dict:
    """The arrays of an ``np.savez`` file by key, each read straight from
    its stored bytes in the file, one copy (``np.load`` reads a member in
    chunks through the zip reader and checks its CRC-32, which the
    manifest's sha256 makes redundant; on an H100 machine a 3.36 GB
    restore took twice as long).  Both packages write stored members; a
    compressed one is an ``IOError``."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for key in keys:
            info = zf.getinfo(key + ".npy")
            if info.compress_type != zipfile.ZIP_STORED:
                raise IOError(f"{path}: {key} is a compressed member")
            f.seek(info.header_offset)
            head = f.read(30)               # the member's local header
            if head[:4] != b"PK\x03\x04":
                raise IOError(f"{path}: no local header for {key}")
            name_len, extra_len = struct.unpack("<HH", head[26:30])
            f.seek(info.header_offset + 30 + name_len + extra_len)
            out[key] = np.lib.format.read_array(f)
    return out


def _fsync_write(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


class CheckpointManager:
    """Steps of a tree under ``directory``; ``device`` is where ``restore``
    puts the tensors unless it is given one (``None``: the card)."""

    def __init__(self, directory: str, retention: int = 3,
                 async_save: bool = True, device=None):
        self.dir = directory
        self.retention = retention
        self.async_save = async_save
        self.device = device
        self._thread: Optional[threading.Thread] = None
        self._save_error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- paths ---------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and ".tmp" not in name:
                try:
                    steps.append(int(name[len("step_"):]))
                except ValueError:
                    continue
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: PyTree, *, blocking: Optional[bool] = None,
             extra: Optional[dict] = None) -> None:
        """Checkpoint ``tree`` at ``step``.  The tensors are fetched to the
        host before any thread handoff, so the caller may change them
        afterwards."""
        self.wait()
        if self._save_error is not None:
            err, self._save_error = self._save_error, None
            raise RuntimeError("previous async checkpoint save failed") from err
        leaves = _flatten_with_paths(tree)
        blocking = (not self.async_save) if blocking is None else blocking
        if blocking:
            self._write(step, leaves, extra)
        else:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, leaves, extra),
                daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write_guarded(self, *args) -> None:
        try:
            self._write(*args)
        except BaseException as e:          # surfaced on the next save()
            self._save_error = e

    def _write(self, step: int, leaves, extra: Optional[dict]) -> None:
        final = self._step_dir(step)
        tmp = f"{final}.tmp.{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        shas = _shas([arr for _, arr, _ in leaves])
        manifest = {"step": step, "format": "npz-v1",
                    "extra": extra or {}, "tensors": [
                        {"path": path, "key": f"t{i}",
                         "shape": list(arr.shape), "dtype": dtype,
                         "sha256": sha}
                        for i, ((path, arr, dtype), sha)
                        in enumerate(zip(leaves, shas))]}
        _fsync_write(os.path.join(tmp, "arrays.npz"), lambda f: np.savez(
            f, **{f"t{i}": arr for i, (_, arr, _) in enumerate(leaves)}))
        _fsync_write(os.path.join(tmp, "manifest.json"), lambda f: f.write(
            json.dumps(manifest, indent=1).encode()))
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._enforce_retention()

    def _enforce_retention(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.retention] if self.retention else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ----------------------------------------------------------------
    def restore(self, step: Optional[int] = None, *, device=None,
                mesh=None, shardings=None) -> tuple[int, PyTree]:
        """Restore the given (or newest valid) step onto ``device`` (default:
        the manager's).  Corrupt or torn steps are skipped with fallback.

        ``shardings``: a tree of ``PartitionSpec``s matching the saved tree
        (over ``mesh``), or of ``sharding.NamedSharding``s (specs bound to
        a mesh): each array is placed by its spec (``sharding.place``:
        ``Sharded`` pieces, a 0-dim step counter on the mesh's first
        device), the elastic restore onto any mesh, as the JAX package's.
        Each host array is freed once its pieces exist.  A spec tree that
        does not match the saved tree, or a spec that does not divide its
        dim, is a ``ValueError``.  Without ``shardings``, ``mesh`` is not
        read."""
        candidates = ([step] if step is not None
                      else list(reversed(self.all_steps())))
        last_err: Optional[Exception] = None
        for s in candidates:
            try:
                leaves = self._read(s)
            except Exception as e:          # torn/corrupt -> try previous
                last_err = e
                continue
            if shardings is not None:
                return s, _placed(leaves, shardings, mesh)
            device = resolve_device(device if device is not None
                                    else self.device)
            return s, _unflatten_paths(
                [(p, _from_numpy(a, dtype).to(device))
                 for p, a, dtype in leaves])
        raise FileNotFoundError(
            f"no restorable checkpoint in {self.dir!r}") from last_err

    def _read(self, step: int) -> list[tuple[str, np.ndarray, str]]:
        """(path, host array, manifest dtype) of every leaf of ``step``,
        each checked against its hash."""
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        data = _npz_arrays(os.path.join(d, "arrays.npz"),
                           [t["key"] for t in manifest["tensors"]])
        leaves = [(t["path"], data.pop(t["key"]), t["dtype"])
                  for t in manifest["tensors"]]
        for t, sha in zip(manifest["tensors"],
                          _shas([arr for _, arr, _ in leaves])):
            if sha != t["sha256"]:
                raise IOError(f"hash mismatch for {t['path']} at step "
                              f"{step}")
        return leaves


def _placed(leaves: list, shardings, mesh) -> PyTree:
    """The tree of ``leaves`` ((path, host array, dtype), emptied as it
    goes) with each array placed by its spec in ``shardings``."""
    specs: dict = {}
    _spec_paths(shardings, [], specs)
    saved = [p for p, _, _ in leaves]
    if set(saved) != set(specs):
        raise ValueError(
            f"the shardings do not match the saved tree: saved but without "
            f"a spec {sorted(set(saved) - set(specs))[:4]}, a spec but not "
            f"saved {sorted(set(specs) - set(saved))[:4]}")
    out = []
    for i, (path, arr, dtype) in enumerate(leaves):
        leaves[i] = None
        spec = specs[path]
        if isinstance(spec, sharding.NamedSharding):
            at, spec = spec.mesh, spec.spec
        elif mesh is None:
            raise ValueError(f"{path}: a PartitionSpec and no mesh")
        else:
            at = mesh
        try:
            # onto the mesh's device type first: pieces move within it
            t = _from_numpy(arr, dtype).to(at.devices.flat[0])
            out.append((path, sharding.place(t, spec, at)))
            del t
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
        del arr
    return _unflatten_paths(out)


# ---------------------------------------------------------------------------
# error-bounded compressed checkpoints (the paper's technique on weights)
# ---------------------------------------------------------------------------

COMPRESSED_FORMAT = "repro-torch-gae-ckpt-v1"


def save_compressed(path: str, tree: PyTree, *, tau: float,
                    bin_size: float = 1e-4, block: int = 256,
                    min_size: int = 4096, device=None) -> dict:
    """Write an error-bounded compressed checkpoint.

    Every float tensor with >= ``min_size`` elements is blocked into
    ``block``-long vectors and encoded with the paper's PCA-GAE machinery
    (basis from the tensor's own blocks, fit and selected on ``device``, the
    card by default; top-M quantized coefficients per block; Huffman +
    index-bitmask bitstream) such that every block satisfies
    ||x - x^G||_2 <= tau on restore.  Small, non-float (bf16 among them,
    as in the JAX package) and incompressible tensors are stored raw.
    Returns size accounting {raw_bytes, compressed_bytes, ratio}.
    """
    device = resolve_device(device)
    manifest: dict[str, Any] = {"format": COMPRESSED_FORMAT, "tensors": []}
    arrays: dict[str, np.ndarray] = {}
    raw_bytes = comp_bytes = 0
    for i, (tpath, arr, dtype) in enumerate(_flatten_with_paths(tree)):
        raw_bytes += arr.nbytes
        entry: dict[str, Any] = {"path": tpath, "shape": list(arr.shape),
                                 "dtype": dtype, "kind": "raw"}
        key = f"t{i}"
        coded = None
        if arr.dtype.kind == "f" and arr.size >= min_size:
            coded = _encode_gae(arr, tau=tau, bin_size=bin_size, block=block,
                                device=device)
        if coded is None:
            arrays[f"{key}.raw"] = arr
            comp_bytes += arr.nbytes
        else:
            fields, parts, cost = coded
            entry.update(fields)
            arrays.update({f"{key}.{k}": v for k, v in parts.items()})
            comp_bytes += cost
        manifest["tensors"].append(entry)
    arrays["manifest"] = np.frombuffer(json.dumps(manifest).encode(),
                                       np.uint8)
    tmp = f"{path}.tmp.{os.getpid()}"
    _fsync_write(tmp, lambda f: np.savez(f, **arrays))
    os.replace(tmp, path)
    return {"raw_bytes": raw_bytes, "compressed_bytes": comp_bytes,
            "ratio": raw_bytes / max(comp_bytes, 1)}


def _encode_gae(arr: np.ndarray, *, tau: float, bin_size: float, block: int,
                device) -> Optional[tuple[dict, dict, int]]:
    """(manifest fields, arrays, coded bytes) of one float tensor in GAE
    blocks, or ``None`` where raw storage is the answer: an incompressible
    tensor (flat residual spectrum; the guarantee is then exactness, never
    pay for expansion), or one with more distinct coefficients than a
    16-bit prefix code holds."""
    flat = arr.astype(np.float32).reshape(-1)
    pad = -flat.size % block
    blocks = np.pad(flat, (0, pad)).reshape(-1, block)
    basis = gae.fit_pca_basis(torch.from_numpy(blocks).to(device)
                              ).cpu().numpy()
    _, codes = gae.gae_encode_blocks(blocks, np.zeros_like(blocks), basis,
                                     tau, bin_size, device=device)
    coeffs = (np.concatenate([c.qcoeffs[np.argsort(c.indices)]
                              for c in codes])
              if codes else np.zeros(0, np.int64))
    if np.unique(coeffs).size > 1 << entropy.MAX_CODE_LEN:
        return None
    stream = entropy.huffman_compress(coeffs) if coeffs.size else None
    idx_blob = entropy.encode_index_sets([np.sort(c.indices) for c in codes],
                                         block)
    binexp_blob = entropy.zlib_pack(
        np.asarray([c.bin_exp for c in codes], np.uint8).tobytes())
    cost = (basis.nbytes + (stream.nbytes() if stream else 0)
            + len(idx_blob) + len(binexp_blob))
    if cost >= arr.nbytes:
        return None
    parts = {"basis": basis, "index": np.frombuffer(idx_blob, np.uint8),
             "binexp": np.frombuffer(binexp_blob, np.uint8)}
    if stream is not None:
        parts.update(payload=np.frombuffer(stream.payload, np.uint8),
                     symbols=stream.book.symbols, lengths=stream.book.lengths)
    return (dict(kind="gae", block=block, pad=pad, tau=tau, bin_size=bin_size,
                 count=stream.count if stream else 0), parts, cost)


def restore_compressed(path: str, device=None) -> PyTree:
    """The tree ``save_compressed`` wrote, as tensors on ``device`` (the card
    by default); every GAE block is within the ``tau`` it was saved at."""
    device = resolve_device(device)
    leaves = []
    with np.load(path) as data:
        manifest = json.loads(data["manifest"].tobytes())
        if manifest.get("format") != COMPRESSED_FORMAT:
            raise ValueError(f"{path}: not a {COMPRESSED_FORMAT} checkpoint")
        for i, entry in enumerate(manifest["tensors"]):
            key = f"t{i}"
            shape = tuple(entry["shape"])
            if entry["kind"] == "raw":
                arr = data[f"{key}.raw"]
            else:
                block = entry["block"]
                index_sets = entropy.decode_index_sets(
                    data[f"{key}.index"].tobytes(), expect_dim=block)
                binexps = np.frombuffer(entropy.zlib_unpack(
                    data[f"{key}.binexp"].tobytes()), np.uint8)
                coeffs = np.zeros(0, np.int64)
                if entry["count"]:
                    book = entropy.rebuild_book(data[f"{key}.symbols"],
                                                data[f"{key}.lengths"])
                    coeffs = entropy.huffman_decode(
                        data[f"{key}.payload"].tobytes(), book,
                        entry["count"])
                codes, pos = [], 0
                for idx, be in zip(index_sets, binexps):
                    codes.append(gae.GAEBlockCode(
                        m=idx.size, indices=idx,
                        qcoeffs=coeffs[pos:pos + idx.size], bin_exp=int(be)))
                    pos += idx.size
                recon = gae.gae_decode_blocks(
                    np.zeros((len(codes), block), np.float32),
                    data[f"{key}.basis"], codes, entry["bin_size"])
                flat = recon.reshape(-1)
                if entry["pad"]:
                    flat = flat[:-entry["pad"]]
                arr = flat.astype(np.dtype(entry["dtype"])).reshape(shape)
            leaves.append((entry["path"], _from_numpy(
                np.ascontiguousarray(arr), entry["dtype"]).to(device)))
    return _unflatten_paths(leaves)
