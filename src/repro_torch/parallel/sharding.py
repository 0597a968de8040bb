"""Partition rules and placement: which mesh axis each dim of a tensor is
split over, and the pieces that split gives each mesh coordinate.

Mesh axes (``launch/mesh.py``): ``("data", "model")`` on one pod,
``("pod", "data", "model")`` across pods.  The batch shards over
``("pod", "data")`` (data parallelism), weights over ``"model"`` (tensor or
expert parallelism).  The rules are the JAX package's, copied: the port
imports nothing of it.

``shard_tensor`` and ``unshard`` take the place of ``NamedSharding`` and
``jax.device_put``: the pieces of a tensor are exactly the
``addressable_shards`` data a ``NamedSharding`` with the same spec gives
over a JAX mesh of the same shape.  ``place_tree`` puts a tree onto a mesh
by a tree of specs (a train state by ``train_state_specs``, a restored
checkpoint by the caller's), with or without FSDP's cut over ``"data"``.

The activation constraints are the JAX package's: ``constrain(x, kind)`` is
a no-op unless rules are installed with ``activation_sharding(...)``, so
one-device runs go through the same model code with no sharding machinery.
Under tensor parallelism the model code hands ``constrain`` a
``parallel.tensor.Shards`` (one piece per ``"model"`` shard), and the rule
of the call site places it: the collective that turns the pieces' layout
into the rule's runs there (``Shards.place``).
"""
from __future__ import annotations

import contextlib
import contextvars
import re
from typing import Optional

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh, check_device_type

Tensor = torch.Tensor


class PartitionSpec(tuple):
    """One entry per dim: an axis name, a tuple of axis names (the dim is
    split over their product, the first axis major) or ``None``
    (replicated).  A one-name tuple reads as the name, as JAX normalizes
    it."""

    def __new__(cls, *parts):
        def norm(p):
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                return p[0] if len(p) == 1 else p
            return p
        return super().__new__(cls, tuple(norm(p) for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# ---------------------------------------------------------------------------
# activation constraints
# ---------------------------------------------------------------------------

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("activation_rules",
                                                         default=None)


def activation_rules(multi_pod: bool, sp: bool = False,
                     kv_seq_shard: bool = False) -> dict:
    """``sp=True`` = Megatron-style sequence parallelism: residual-stream
    activations between attention/MLP blocks are sharded over the model axis
    along the SEQUENCE dim, so the TP boundary is a reduce-scatter and the
    next block's input an all-gather (half the bytes of the all-reduce it
    replaces)."""
    dp = ("pod", "data") if multi_pod else ("data",)
    return {
        "tokens": P(dp, None),                 # (B, S)
        "act_btd": P(dp, "model", None) if sp  # (B, S, D)
        else P(dp, None, None),
        "act_btf": P(dp, None, "model"),       # (B, S, F) — ffn hidden sharded
        "act_bthd": P(dp, None, "model", None),  # (B, S, H, hd) — heads sharded
        "logits": P(dp, None, "model"),        # (B, S, V) — vocab sharded
        # (B, S, KV, hd); long-context decode at batch < dp shards the
        # sequence axis instead
        "kv_cache": P(None, dp, "model", None) if kv_seq_shard
        else P(dp, None, "model", None),
        "expert_buf": P("model", None, None),  # (E, C, D)
        # the flattened (B*S, D) token table of the MoE dispatch/combine
        "tokens_flat": P(dp, None),
        "tokens_grouped": P(dp, None, None),   # (G, T/G, D) grouped dispatch
    }


@contextlib.contextmanager
def activation_sharding(rules: Optional[dict]):
    """Install ``rules`` (``activation_rules``'s dict, or ``None`` for
    none) for the calls inside the block."""
    token = _ACTIVE.set(rules)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active_rules() -> Optional[dict]:
    return _ACTIVE.get()


def constrain(x, kind: str):
    """``x`` placed by the installed rule for ``kind``: ``x`` itself
    without rules, without a rule for ``kind``, where the rule does not
    have ``x``'s number of dims, or for a tensor (one device holds it
    whole); a ``Shards`` is placed over the ``"model"`` axis as the rule
    says (``Shards.place``)."""
    rules = _ACTIVE.get()
    if rules is None or kind not in rules:
        return x
    spec = rules[kind]
    if x.ndim != len(spec) or isinstance(x, Tensor):
        return x
    return x.place(model_dim(spec))


def model_dim(spec) -> Optional[int]:
    """The dim that ``spec`` splits over ``"model"``, or ``None``."""
    for i, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        if "model" in axes:
            return i
    return None

# ---------------------------------------------------------------------------
# parameter partition rules
# ---------------------------------------------------------------------------

# (regex over the param path, spec WITHOUT the scan-stack leading axis)
_PARAM_RULES: list[tuple[str, Optional[P]]] = [
    (r"embed/w$",            P("model", None)),          # (V, D) vocab-sharded
    (r"unembed/w$",          P(None, "model")),          # (D, V)
    (r"pos_embed/w$",        P(None, None)),
    (r"(wq|wk|wv)$",         P(None, "model", None)),    # (D, H, hd) head-sharded
    (r"wo$",                 P("model", None, None)),    # (H, hd, D)
    (r"(bq|bk|bv)$",         P("model", None)),
    # MoE rules MUST precede the generic ffn rules (longest-match-first).
    (r"moe/router$",         P(None, None)),
    (r"moe/shared/(w_gate|w_in)$", P(None, "model")),    # shared expert (D, F)
    (r"moe/shared/w_out$",   P("model", None)),
    (r"moe/(w_gate|w_in)$",  P("model", None, None)),    # (E, D, F) EP
    (r"moe/w_out$",          P("model", None, None)),    # (E, F, D) EP
    (r"moe_fs/(w_gate|w_in)$", P(None, None, "model")),  # E % tp != 0: shard F
    (r"moe_fs/w_out$",       P(None, "model", None)),
    (r"(w_gate|w_in)$",      P(None, "model")),          # (D, F)
    (r"w_out$",              P("model", None)),          # (F, D)
    (r"(w_x|w_gate_branch)$", P(None, "model")),         # RG-LRU (D, lru)
    (r"(conv/w|conv/b)$",    P(None, "model")),          # (cw, lru)
    (r"lru/(alpha|in_gate/w|rec_gate/w)$", P(None, "model")),
    (r"lru/(in_gate|rec_gate)/b$", P("model",)),
    (r"lru_out$",            P("model", None)),          # (lru, D)
    (r"ssd/in_proj$",        P(None, "model")),          # (D, d_inner+...)
    (r"ssd/out_proj$",       P("model", None)),          # (d_inner, D)
    (r"ssd/conv_w$",         P(None, "model")),
    (r"ssd/(A_log|dt_bias|D|norm_scale)$", P("model",)),
    (r"(scale|bias|b_in|b_out|gate)$", None),            # norms / biases: replicated
]

SCANNED_PREFIXES = ("layers", "triples", "groups", "selfs", "enc_layers",
                    "dec_layers", "tail")


def param_spec_for_path(path: str, ndim: int, *, scanned: int = 0) -> P:
    """Match a parameter path to its PartitionSpec; prepend one unsharded axis
    per stacked-layer level (``scanned`` — the VLM has nested groups/selfs
    stacks = 2); fall back to replication."""
    for pattern, spec in _PARAM_RULES:
        if re.search(pattern, path):
            parts = list(spec) if spec is not None else []
            break
    else:
        parts = []
    parts = [None] * scanned + parts
    parts = parts[:ndim] + [None] * (ndim - len(parts))
    return P(*parts)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over the leaves of nested dicts, lists and tuples
    (``NamedTuple``s rebuilt); ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, path + (str(i),))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn("/".join(path), tree)


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def stack_depth(path: str,
                scanned_prefixes: tuple = SCANNED_PREFIXES) -> int:
    """How many stacked-layer axes lead a param at ``path`` (the VLM's
    ``groups/selfs``: 2)."""
    return sum(seg in scanned_prefixes for seg in path.split("/"))


def param_partition_specs(params, scanned_prefixes: tuple = SCANNED_PREFIXES,
                          *, fsdp_axis: Optional[str] = None,
                          fsdp_size: int = 0, min_fsdp_elems: int = 65536,
                          tp_size: int = 0):
    """PartitionSpec tree matching ``params`` (the port's param tree, whose
    paths are the JAX package's).

    Leaves under any of ``scanned_prefixes`` carry a leading stacked-layer
    axis that is never sharded.  ``tp_size`` > 1 turns on the MoE fallback:
    where the expert count does not divide the model axis (granite: 40 %
    16 != 0), the per-expert ffn dim is sharded instead of the expert axis.
    ``fsdp_axis`` (fully sharded params) additionally shards the first
    unsharded feature dim divisible by ``fsdp_size`` of every leaf with at
    least ``min_fsdp_elems`` elements; the stacked-layer axis is never
    chosen.
    """
    def spec(p: str, leaf) -> P:
        shape = _shape(leaf)
        n_stack = stack_depth(p, scanned_prefixes)
        parts = list(param_spec_for_path(p, len(shape), scanned=n_stack))
        if tp_size > 1 and re.search(r"moe/w_(gate|in|out)$", p):
            e_dim = n_stack
            if shape[e_dim] % tp_size != 0:
                parts[e_dim] = None
                f_dim = len(parts) - (2 if p.endswith("w_out") else 1)
                parts[f_dim] = "model"
        if (fsdp_axis and fsdp_size > 1 and len(shape) >= 2
                and int(np.prod(shape)) >= min_fsdp_elems):
            for i in range(n_stack, len(parts)):
                if parts[i] is None and shape[i] % fsdp_size == 0:
                    parts[i] = fsdp_axis
                    break
        return P(*parts)

    return _map_with_path(spec, params)


def batch_spec(multi_pod: bool) -> P:
    return P(("pod", "data") if multi_pod else ("data",), None)


# ---------------------------------------------------------------------------
# decode-state partition rules
# ---------------------------------------------------------------------------

def decode_state_specs(state_shapes, multi_pod: bool, *, batch: int,
                       dp_size: int, seq_len: int = 0, tp_size: int = 16):
    """PartitionSpec tree for a model's decode state (leaves with a
    ``shape``: tensors, meta tensors; ints read as 0-dim).

    The rules are SHAPE-driven, as the JAX package's:

      * a leaf with an axis == ``seq_len`` -> KV-style cache
        (..., B, S, KV, hd): dp on the batch axis, "model" on the KV-head
        axis where it divides tp, hd replicated;
      * any other leaf with an axis == ``batch`` -> per-batch recurrent
        state: dp on the batch axis, "model" on the first later axis
        divisible by tp;
      * everything else (positions, scalars) -> replicated.

    When ``batch < dp_size`` the data axis cannot shard the batch: KV
    caches shard the sequence axis over it instead (sequence parallelism)
    and other per-batch state is replicated.
    """
    dp = ("pod", "data") if multi_pod else ("data",)
    seq_shard = batch < dp_size

    def spec(_path, leaf) -> P:
        shape = _shape(leaf)
        ndim = len(shape)
        if ndim == 0:
            return P()
        parts: list = [None] * ndim
        s_idx = next((i for i, d in enumerate(shape)
                      if seq_len and d == seq_len), None)
        b_idx = next((i for i, d in enumerate(shape) if d == batch), None)
        if s_idx is not None and ndim >= 3:
            kv_idx = s_idx + 1 if s_idx + 1 < ndim else None
            if seq_shard:
                parts[s_idx] = dp
            elif b_idx is not None and b_idx < s_idx:
                parts[b_idx] = dp
            if kv_idx is not None and shape[kv_idx] % tp_size == 0:
                parts[kv_idx] = "model"
            return P(*parts)
        if b_idx is not None and ndim >= 2:
            if not seq_shard:
                parts[b_idx] = dp
            for i in range(b_idx + 1, ndim):
                if shape[i] % tp_size == 0:
                    parts[i] = "model"
                    break
        return P(*parts)

    return _map_with_path(spec, state_shapes)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def _dim_axes(spec, ndim: int, mesh: Mesh) -> list:
    """For each dim, the mesh axes (a tuple, maybe empty) it is split
    over."""
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{ndim} dims")
    out, seen = [], set()
    for entry in spec + (None,) * (ndim - len(spec)):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        for a in axes:
            if a not in mesh.axis_names or a in seen:
                raise ValueError(f"spec {spec}: axis {a!r} is not in the "
                                 f"mesh {mesh.axis_names} or is used twice")
            seen.add(a)
        out.append(axes)
    return out


def _split(axes: tuple, coord: tuple, mesh: Mesh) -> tuple[int, int]:
    """(index of ``coord``'s piece, number of pieces) along a dim split
    over ``axes``."""
    idx, k = 0, 1
    for a in axes:
        i = mesh.axis_names.index(a)
        idx = idx * mesh.devices.shape[i] + coord[i]
        k *= mesh.devices.shape[i]
    return idx, k


def shard_tensor(t: Tensor, spec, mesh: Mesh) -> np.ndarray:
    """The piece of ``t`` each mesh coordinate holds under ``spec``, on the
    coordinate's device: an object ndarray of the mesh's shape.

    A dim split k ways must be a multiple of k (a ``ValueError`` else, as
    JAX refuses it).  On ``t``'s own device a piece is a view of ``t``; to
    another device it is copied once per (device, piece), whatever the
    number of coordinates holding it.
    """
    check_device_type(mesh, t.device)
    dim_axes = _dim_axes(spec, t.ndim, mesh)
    home = torch.device(t.device)
    pieces = np.empty(mesh.devices.shape, dtype=object)
    copies: dict = {}
    for coord in np.ndindex(mesh.devices.shape):
        piece, bounds = t, []
        for dim, axes in enumerate(dim_axes):
            if not axes:
                continue
            idx, k = _split(axes, coord, mesh)
            if t.shape[dim] % k:
                raise ValueError(f"spec {tuple(spec)} splits dim {dim} of "
                                 f"shape {tuple(t.shape)} {k} ways, which "
                                 f"does not divide it")
            c = t.shape[dim] // k
            piece = piece.narrow(dim, idx * c, c)
            bounds.append((dim, idx))
        dev = mesh.devices[coord]
        if dev != home:
            key = (dev, tuple(bounds))
            if key not in copies:
                copies[key] = piece.to(dev, non_blocking=True)
            piece = copies[key]
        pieces[coord] = piece
    return pieces


def unshard(pieces: np.ndarray, spec, mesh: Mesh) -> Tensor:
    """The logical tensor of ``pieces`` (as ``shard_tensor`` gives them),
    on the device of the piece at coordinate 0."""
    pieces = np.asarray(pieces, dtype=object)
    first = pieces.flat[0]
    dim_axes = _dim_axes(spec, first.ndim, mesh)
    return _join(pieces, dim_axes, mesh, 0, [0] * mesh.devices.ndim,
                 first.device)


def _join(pieces: np.ndarray, dim_axes: list, mesh: Mesh, dim: int,
          coord: list, home: torch.device) -> Tensor:
    """The pieces from ``coord`` on, concatenated along ``dim`` and the
    dims after it."""
    if dim == len(dim_axes):
        return pieces[tuple(coord)].to(home)
    axes = dim_axes[dim]
    if not axes:
        return _join(pieces, dim_axes, mesh, dim + 1, coord, home)
    sizes = [mesh.devices.shape[mesh.axis_names.index(a)] for a in axes]
    parts = []
    for sub in np.ndindex(*sizes):
        c = list(coord)
        for a, i in zip(axes, sub):
            c[mesh.axis_names.index(a)] = i
        parts.append(_join(pieces, dim_axes, mesh, dim + 1, c, home))
    return torch.cat(parts, dim=dim)


# ---------------------------------------------------------------------------
# trees held as pieces (tensor parallelism's params and moments)
# ---------------------------------------------------------------------------

class Sharded:
    """A tensor held as pieces over a mesh, as ``shard_tensor`` cuts it by
    ``spec``: ``pieces`` is an object ndarray of the mesh's shape.  Each
    piece is a tensor of its own (never a view of a whole tensor), and the
    coordinates that hold the same slice on the same device share one."""

    __slots__ = ("pieces", "spec", "mesh")

    def __init__(self, pieces: np.ndarray, spec, mesh: Mesh):
        self.pieces, self.spec, self.mesh = pieces, P(*spec), mesh

    @property
    def shape(self) -> tuple:
        """The whole tensor's shape: each piece's, times the number of
        pieces along each split dim."""
        first = self.pieces.flat[0]
        return tuple(n * int(np.prod([self.mesh.shape[a] for a in axes]))
                     for n, axes in zip(first.shape, _dim_axes(
                         self.spec, first.ndim, self.mesh)))

    def split_dims(self) -> list:
        """The dims that the mesh cuts into more than one piece."""
        first = self.pieces.flat[0]
        return [d for d, axes in enumerate(_dim_axes(self.spec, first.ndim,
                                                     self.mesh))
                if int(np.prod([self.mesh.shape[a] for a in axes])) > 1]

    def slice_key(self, coord: tuple) -> tuple:
        """Which slice of the whole the piece at ``coord`` is: its index
        along each split dim."""
        return tuple(_split(axes, coord, self.mesh)[0] for axes in
                     _dim_axes(self.spec, len(self.spec), self.mesh) if axes)

    def owners(self) -> list:
        """``(coord, piece)`` of each distinct piece, at the first
        coordinate (row-major) that holds it."""
        seen, out = set(), []
        for coord in np.ndindex(self.pieces.shape):
            p = self.pieces[coord]
            if id(p) not in seen:
                seen.add(id(p))
                out.append((coord, p))
        return out

    def map(self, fn) -> "Sharded":
        """``fn`` of each distinct piece, at the same coordinates."""
        out = np.empty(self.pieces.shape, dtype=object)
        done: dict = {}
        for coord in np.ndindex(self.pieces.shape):
            p = self.pieces[coord]
            if id(p) not in done:
                done[id(p)] = fn(p)
            out[coord] = done[id(p)]
        return Sharded(out, self.spec, self.mesh)

    def host(self) -> Tensor:
        """The whole tensor on the CPU (each piece copied there once)."""
        return unshard(self.map(lambda p: p.detach().to("cpu")).pieces,
                       self.spec, self.mesh)


def shard_leaf(t: Tensor, spec, mesh: Mesh) -> Sharded:
    """``t`` as a ``Sharded`` over ``mesh``: ``shard_tensor``'s pieces,
    each slice of ``t`` that is a view on ``t``'s device copied once, so
    that ``t`` itself may be freed; a piece that is ``t`` (a replicated
    leaf on its own device) stays ``t``."""
    pieces = shard_tensor(t, spec, mesh)
    out = Sharded(np.empty(mesh.devices.shape, dtype=object), spec, mesh)
    own: dict = {}
    for coord in np.ndindex(pieces.shape):
        p = pieces[coord]
        key = (mesh.devices[coord], out.slice_key(coord))
        if key not in own:
            shares = (p is not t and p.device == t.device
                      and p.untyped_storage().data_ptr()
                      == t.untyped_storage().data_ptr())
            own[key] = p.clone() if shares else p
        out.pieces[coord] = own[key]
    return out


def place(t: Tensor, spec, mesh: Mesh):
    """``t`` placed on ``mesh`` by ``spec``: a ``Sharded`` (``shard_leaf``),
    or, for a 0-dim tensor (a step counter), the tensor on the mesh's first
    device, where every shard reads it (its spec must be ``P()``)."""
    if t.ndim == 0:
        if any(e is not None for e in spec):
            raise ValueError(f"spec {tuple(spec)} cuts a 0-dim tensor")
        return t.to(mesh.devices.flat[0])
    return shard_leaf(t, spec, mesh)


class NamedSharding:
    """A spec bound to a mesh, as ``jax.sharding.NamedSharding``: a leaf of
    a spec tree that names its own mesh."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: Mesh, spec):
        self.mesh, self.spec = mesh, P(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.shape}, {self.spec!r})"


def is_spec(x) -> bool:
    """Whether ``x`` is a leaf of a spec tree."""
    return isinstance(x, (PartitionSpec, NamedSharding))


def place_tree(tree, specs, mesh: Optional[Mesh] = None, path: str = ""):
    """``tree`` (tensors in dicts, lists and ``NamedTuple``s) with each
    tensor ``place``d by the spec at its place in ``specs``, over ``mesh``
    or the mesh of a ``NamedSharding``.  A ``ValueError`` names the first
    place where the two trees differ, and a spec that does not divide its
    dim (``shard_tensor``)."""
    where = path or "the tree's root"
    if is_spec(specs):
        if not isinstance(tree, Tensor):
            raise ValueError(f"{where}: a spec {specs!r} where the tree "
                             f"holds {type(tree).__name__}")
        if isinstance(specs, NamedSharding):
            mesh, specs = specs.mesh, specs.spec
        if mesh is None:
            raise ValueError(f"{where}: a PartitionSpec without a mesh")
        return place(tree, specs, mesh)
    if tree is None or specs is None:
        if tree is None and specs is None:
            return None
        raise ValueError(f"{where}: the tree holds {type(tree).__name__} "
                         f"where the specs hold {type(specs).__name__}")
    if isinstance(tree, dict):
        if not isinstance(specs, dict) or set(tree) != set(specs):
            theirs = (sorted(specs) if isinstance(specs, dict)
                      else type(specs).__name__)
            raise ValueError(f"{where}: keys {sorted(tree)} against the "
                             f"specs' {theirs}")
        return {k: place_tree(v, specs[k], mesh, f"{path}/{k}")
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        if getattr(specs, "_fields", None) != tree._fields:
            raise ValueError(f"{where}: {type(tree).__name__} against the "
                             f"specs' {type(specs).__name__}")
        return type(tree)(*(place_tree(v, o, mesh, f"{path}/.{f}")
                            for f, v, o in zip(tree._fields, tree, specs)))
    if isinstance(tree, (list, tuple)):
        if not isinstance(specs, (list, tuple)) or len(specs) != len(tree):
            raise ValueError(f"{where}: {len(tree)} items against the "
                             f"specs' {type(specs).__name__}")
        return type(tree)(place_tree(v, o, mesh, f"{path}/{i}")
                          for i, (v, o) in enumerate(zip(tree, specs)))
    raise ValueError(f"{where}: a {type(tree).__name__} where the specs "
                     f"hold {type(specs).__name__}")


def shard_params(params, mesh: Mesh, tp_size: int):
    """``params`` (or a tree of their shapes, Adam's moments) as a tree of
    ``Sharded`` leaves, by ``param_partition_specs(params,
    tp_size=tp_size)``; FSDP's placement is ``train_state_specs(...,
    fsdp=True)`` through ``place_tree``."""
    return place_tree(params, param_partition_specs(params, tp_size=tp_size),
                      mesh)


def train_state_specs(state, mesh: Mesh, *, fsdp: bool = False,
                      min_fsdp_elems: int = 65536):
    """The train state of specs that the JAX package's dry run builds for
    its ``in_shardings`` (``launch/dryrun.py``): the params and each of the
    optimizer's param-shaped trees by ``param_partition_specs`` at the
    mesh's model axis (with ``fsdp``, also cut over ``"data"``), the step
    counters replicated; the compression's error buffers as the params,
    its basis replicated.  ``state`` is a ``train.loop.TrainState`` of
    tensors or of ``Sharded`` leaves (their whole shapes are read)."""
    pspecs = param_partition_specs(
        state.params, tp_size=mesh.shape.get("model", 1),
        fsdp_axis="data" if fsdp else None,
        fsdp_size=mesh.shape.get("data", 1), min_fsdp_elems=min_fsdp_elems)
    opt = state.opt
    gc = state.gc
    if gc is not None:
        gc = gc._replace(basis=P(), error=pspecs, step=P())
    return state._replace(
        params=pspecs, opt=type(opt)(*(P() if f == "step" else pspecs
                                       for f in opt._fields)),
        gc=gc, step=P())


def spec_axes(spec) -> set:
    """The mesh axes that ``spec`` names."""
    out = set()
    for entry in spec:
        out |= {entry} if isinstance(entry, str) else set(entry or ())
    return out


def unshard_params(tree):
    """A tree of ``Sharded`` leaves as whole tensors on the device of each
    leaf's first piece."""
    return map_sharded(lambda s: unshard(s.pieces, s.spec, s.mesh), tree)


def map_sharded(fn, tree, *, with_path: bool = False):
    """``fn`` of each ``Sharded`` leaf of ``tree`` (``fn(path, leaf)`` with
    ``with_path``); other leaves as they are."""
    if with_path:
        return _map_with_path(lambda p, x: fn(p, x)
                              if isinstance(x, Sharded) else x, tree)
    return _map_with_path(lambda _p, x: fn(x) if isinstance(x, Sharded)
                          else x, tree)


def sharded_leaves(tree) -> list:
    """The ``Sharded`` leaves of ``tree`` in ``jax.tree.leaves`` order
    (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in sharded_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in sharded_leaves(item)]
    return [tree] if isinstance(tree, Sharded) else []

