"""Tensor parallelism of the LMs in one process: the pieces that a mesh
row's ``"model"`` shards hold, and the vocab-parallel embedding, head and
cross-entropy.

The JAX package writes its model code once and GSPMD shards it: weights by
``param_partition_specs`` over the ``"model"`` axis, activations where
``constrain`` pins them.  The port runs the same model code on a
:class:`Shards`, one value per model shard on the shard's device (as the
compress mesh and the data-parallel step, one process over a mesh whose
devices may repeat).  Functions marked :func:`shardwise` (the norms, the
attention and MLP blocks) run on each shard's piece; their outputs are
partial sums where the block's weights are split over the contracted dim
(Megatron's column-then-row split), and the rule at the next ``constrain``
turns them into what it names: an all-reduce for a replicated activation, a
reduce-scatter for a sequence-split one (``sp``), nothing for the
vocab-split logits (``Shards.place``).  :func:`whole` is the all-gather of a
split block input.  Where JAX's contiguous cut of a packed weight does not
line up with a shard's work (Mamba-2's ``in_proj``), :func:`gather_pick`
gathers the weight and each shard takes its columns; a norm over a split
width sums its squares across the shards (:func:`sum_of_squares`).  The
collectives are ``parallel.collectives``'s, logged and differentiable.

Nothing here holds state: a ``Shards`` is made by the train step or the
caller that shards the params (``sharding.shard_params``), and a one-device
tensor goes through every function here untouched.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import torch

from repro_torch.parallel import collectives

Tensor = torch.Tensor

REPLICATED, PARTIAL = "replicated", "partial"


class Shards:
    """One value per model shard, ``pieces[s]`` on ``devices[s]``, and how
    the pieces make the whole (``layout``):

    * ``"replicated"``: each piece is the whole;
    * ``"partial"``: the whole is the sum of the pieces (a block's output
      before its boundary);
    * an int ``d``: the whole is the pieces joined along dim ``d`` in shard
      order;
    * ``None``: there is no whole (each shard's params, a per-shard tree).

    Indexing, ``to``, ``reshape`` and the other tensor methods run on each
    piece; on a split value only the ones that keep every dim where it is
    (``to``, ``float``, ``detach``) do."""

    __slots__ = ("pieces", "layout", "devices")
    _KEEP_DIMS = ("to", "float", "detach", "contiguous")

    def __init__(self, pieces: Sequence, layout, devices: Sequence):
        if len(pieces) != len(devices):
            raise ValueError(f"{len(pieces)} pieces for {len(devices)} "
                             f"shards")
        self.pieces, self.layout = list(pieces), layout
        self.devices = [torch.device(d) for d in devices]

    def __repr__(self) -> str:
        return f"Shards({len(self.pieces)} pieces, layout={self.layout!r})"

    @property
    def ndim(self) -> int:
        return self.pieces[0].ndim

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0].dtype

    @property
    def shape(self) -> tuple:
        """The whole's shape."""
        shape = list(self.pieces[0].shape)
        if isinstance(self.layout, int):
            shape[self.layout] *= len(self.pieces)
        return tuple(shape)

    def _same(self, pieces: list, keeps_dims: bool = True) -> "Shards":
        if isinstance(self.layout, int) and not keeps_dims:
            raise NotImplementedError(
                f"an op that moves dims on a value split along dim "
                f"{self.layout}: gather it first (tensor.whole)")
        return Shards(pieces, self.layout, self.devices)

    def __getattr__(self, name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        vals = [getattr(p, name) for p in self.pieces]
        keeps = name in self._KEEP_DIMS
        if not callable(vals[0]):
            return self._same(vals, keeps)
        return lambda *a, **k: self._same([v(*a, **k) for v in vals], keeps)

    def __getitem__(self, key):
        return self._same([p[key] for p in self.pieces], keeps_dims=False)

    def __add__(self, other: "Shards") -> "Shards":
        if not isinstance(other, Shards) or other.layout != self.layout:
            raise ValueError(f"add of shards laid out {self.layout!r} and "
                             f"{getattr(other, 'layout', other)!r}")
        return self._same([a + b for a, b in zip(self.pieces, other.pieces)])

    def place(self, dim: Optional[int]) -> "Shards":
        """This value whole on every shard (``dim`` None) or split along
        ``dim``, through the collective the two layouts need: a partial sum
        is all-reduced or reduce-scattered, a split value all-gathered, a
        whole one cut (no transfer)."""
        n, devs = len(self.pieces), self.devices
        if self.layout == PARTIAL:
            pieces = (collectives.all_reduce(self.pieces, "sum", devs)
                      if dim is None
                      else collectives.reduce_scatter(self.pieces, dim, devs))
        elif self.layout == REPLICATED:
            if dim is None:
                return self
            size = self.pieces[0].shape[dim]
            if size % n:
                raise ValueError(f"dim {dim} of {tuple(self.shape)} does "
                                 f"not split into {n} shards")
            c = size // n
            pieces = [p.narrow(dim, s * c, c)
                      for s, p in enumerate(self.pieces)]
        elif self.layout == dim:
            return self
        elif isinstance(self.layout, int) and dim is None:
            pieces = collectives.all_gather(self.pieces, self.layout, devs)
        else:
            raise NotImplementedError(f"placing shards laid out "
                                      f"{self.layout!r} along dim {dim}")
        return Shards(pieces, REPLICATED if dim is None else dim, devs)


def _pick(arg, s: int, device, moved: dict):
    """Shard ``s``'s argument: its piece of a ``Shards``, a tensor on its
    device (one copy a device), anything else as it is."""
    if isinstance(arg, Shards):
        return arg.pieces[s]
    if isinstance(arg, Tensor):
        key = (id(arg), device)
        if key not in moved:
            moved[key] = arg.to(device)
        return moved[key]
    if isinstance(arg, (list, tuple)):
        return type(arg)(_pick(a, s, device, moved) for a in arg)
    return arg


def _shards_of(args) -> Optional[Shards]:
    for a in args:
        if isinstance(a, Shards):
            return a
        if isinstance(a, (list, tuple)):
            found = _shards_of(a)
            if found is not None:
                return found
    return None


def _layouts(args) -> set:
    out = set()
    for a in args:
        if isinstance(a, Shards) and a.layout is not None:
            out.add(a.layout)
        elif isinstance(a, (list, tuple)):
            out |= _layouts(a)
    return out


def each(fn: Callable, *args, layout=None, indexed: bool = False, **kw):
    """``fn`` on each shard's piece of every ``Shards`` argument (tensors
    go to the shard's device), as a ``Shards`` laid out as ``layout`` says
    (``PARTIAL`` for a block whose weights are split over the contracted
    dim, the split dim for one split over an output dim), or by default as
    its ``Shards`` arguments are (they must agree).  ``indexed`` passes the
    shard's index as ``fn``'s first argument.  Without a ``Shards``
    argument it is ``fn(*args, **kw)``."""
    first = _shards_of(list(args) + list(kw.values()))
    if first is None:
        return fn(0, *args, **kw) if indexed else fn(*args, **kw)
    if layout is None:
        layouts = _layouts(list(args) + list(kw.values()))
        if len(layouts) > 1:
            raise ValueError(f"{getattr(fn, '__name__', fn)} of shards laid "
                             f"out {sorted(map(str, layouts))}")
        layout = next(iter(layouts), None)
    moved: dict = {}
    pieces = []
    for s, dev in enumerate(first.devices):
        a = [_pick(x, s, dev, moved) for x in args]
        k = {name: _pick(x, s, dev, moved) for name, x in kw.items()}
        pieces.append(fn(s, *a, **k) if indexed else fn(*a, **k))
    return Shards(pieces, layout, first.devices)


def shardwise(layout=None) -> Callable:
    """Decorator: the function runs on each shard's piece when it is handed
    a ``Shards`` (``each``, with ``layout``), and as it is otherwise."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            return each(fn, *args, layout=layout, **kw)
        return inner
    return wrap


def whole(x):
    """``x`` whole on every shard: the all-gather of a split value, the
    all-reduce of a partial sum; a tensor or a replicated value as it
    is."""
    return x.place(None) if isinstance(x, Shards) else x


def replicate(x: Tensor, like):
    """The tensor ``x`` whole on every shard of ``like`` (one copy a
    device), for a block input that no collective makes (whisper's
    frames); ``x`` itself where ``like`` is not a ``Shards``."""
    if not isinstance(like, Shards):
        return x
    moved: dict = {}
    return Shards([_pick(x, s, d, moved) for s, d in enumerate(like.devices)],
                  REPLICATED, like.devices)


def gather_pick(w, pick: Callable):
    """A weight whose last dim the shards hold in contiguous cuts that do
    not line up with what each shard computes (the packed projections of
    ``ssd/in_proj`` and ``ssd/conv_w``): one all-gather of the cuts, then
    shard ``s`` takes ``pick(s, n, whole)``.  The all-gather's backward sums
    every shard's gradient onto each cut.  A tensor (one device) as it
    is."""
    if not isinstance(w, Shards):
        return w
    n = len(w.pieces)
    full = collectives.all_gather(w.pieces, w.ndim - 1, w.devices)
    return Shards([pick(s, n, f) for s, f in enumerate(full)], None,
                  w.devices)


def sum_of_squares(x: Shards) -> Shards:
    """The float32 sum of squares of ``x`` over its last dim, which the
    shards split, as (..., 1) whole on every shard: each shard's own sum,
    then one all-reduce."""
    return whole(each(lambda t: torch.square(t.to(torch.float32)).sum(
        -1, keepdim=True), x, layout=PARTIAL))


def gather(x):
    """``x`` as one tensor on the first shard's device (one all-gather or
    all-reduce there); a tensor as it is."""
    if not isinstance(x, Shards):
        return x
    home = x.devices[:1]
    if x.layout == REPLICATED:
        return x.pieces[0]
    if x.layout == PARTIAL:
        return collectives.all_reduce(x.pieces, "sum", home)[0]
    return collectives.all_gather(x.pieces, x.layout, home)[0]


# ---------------------------------------------------------------------------
# vocab-parallel embedding, head and cross-entropy
# ---------------------------------------------------------------------------

def embed(params: Shards, tokens: Tensor) -> Shards:
    """The embedding of ``tokens`` from vocab-split rows (``embed/w``'s
    pieces, (V / N, D) each): each shard looks up the tokens in its range
    and gives 0 for the others, so the pieces are a partial sum that holds
    each row once."""
    def lookup(s, p, tok):
        w = p["w"]
        local = tok - s * w.shape[0]
        inside = (local >= 0) & (local < w.shape[0])
        rows = w[local.clamp(0, w.shape[0] - 1)]
        return torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return each(lookup, params, tokens, layout=PARTIAL, indexed=True)


def vocab_parallel_nll(logits: Shards, labels: Tensor, vocab: int
                       ) -> tuple[Tensor, Tensor]:
    """``models.common._nll`` of vocab-split float32 logits, on the first
    shard's device, with no shard ever holding all of a row: the rows'
    max is all-reduced (max; it only steadies the exponentials, so it
    carries no gradient), then each shard's sum of exponentials and its
    part of the labels' logits (0 outside its range) in one all-reduce
    (sum).  Labels outside [0, vocab) are masked."""
    devs = logits.devices
    z = logits.pieces
    m = collectives.all_reduce([p.detach().amax(-1) for p in z], "max", devs)
    sums, golds = [], []
    for s, (p, mx) in enumerate(zip(z, m)):
        v = p.shape[-1]
        local = labels.to(p.device).long() - s * v
        inside = (local >= 0) & (local < v)
        g = torch.gather(p, -1, local.clamp(0, v - 1)[..., None])[..., 0]
        golds.append(torch.where(inside, g, torch.zeros_like(g)))
        sums.append(torch.exp(p - mx[..., None]).sum(-1))
    (se, gold), = collectives.all_reduce(
        [(a, b) for a, b in zip(sums, golds)], "sum", devs[:1])
    labels = labels.to(devs[0])
    logz = m[0] + torch.log(se)
    mask = (labels >= 0) & (labels < vocab)
    nll = torch.where(mask, logz - gold, torch.zeros_like(logz))
    return nll.sum(), mask.sum()
