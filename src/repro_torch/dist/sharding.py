"""Sharding policy — the single place mesh-axis decisions live — and the
key-space hash of the speed layer.

The reference's ``repro.dist.sharding``, both halves.

**Key space** (host-side): the hash the KV store and the speed-layer worker
router share, so "the worker that owns an entity's KV shard" is a
well-defined statement (see ``serve/kvstore.py`` and ``stream/workers.py``).

**Device mesh**: the reference's policy, line for line, over the port's own
:class:`P` (a ``PartitionSpec``-like tuple: per tensor dim ``None``, a mesh
axis name, or a tuple of them) and any mesh with ``axis_names`` and a
``shape`` mapping axis name -> size (``launch.mesh.Mesh``).  Two
mechanisms, both *divisibility-safe* via :func:`resolve_spec` (a mesh axis
is dropped — replicated — when it does not divide the dimension, so every
config shards on every mesh factorization):

* **Entry shardings** (``param_sharding`` / ``batch_sharding`` /
  ``cache_sharding``): a tree of resolved specs, which the step builders in
  ``launch/steps.py`` turn into ``DTensor`` placements
  (:func:`spec_placements`) on a mesh of more than one device.
* **In-body hints** (``shard_hint`` / ``shard_spec``): redistribute a
  ``DTensor`` inside the step, where the reference puts a
  with-sharding constraint.  They do nothing until a step builder calls
  :func:`enable_sharding_hints` with the active mesh, and they return a
  plain tensor unchanged, so the one-card and CPU paths never see them.

Layout policy:

* train:  FSDP (params shard the penultimate dim over ``data``) + TP
  (last dim over ``model``); optimizer moments inherit (steps.py).
* serve:  TP only — the last dim shards over ``model``, everything else is
  replicated so decode never all-gathers weights across ``data``.
* serve_ws (weight-stationary decode): weights keep the *train* layout and
  the decode batch shards over the ``model`` axis instead — steps.py flips
  the batch axes through ``enable_sharding_hints(mesh, batch_axes=...)``.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.params import tree_leaves, tree_map

# ---------------------------------------------------------------------------
# key-space sharding (host-side)
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def splitmix64(x: int) -> int:
    """Full splitmix64 avalanche — uniform over arbitrary integer keys."""
    x = (int(x) + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stable_shard(key: int, num_shards: int) -> int:
    """Deterministic shard of ``key`` over ``num_shards`` buckets."""
    return (splitmix64(key) >> 32) % num_shards


def rendezvous_shard(key: int, num_shards: int) -> int:
    """Highest-random-weight (rendezvous) shard of ``key``.

    Unlike modulo placement, growing ``num_shards`` by one moves only
    ~1/(n+1) of the keys — and every moved key lands on the *new* shard,
    never migrating between surviving shards.  That minimal-movement
    property is what lets the speed-layer worker pool reshard explicitly
    (``ShardRouter.reshard``) without invalidating most workers' warm
    state.  O(num_shards) per lookup; shard counts here are small.
    """
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    k = int(key)
    best, best_w = 0, -1
    for s in range(num_shards):
        w = splitmix64(k ^ splitmix64(s))
        if w > best_w:
            best, best_w = s, w
    return best


# H100 SXM per-card HBM (80 GB, NVIDIA's data sheet); used by the serve_auto
# heuristic (_fits_tp_only)
HBM_BYTES_PER_CHIP = 80e9
_HBM_HEADROOM = 0.6       # leave room for activations / cache / workspace

# Active-mesh context for in-body hints.  A plain module dict (not a
# threading.local): the step functions arm it for the duration of a call,
# on the calling thread, as the reference's builders arm it before tracing.
_HINT_CTX: dict = {"mesh": None, "batch_axes": None}

_DEFAULT_BATCH_AXES = ("pod", "data")


class P(tuple):
    """A partition spec: one entry per tensor dim, ``None`` (replicated), a
    mesh axis name, or a tuple of names (the dim sharded over their
    product, the first the major one), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def enable_sharding_hints(mesh, batch_axes=None) -> None:
    """Arm ``shard_hint``/``shard_spec`` with ``mesh`` (``None`` disarms).

    ``batch_axes`` overrides which mesh axes the batch dimension shards
    over (the weight-stationary decode layout passes ``("model",)``);
    ``None`` restores the default data-parallel axes.
    """
    _HINT_CTX["mesh"] = mesh
    _HINT_CTX["batch_axes"] = tuple(batch_axes) if batch_axes else None


@contextlib.contextmanager
def sharding_hints(mesh, batch_axes=None):
    """:func:`enable_sharding_hints` for the ``with`` block, the previous
    state restored after it (the step functions of ``launch.steps`` arm the
    hints for their own call only)."""
    saved = dict(_HINT_CTX)
    enable_sharding_hints(mesh, batch_axes)
    try:
        yield
    finally:
        _HINT_CTX.update(saved)


def _batch_axes(mesh) -> tuple:
    """Mesh axes the global batch shards over, in mesh order."""
    if _HINT_CTX["batch_axes"] is not None:
        return tuple(a for a in _HINT_CTX["batch_axes"] if a in mesh.axis_names)
    return tuple(a for a in mesh.axis_names if a in _DEFAULT_BATCH_AXES)


def model_axis_size() -> int:
    mesh = _HINT_CTX["mesh"]
    if mesh is None or "model" not in mesh.axis_names:
        return 1
    return int(mesh.shape["model"])


# ---------------------------------------------------------------------------
# divisibility-safe spec resolution
# ---------------------------------------------------------------------------

def _axes_size(mesh, entry) -> int | None:
    """Product of the named mesh axes; None when any axis is absent from
    the mesh (the spec entry must then be dropped, not crash)."""
    axes = entry if isinstance(entry, tuple) else (entry,)
    size = 1
    for a in axes:
        if a not in mesh.axis_names:
            return None
        size *= int(mesh.shape[a])
    return size


def resolve_spec(mesh, shape, spec: P) -> P:
    """Align ``spec`` to the trailing dims of ``shape`` and drop (replicate)
    every entry whose mesh axes are absent or whose product does not divide
    the dimension.

    Leading stack dims (e.g. the layer axis of a stacked cache) get ``None``
    padding, so one spec written for a single layer's array also applies to
    the [L, ...] stacked version.
    """
    entries = list(spec)
    if len(entries) > len(shape):
        # spec written for a higher-rank array: keep the trailing entries
        entries = entries[len(entries) - len(shape):]
    offset = len(shape) - len(entries)
    out = [None] * offset
    for dim, entry in zip(shape[offset:], entries):
        size = None if entry is None else _axes_size(mesh, entry)
        if size is not None and int(dim) % size == 0:
            out.append(entry)
        else:
            out.append(None)
    return P(*out)


def spec_placements(mesh, spec: P) -> tuple:
    """The ``DTensor`` placements, one per mesh axis, of a resolved spec:
    ``Shard(i)`` on every mesh axis that tensor dim ``i`` is sharded over
    (``("pod", "data")`` gives ``Shard(i)`` on both, pod the major),
    ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh.axis_names)
    for dim, entry in enumerate(spec):
        for a in () if entry is None else entry if isinstance(entry, tuple) else (entry,):
            out[mesh.axis_names.index(a)] = Shard(dim)
    return tuple(out)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (the dry-run's sharded tensors)."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _constraint(x, spec: P):
    mesh = _HINT_CTX["mesh"]
    if mesh is None or not is_dtensor(x):
        return x
    resolved = resolve_spec(mesh, x.shape, spec)
    return x.redistribute(x.device_mesh, spec_placements(mesh, resolved))


# ---------------------------------------------------------------------------
# in-body hints
# ---------------------------------------------------------------------------

def shard_hint(x, kind: str):
    """Annotate an activation inside a step.

    kinds: ``'act'`` — [B, T, d] residual-stream activations, batch over the
    data axes, feature dim replicated (TP keeps weights sharded instead);
    ``'logits'`` — [B, T, V], vocab shards over ``model`` (the head matmul's
    natural output layout, avoids an all-gather before the softmax).
    """
    mesh = _HINT_CTX["mesh"]
    if mesh is None:
        return x
    b = _batch_axes(mesh)
    batch = b if len(b) != 1 else b[0]
    if kind == "act":
        spec = P(*([batch] + [None] * (x.ndim - 1)))
    elif kind == "logits":
        spec = P(*([batch] + [None] * (x.ndim - 2) + ["model"]))
    else:
        raise ValueError(f"unknown hint kind {kind!r}")
    return _constraint(x, spec)


def shard_spec(x, *axes):
    """Explicit per-dim constraint; ``'dp'`` expands to the batch axes."""
    mesh = _HINT_CTX["mesh"]
    if mesh is None:
        return x
    entries = []
    for a in axes:
        if a == "dp":
            b = _batch_axes(mesh)
            entries.append(b if len(b) != 1 else (b[0] if b else None))
        else:
            entries.append(a)
    return _constraint(x, P(*entries))


# ---------------------------------------------------------------------------
# shard-local computations
# ---------------------------------------------------------------------------

class _ShardLocal(torch.autograd.Function):
    """``fn`` of ``DTensor``s whose shards are independent: ``fn`` runs on
    meta stand-ins of the global shapes (its ops counted as on one device,
    and none of them through ``DTensor``), and the output is a meta
    ``DTensor`` with ``placements``.  Under grad the stand-ins keep their
    own graph, whose backward runs in this Function's backward and gives
    each input's gradient in ``grad_placements`` (partial sums over the
    mesh axes that split the computation but not that input)."""

    @staticmethod
    def forward(ctx, fn, placements, grad_placements, *tensors):
        from torch.distributed.tensor import DTensor

        stand = [torch.empty(t.shape, dtype=t.dtype, device="meta").requires_grad_(
            t.requires_grad) if isinstance(t, torch.Tensor) else t for t in tensors]
        wants = [isinstance(t, torch.Tensor) and t.requires_grad for t in stand]
        # the stand-ins' graph keeps its saved tensors (meta: nothing held),
        # out of reach of an enclosing checkpoint's hooks, which would
        # otherwise recompute the region once more to restore them
        with torch.set_grad_enabled(any(wants)), \
                torch.autograd.graph.saved_tensors_hooks(lambda t: t, lambda t: t):
            out = fn(*stand)
        ctx.stand, ctx.wants, ctx.out, ctx.tensors = stand, wants, out, tensors
        ctx.placements, ctx.grad_placements = placements, grad_placements
        mesh = next(t for t in tensors if isinstance(t, DTensor)).device_mesh
        return _as_dtensor(out, mesh, placements)

    @staticmethod
    def backward(ctx, dout):
        # the output's gradient in the output's layout (a reduction of partial
        # gradients is communication the mesh would do)
        dout.redistribute(dout.device_mesh, ctx.placements)
        inputs = [s for s, w in zip(ctx.stand, ctx.wants) if w]
        grads = iter(torch.autograd.grad(ctx.out, inputs, torch.empty_like(ctx.out),
                                         allow_unused=True))
        out = []
        for t, w, placements in zip(ctx.tensors, ctx.wants, ctx.grad_placements):
            g = next(grads) if w else None
            if w and g is None:
                g = torch.zeros(t.shape, dtype=t.dtype, device="meta")
            if g is not None and is_dtensor(t):
                g = _as_dtensor(g, t.device_mesh, placements)
            out.append(g)
        return (None, None, None, *out)


def _as_dtensor(t, mesh, placements):
    """A meta ``DTensor`` of ``t``'s global shape, dtype and strides with
    ``placements`` (its local shard's shape from them)."""
    from torch.distributed.tensor import DTensor, Shard

    local = list(t.shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(torch.empty(local, dtype=t.dtype, device="meta"), mesh,
                              placements, run_check=False, shape=t.shape, stride=t.stride())


def shard_local(fn, tensors, dims, out_dims=None):
    """``fn(*tensors)``, and for ``DTensor`` inputs shard by shard
    (:class:`_ShardLocal`): a computation whose shards are independent over
    the batch and the heads, as each card of a mesh runs it on its own.
    ``dims[i]``: tensor i's (batch dim, head dim), either None;
    ``out_dims``: the output's (default ``dims[0]``).  The first tensor's
    sharding of its batch and head dims sets the layout; a mesh axis whose
    size does not divide every tensor's head dim leaves the heads
    replicated.  Every tensor is redistributed to it (its other dims
    replicated; plain tensors as they are); the gradient of a tensor
    without the batch (or head) dim is a partial sum over the mesh axes
    that split the batch (or heads).  Without a ``DTensor`` first, ``fn(*tensors)``
    itself."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    lead = tensors[0]
    if not is_dtensor(lead):
        return fn(*tensors)
    mesh = lead.device_mesh
    roles = []
    for i, p in enumerate(lead.placements):
        role = None
        if isinstance(p, Shard):
            role = {dims[0][0]: "batch", dims[0][1]: "head"}.get(p.dim)
        if role == "head" and any(
                d[1] is not None and t.shape[d[1]] % mesh.size(i)
                for t, d in zip(tensors, dims) if isinstance(t, torch.Tensor)):
            role = None
        roles.append(role)

    def target(d, missing=Replicate()):
        return tuple(Shard(d[0]) if r == "batch" and d[0] is not None else
                     Shard(d[1]) if r == "head" and d[1] is not None else
                     Replicate() if r is None else missing for r in roles)

    placed = [t.redistribute(mesh, target(d)) if isinstance(t, DTensor) else t
              for t, d in zip(tensors, dims)]
    return _ShardLocal.apply(fn, target(out_dims or dims[0]),
                             [target(d, Partial()) for d in dims], *placed)


# ---------------------------------------------------------------------------
# entry shardings (the step's boundary)
# ---------------------------------------------------------------------------

def _leaf_bytes(leaf) -> int:
    return math.prod(leaf.shape) * leaf.element_size()


def _fits_tp_only(mesh, params_spec, *, hbm_bytes: float | None = None) -> bool:
    """True when TP-only replication of the weights fits per-chip HBM —
    the serve_auto resolver uses this to pick the decode weight layout.
    ``hbm_bytes``: one chip's memory (``HBM_BYTES_PER_CHIP``, the H100's,
    when not given)."""
    if hbm_bytes is None:
        hbm_bytes = HBM_BYTES_PER_CHIP
    total = sum(_leaf_bytes(leaf) for leaf in tree_leaves(params_spec))
    mdl = int(mesh.shape.get("model", 1)) if hasattr(mesh.shape, "get") else 1
    return total / max(mdl, 1) <= _HBM_HEADROOM * hbm_bytes


def _ndim(leaf) -> int:
    """A leaf's rank; a non-tensor leaf (the decode cache's ``pos``, a Python
    int standing for the reference's int32 scalar) is a scalar."""
    return leaf.ndim if isinstance(leaf, torch.Tensor) else 0


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()


def param_sharding(mesh, params_spec, mode: str = "train"):
    """Tree of resolved specs for a parameter tree.

    ``'train'``: FSDP+TP — penultimate dim over ``data``, last over
    ``model``.  ``'serve'``/``'serve_tp'``: TP only (last dim over
    ``model``), replicated over ``data``.  Vectors and scalars replicate.
    """
    data_axes = tuple(a for a in mesh.axis_names if a in _DEFAULT_BATCH_AXES)
    data = data_axes if len(data_axes) != 1 else data_axes[0]

    def one(leaf):
        if _ndim(leaf) < 2:
            spec = P()
        elif mode == "train":
            spec = P(*([None] * (leaf.ndim - 2) + [data, "model"]))
        else:
            spec = P(*([None] * (leaf.ndim - 1) + ["model"]))
        return resolve_spec(mesh, _shape(leaf), spec)

    return tree_map(one, params_spec)


def batch_sharding(mesh, batch_spec):
    """Shard the leading (batch) dim of every input leaf over the batch axes."""
    b = _batch_axes(mesh)
    batch = b if len(b) != 1 else b[0]

    def one(leaf):
        if _ndim(leaf) == 0:
            spec = P()
        else:
            spec = P(*([batch] + [None] * (leaf.ndim - 1)))
        return resolve_spec(mesh, _shape(leaf), spec)

    return tree_map(one, batch_spec)


def cache_sharding(mesh, cache_spec):
    """Decode-cache shardings.  Cache leaves are layer-stacked
    ([L, B, ...]) so the batch dim is axis 1; scalars (``pos``) replicate."""
    b = _batch_axes(mesh)
    batch = b if len(b) != 1 else b[0]

    def one(leaf):
        if _ndim(leaf) <= 1:
            spec = P()
        else:
            spec = P(*([None, batch] + [None] * (leaf.ndim - 2)))
        return resolve_spec(mesh, _shape(leaf), spec)

    return tree_map(one, cache_spec)
