"""Roofline terms of a step, counted while it runs on meta tensors.

The reference's ``repro.launch.roofline``, with H100 constants
(``launch.mesh``) and counts taken from the step's aten ops in place of a
compiled XLA module:

    compute term    = FLOPs / (chips * 989.4e12)        [bf16 peak]
    memory term     = bytes / (chips * 3.35e12)         [HBM3]
    collective term = collective_bytes / 50e9           [one NDR link per card]

:class:`StepCounter` sees every op the step runs, forward and backward,
through two ``TorchDispatchMode``s:

* **FLOPs** are those of ``torch.utils.flop_counter``'s registry (matrix
  products, convolutions, attention), counted on the ops as the step
  issues them, so on a mesh they are the *global* count over the logical
  shapes: ``hlo_gflops`` is the step's FLOPs summed over all chips, and one
  chip's share is ``global / chips`` (an even split; the replicated work
  that XLA's per-shard count includes is not in it, since the local ops
  are not counted).  Elementwise work is not counted, where XLA's
  ``cost_analysis`` counts it, so ``useful_ratio`` reads high beside the
  reference's.
* **bytes** are the unfused sum, over every aten op that is not a view or
  an allocation, of its tensor inputs and outputs (global shapes): an upper
  bound on the traffic, not XLA's "bytes accessed" after fusion.
* **collectives** are the ``_c10d_functional`` ops (and ``DTensor``'s
  all-to-all) that ``DTensor`` issues on rank 0's shards (a mode that lets
  ``DTensor`` run first, as ``CommDebugMode`` does): per-collective-type
  output bytes on one card, summed over the step, all-reduce weighted 2x
  for the ring's reduce-scatter + all-gather phases.  They are per-card
  quantities, matching the per-card link of the denominator.

MODEL_FLOPS = 6·N·D for training (fwd+bwd), 2·N·D for inference, with N =
active params; the ratio MODEL_FLOPS/FLOPs measures how much counted
compute is useful (remat, padding and masked-attention waste lower it).
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16

_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

#: ``_c10d_functional`` / ``_dtensor`` op names -> the reference's kinds
_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")
_ALLOCATIONS = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided")


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class _CountOps(TorchDispatchMode):
    """FLOPs and unfused bytes of every op, on the shapes as issued."""

    def __init__(self, counter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.counter.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if func.namespace == "aten" and packet.__name__ not in _ALLOCATIONS \
                and not _is_view(func):
            self.counter.bytes += _nbytes(_tensors(args) + _tensors(kwargs) + _tensors(out))
        return out


class _CountCollectives(TorchDispatchMode):
    """The collectives ``DTensor`` issues: it runs first (NotImplemented for
    ``DTensor`` arguments) and this mode sees its local ops."""

    def __init__(self, counter):
        from torch.distributed.tensor import DTensor

        super().__init__()
        self.counter = counter
        self.dtensor = DTensor

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, self.dtensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in ("_c10d_functional", "_dtensor"):
            name = func._overloadpacket.__name__
            if name not in _NOT_COLLECTIVES:
                kind = _KIND.get(name, name)
                self.counter.collectives.append((kind, _nbytes(_tensors(out))))
        return out


def _meta_key(x):
    """A hashable stand-in for an argument of an op on meta tensors: a
    tensor's metadata (a meta tensor has no values), containers walked;
    None where the op is not one to memoize (a tensor off the meta device,
    or an argument that cannot be hashed)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta" or type(x) is not torch.Tensor:
            raise _NoMemo
        return ("T", tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_meta_key(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _meta_key(v)) for k, v in sorted(x.items()))
    try:
        hash(x)
    except TypeError:
        raise _NoMemo from None
    return (type(x), x)       # 1, 1.0 and True are equal keys but promote apart


class _NoMemo(Exception):
    pass


class _MetaMemo(TorchDispatchMode):
    """Memoized outputs of ops on meta tensors.  A meta tensor has no values,
    so an op's outputs are a function of its arguments' metadata: the first
    call with given metadata runs the op's meta kernel (a Python function
    for most pointwise ops, ~0.1-1 ms each), later calls get fresh meta
    tensors of the same shapes, strides and dtypes.  A full-depth step
    repeats each layer's ops at the same shapes, so most calls hit.  Views
    and in-place ops (their outputs alias their inputs), ``out=`` calls and
    ops on any other tensor run as they are."""

    def __init__(self):
        from torch.distributed.tensor import DTensor

        super().__init__()
        self.cache = {}
        self.dtensor = DTensor

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self.dtensor) for t in types):
            return NotImplemented
        if "out" in kwargs or any(r.alias_info is not None for r in func._schema.returns):
            return func(*args, **kwargs)
        try:
            key = (func, _meta_key(args), _meta_key(kwargs))
        except _NoMemo:
            return func(*args, **kwargs)
        spec = self.cache.get(key)
        if spec is None:
            out = func(*args, **kwargs)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            if all(isinstance(t, torch.Tensor) and t.device.type == "meta" for t in outs):
                self.cache[key] = (isinstance(out, (tuple, list)), type(out),
                                   [(tuple(t.shape), t.stride(), t.dtype) for t in outs])
            return out
        many, kind, metas = spec
        outs = [torch.empty_strided(shape, stride, dtype=dtype, device="meta")
                for shape, stride, dtype in metas]
        return kind(outs) if many else outs[0]


class StepCounter:
    """``with StepCounter() as c:`` counts the FLOPs, bytes and collectives
    of the ops run inside (forward and backward); ``c.cost()`` gives them
    in the form :func:`analyze` and the dry-run's extrapolation take."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.collectives: list[tuple[str, int]] = []
        self._modes = (_MetaMemo(), _CountCollectives(self), _CountOps(self))

    def __enter__(self):
        for mode in self._modes:        # the op counter on top, seeing ops as issued
            mode.__enter__()
        return self

    def __exit__(self, *exc):
        for mode in reversed(self._modes):
            mode.__exit__(*exc)
        return False

    def cost(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "coll": collective_bytes(self.collectives)}


def collective_bytes(collectives) -> dict:
    """Per-collective-type output bytes summed over the step (one card),
    and counts, from the ``(kind, bytes)`` of each collective the step ran
    (:class:`StepCounter`); the reference reads them from HLO text."""
    out = {k: 0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for kind, nbytes in collectives:
        out[kind] = out.get(kind, 0) + nbytes
        counts[kind] = counts.get(kind, 0) + 1
    return {"bytes": out, "counts": counts}


@dataclass
class RooflineRecord:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_gflops: float               # total across chips (the global count)
    hlo_gbytes: float               # total across chips (unfused)
    coll_gbytes_per_chip: float     # weighted, per card
    coll_detail: dict
    t_compute: float                # seconds
    t_memory: float
    t_collective: float
    bottleneck: str
    model_gflops: float
    useful_ratio: float
    bytes_per_device: dict | None = None
    note: str = ""

    def to_json(self):
        return json.dumps(asdict(self), indent=1)


def model_flops(cfg, shape) -> float:
    """6·N_active·D (train) / 2·N_active·D (inference) with D = processed
    tokens; decode processes global_batch tokens per step."""
    n = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch   # decode: one token per sequence


def active_param_count(cfg) -> float:
    """Active (per-token) parameter count from the logical config."""
    d, nl = cfg.d_model, cfg.num_layers
    v = cfg.vocab_size
    emb = 2 * v * d                     # embed + head
    if cfg.arch_type == "ssm":
        di, n_s, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        per = d * (2 * di + 2 * n_s + h) + di * d
        return emb + nl * per
    attn = d * (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim \
        + cfg.num_heads * cfg.head_dim * d
    if cfg.ffn_type == "swiglu":
        ffn = 3 * d * cfg.d_ff
    else:
        ffn = 2 * d * cfg.d_ff
    if cfg.arch_type == "moe":
        ffn = cfg.experts_per_token * ffn + d * cfg.num_experts
    per = attn + ffn
    if cfg.arch_type == "hybrid":
        di, n_s, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        mamba_per = d * (2 * di + 2 * n_s + h) + di * d
        n_attn = cfg.num_layers // cfg.attn_every
        return emb + nl * mamba_per + n_attn * per
    if cfg.arch_type == "vlm":
        return emb + nl * per            # cross layers ~ self layers in size
    if cfg.arch_type == "audio":
        dec_per = per + attn            # + cross attention
        return emb + nl * per + nl * dec_per
    return emb + nl * per


def analyze(cfg, shape, mesh_name: str, chips: int, cost: dict, memory_stats=None,
            note: str = "") -> RooflineRecord:
    """The record of one step from its ``cost`` (:meth:`StepCounter.cost`,
    or the dry-run's extrapolation of it): FLOPs and bytes global, split
    evenly over ``chips``; collectives per card."""
    flops, bts, coll = cost["flops"], cost["bytes"], cost["coll"]
    weighted = sum(
        (2 if k == "all-reduce" else 1) * v for k, v in coll["bytes"].items()
    )
    t_comp = flops / (chips * PEAK_FLOPS_BF16)
    t_mem = bts / (chips * HBM_BW)
    t_coll = weighted / LINK_BW          # per-card bytes over one card's link
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    return RooflineRecord(
        arch=cfg.name,
        shape=shape.name,
        mesh=mesh_name,
        chips=chips,
        hlo_gflops=flops / 1e9,
        hlo_gbytes=bts / 1e9,
        coll_gbytes_per_chip=weighted / 1e9,
        coll_detail=coll,
        t_compute=t_comp,
        t_memory=t_mem,
        t_collective=t_coll,
        bottleneck=bottleneck,
        model_gflops=mf / 1e9,
        useful_ratio=(mf / flops) if flops else 0.0,
        bytes_per_device=memory_stats,
        note=note,
    )
