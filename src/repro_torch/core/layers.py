"""Edge-type-aware GNN layers on PaddedGraph (GCN / GAT / SAGE).

All layers consume the padded in-neighbor layout from ``core.graph`` (as
torch tensors, see ``PaddedGraph.to``) and are plain functions
``apply(params, h, graph, mm=torch.matmul) -> h'`` over nested dicts of
tensors; ``mm`` takes every dense product over the node rows.  The
neighbor aggregation is the paper's hot loop; it goes through
``kernels.ops.csr_spmm`` / ``kernels.ops.edge_softmax_agg``, which launch the
CUDA kernels for CUDA tensors and run the plain versions for CPU tensors.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.graph import EdgeType, PaddedGraph
from repro_torch.kernels import ops


def _glorot(rng: torch.Generator, shape) -> torch.Tensor:
    """Normal draws scaled by sqrt(2 / (fan_in + fan_out)), on the CPU."""
    fan_in, fan_out = shape[-2], shape[-1]
    return torch.randn(shape, generator=rng) * math.sqrt(2.0 / (fan_in + fan_out))


# ---------------------------------------------------------------------------
# Aggregation primitives
# ---------------------------------------------------------------------------

class _Lookup(torch.autograd.Function):
    """``table[codes]`` whose gradient with respect to ``table`` is a one-hot
    matrix product.  torch's own backward of ``table[codes]`` scatters into
    the table one code at a time: a GAT layer's 25,536 edge-type codes into
    4 entries took 6.2 ms of a 19 ms train step on the H100."""

    @staticmethod
    def forward(ctx, table, codes):
        codes = codes.long()
        ctx.save_for_backward(codes)
        ctx.rows = table.shape[0]
        return table[codes]

    @staticmethod
    def backward(ctx, grad):
        (codes,) = ctx.saved_tensors
        onehot = codes.reshape(-1, 1) == torch.arange(ctx.rows, device=codes.device)
        dtable = onehot.to(grad.dtype).T @ grad.reshape(onehot.shape[0], -1)
        return dtable.reshape((ctx.rows,) + grad.shape[codes.dim():]), None


#: rows of every dense product :func:`row_stable_matmul` issues on the card:
#: the streaming refresh's largest bin (``EngineConfig.community_size``)
ROW_CHUNK = 4096


def row_stable_matmul(x, w):
    """``x @ w`` over node rows (``x`` [N, K]; ``w`` [K, O] or [K]) whose
    row bits do not depend on N.

    cuBLAS picks its kernel, and with it the order of a row's sums, by the
    product's shape: on the H100 the rows of ``x[:N] @ w`` change in the
    last bits between N = 64 and N = 65,536.  So on the card the product
    runs in chunks of exactly ``ROW_CHUNK`` rows, the last one padded with
    zero rows: one shape, one kernel, whatever N is.  A node then gets the
    same stage-1 embedding from a community's graph as from the whole graph
    (the streaming refresh's two scopes).  On the CPU it is ``x @ w``,
    whose rows already keep their bits from N = 4 on."""
    if x.device.type != "cuda":
        return x @ w
    return chunked_matmul(x, w, ROW_CHUNK)


def chunked_matmul(x, w, rows: int):
    """``x @ w`` as products of exactly ``rows`` rows of ``x``, the last
    chunk padded with zero rows (:func:`row_stable_matmul` on the card)."""
    n = x.shape[0]
    pad = -n % rows
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return torch.cat([x[i:i + rows] @ w for i in range(0, n + pad, rows)])[:n]


def lookup(table, codes):
    """``table[codes]`` for integer ``codes`` in [0, len(table)): rows of an
    embedding table (or entries of a vector), with a gradient that is a
    matrix product (:class:`_Lookup`)."""
    return _Lookup.apply(table, codes)


def weighted_gather_sum(h, nbr_idx, weights, rev=None):
    """out[i] = sum_d weights[i, d] * h[nbr_idx[i, d]]  — the SpMM core.

    h: [N, H]; nbr_idx: [N, D] int32; weights: [N, D] float; ``rev``: the
    graph's reverse-slot index (``PaddedGraph.rev``), which a gradient on
    the card needs.
    """
    return ops.csr_spmm(h, nbr_idx, weights, rev)


def per_etype_mean(h, graph: PaddedGraph):
    """Mean-aggregate neighbor states separately per edge type.

    Returns [NUM_ETYPES, N, H], every type in one ``csr_spmm`` launch on
    the card."""
    return ops.csr_spmm_etype_mean(h, graph.nbr_idx, graph.nbr_mask, graph.nbr_etype,
                                   EdgeType.NUM, graph.rev)


# ---------------------------------------------------------------------------
# GCN
# ---------------------------------------------------------------------------

def gcn_init(rng, in_dim: int, out_dim: int):
    return {
        "w_self": _glorot(rng, (in_dim, out_dim)),
        "w_nbr": torch.stack([_glorot(rng, (in_dim, out_dim))
                              for _ in range(EdgeType.NUM)]),       # [E, in, out]
        "b": torch.zeros(out_dim),
    }


def gcn_apply(params, h, graph: PaddedGraph, mm=torch.matmul):
    agg = per_etype_mean(h, graph)                       # [E, N, in]
    w_nbr = params["w_nbr"]                              # [E, in, out]
    out = mm(h, params["w_self"])
    # sum over (e, h) of agg[e, n, h] * w_nbr[e, h, o], as one product
    out = out + mm(agg.permute(1, 0, 2).reshape(h.shape[0], -1),
                   w_nbr.reshape(-1, w_nbr.shape[-1]))
    return torch.relu(out + params["b"])


# ---------------------------------------------------------------------------
# GAT (single-head GATv1 with edge-type bias, masked neighbor softmax)
# ---------------------------------------------------------------------------

def gat_init(rng, in_dim: int, out_dim: int):
    return {
        "w": _glorot(rng, (in_dim, out_dim)),
        "w_self": _glorot(rng, (in_dim, out_dim)),
        "a_src": _glorot(rng, (out_dim, 1))[:, 0],
        "a_dst": _glorot(rng, (out_dim, 1))[:, 0],
        "a_et": torch.zeros(EdgeType.NUM),
        "b": torch.zeros(out_dim),
    }


def gat_apply(params, h, graph: PaddedGraph, mm=torch.matmul):
    z = mm(h, params["w"])                               # [N, H]
    agg = ops.edge_softmax_agg(
        z, mm(z, params["a_src"]), mm(z, params["a_dst"]), graph.nbr_idx,
        graph.nbr_mask, lookup(params["a_et"], graph.nbr_etype), graph.rev,
    )
    out = agg + mm(h, params["w_self"])
    return torch.relu(out + params["b"])


# ---------------------------------------------------------------------------
# GraphSAGE (mean aggregator) — extra baseline beyond the paper's GCN/GAT
# ---------------------------------------------------------------------------

def sage_init(rng, in_dim: int, out_dim: int):
    return {
        "w_self": _glorot(rng, (in_dim, out_dim)),
        "w_nbr": _glorot(rng, (in_dim, out_dim)),
        "b": torch.zeros(out_dim),
    }


def sage_apply(params, h, graph: PaddedGraph, mm=torch.matmul):
    w = graph.nbr_mask
    cnt = w.sum(-1, keepdim=True).clamp_min(1.0)
    agg = weighted_gather_sum(h, graph.nbr_idx, w / cnt, graph.rev)
    out = mm(h, params["w_self"]) + mm(agg, params["w_nbr"])
    return torch.relu(out + params["b"])


LAYER_REGISTRY = {
    "gcn": (gcn_init, gcn_apply),
    "gat": (gat_init, gat_apply),
    "sage": (sage_init, sage_apply),
}
