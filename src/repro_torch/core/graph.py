"""Device-friendly graph containers.

Graphs are stored as *padded in-neighbor lists* rather than dynamic CSR: for
every node a fixed-width row of neighbor indices plus a mask.  This is the
layout consumed by the GNN layers and by the ``csr_spmm`` / ``edge_softmax``
CUDA kernels.  ``pad_graph`` builds it on the host in numpy;
:meth:`PaddedGraph.to` moves it to torch tensors on a device.

Node/edge-type vocabularies for the DDS graph live here so every module
agrees on the integer codes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Union

import numpy as np
import torch

from repro_torch.kernels.ref import reverse_slots_ref
from repro_torch.utils.device import resolve_device

Array = Union[np.ndarray, torch.Tensor]

# ---------------------------------------------------------------------------
# DDS vocabularies (paper Table 2)
# ---------------------------------------------------------------------------

class NodeType:
    ORDER = 0        # effective order_t (carries the label)
    SHADOW = 1       # shadow clone order_t^s (no label, feeds entities)
    ENTITY = 2       # entity_t snapshot vertex
    PAD = 3


class EdgeType:
    SHADOW_TO_ENTITY = 0   # order_t^s -> entity_t   (same snapshot)
    ENTITY_TO_SHADOW = 1   # entity_t -> order_t^s   (same snapshot)
    ENTITY_HIST = 2        # entity_{t-i} -> entity_t (incl. self loop i=0)
    ENTITY_TO_ORDER = 3    # entity_{t-e} -> order_t (the final 1-hop edges)
    NUM = 4


# ---------------------------------------------------------------------------
# Padded graph consumed by GNN layers
# ---------------------------------------------------------------------------

class PaddedGraph(NamedTuple):
    """Fixed-shape graph for one community (or a batch of merged communities).

    All arrays are padded to ``num_nodes`` rows and ``max_deg`` neighbor
    columns.  ``nbr_idx`` points at *source* nodes of incoming edges; padded
    slots point at row 0 with ``nbr_mask == 0``.  Fields are numpy arrays as
    :func:`pad_graph` returns them, or torch tensors after :meth:`to`.
    """

    features: Array      # [N, F] float — raw features (zeros for entities)
    nbr_idx: Array       # [N, D] int32 — in-neighbor node index
    nbr_mask: Array      # [N, D] float32 — 1 for real edges
    nbr_etype: Array     # [N, D] int32 — EdgeType codes (0 where padded)
    node_type: Array     # [N] int32 — NodeType codes (PAD for padding)
    snapshot: Array      # [N] int32 — snapshot index t (-1 for padding)
    label: Array         # [N] float32 — fraud label (orders only)
    label_mask: Array    # [N] float32 — 1 where label is valid
    # [N] int32 entity-type tower codes (-1 = untyped/non-entity), or None
    # on a homogeneous graph
    tower: Array | None = None
    # the reverse-slot index the backward kernels read
    # (``kernels.ref.reverse_slots_ref``): [N + 1] and [nnz] int32, built by
    # :meth:`with_rev`; None until then
    rev_ptr: Array | None = None
    rev_slot: Array | None = None

    @property
    def num_nodes(self) -> int:
        return self.features.shape[0]

    @property
    def max_deg(self) -> int:
        return self.nbr_idx.shape[1]

    @property
    def rev(self):
        """``(rev_ptr, rev_slot)``, or None where :meth:`with_rev` did not build it."""
        return None if self.rev_ptr is None else (self.rev_ptr, self.rev_slot)

    def to(self, device=None) -> "PaddedGraph":
        """The same graph as torch tensors on ``device`` (default: CUDA).

        Float fields become float32, integer fields int32; ``tower`` stays
        ``None`` on a homogeneous graph.
        """
        dev = resolve_device(device)

        def move(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)

        f32, i32 = torch.float32, torch.int32
        return PaddedGraph(
            features=move(self.features, f32),
            nbr_idx=move(self.nbr_idx, i32),
            nbr_mask=move(self.nbr_mask, f32),
            nbr_etype=move(self.nbr_etype, i32),
            node_type=move(self.node_type, i32),
            snapshot=move(self.snapshot, i32),
            label=move(self.label, f32),
            label_mask=move(self.label_mask, f32),
            tower=None if self.tower is None else move(self.tower, i32),
        )

    def with_rev(self) -> "PaddedGraph":
        """This graph (from :meth:`to`) with its reverse-slot index over the
        slots with ``nbr_mask > 0``, built on the host and moved to the
        graph's device.  A gradient on the card needs it; a training loop
        builds it once per graph, never per step."""
        idx = torch.as_tensor(self.nbr_idx)
        rev_ptr, rev_slot = reverse_slots_ref(idx.cpu(), torch.as_tensor(self.nbr_mask).cpu())
        return self._replace(rev_ptr=rev_ptr.to(idx.device), rev_slot=rev_slot.to(idx.device))


@dataclass
class COOGraph:
    """Host-side (numpy) directed graph in COO form, before padding."""

    num_nodes: int
    src: np.ndarray          # [E] int64
    dst: np.ndarray          # [E] int64
    etype: np.ndarray        # [E] int32
    features: np.ndarray     # [N, F]
    node_type: np.ndarray    # [N]
    snapshot: np.ndarray     # [N]
    label: np.ndarray        # [N]
    label_mask: np.ndarray   # [N]
    # [N] entity-type tower codes (-1 = untyped/non-entity); None on
    # homogeneous graphs (see repro_torch.core.hetero)
    tower: np.ndarray | None = None

    def in_degrees(self) -> np.ndarray:
        deg = np.zeros(self.num_nodes, np.int64)
        np.add.at(deg, self.dst, 1)
        return deg


def pad_graph(
    g: COOGraph,
    num_nodes: int | None = None,
    max_deg: int | None = None,
    deg_cap_policy: str = "recent",
) -> PaddedGraph:
    """Convert a COOGraph to a PaddedGraph.

    If a node's in-degree exceeds ``max_deg`` the excess edges are dropped:
    ``deg_cap_policy='recent'`` keeps edges whose *source snapshot* is most
    recent (matches the DDS intuition that fresh history matters most);
    ``'first'`` keeps arbitrary first-encountered edges.
    """
    n_real = g.num_nodes
    if num_nodes is None:
        num_nodes = n_real
    if num_nodes < n_real:
        raise ValueError(f"num_nodes {num_nodes} < real {n_real}")
    deg = g.in_degrees()
    if max_deg is None:
        max_deg = int(deg.max()) if deg.size else 1
    max_deg = max(int(max_deg), 1)

    nbr_idx = np.zeros((num_nodes, max_deg), np.int32)
    nbr_mask = np.zeros((num_nodes, max_deg), np.float32)
    nbr_etype = np.zeros((num_nodes, max_deg), np.int32)

    # sort edges by dst for grouped fill
    order = np.argsort(g.dst, kind="stable")
    src_s, dst_s, et_s = g.src[order], g.dst[order], g.etype[order]
    starts = np.searchsorted(dst_s, np.arange(num_nodes), side="left")
    ends = np.searchsorted(dst_s, np.arange(num_nodes), side="right")
    snap = g.snapshot
    for v in np.nonzero(ends > starts)[0]:
        s, e = starts[v], ends[v]
        srcs = src_s[s:e]
        ets = et_s[s:e]
        if e - s > max_deg:
            if deg_cap_policy == "recent":
                keep = np.argsort(-snap[srcs], kind="stable")[:max_deg]
            else:
                keep = np.arange(max_deg)
            srcs, ets = srcs[keep], ets[keep]
        k = srcs.size
        nbr_idx[v, :k] = srcs
        nbr_mask[v, :k] = 1.0
        nbr_etype[v, :k] = ets

    feat = np.zeros((num_nodes, g.features.shape[1]), np.float32)
    feat[:n_real] = g.features
    ntype = np.full(num_nodes, NodeType.PAD, np.int32)
    ntype[:n_real] = g.node_type
    snapshot = np.full(num_nodes, -1, np.int32)
    snapshot[:n_real] = g.snapshot
    label = np.zeros(num_nodes, np.float32)
    label[:n_real] = g.label
    label_mask = np.zeros(num_nodes, np.float32)
    label_mask[:n_real] = g.label_mask
    tower = None
    if g.tower is not None:
        tower = np.full(num_nodes, -1, np.int32)
        tower[:n_real] = g.tower

    return PaddedGraph(
        features=feat,
        nbr_idx=nbr_idx,
        nbr_mask=nbr_mask,
        nbr_etype=nbr_etype,
        node_type=ntype,
        snapshot=snapshot,
        label=label,
        label_mask=label_mask,
        tower=tower,
    )
