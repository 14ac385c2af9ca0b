"""Data pipeline: static graph -> partition -> per-community DDS -> padded
device batches, plus the paper's time-based 80/10/10 split.

ClusterGCN-flavor training (paper §3.2): cross-community edges are dropped,
each community becomes one fixed-shape ``PaddedGraph`` batch.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.dds import StaticGraph, build_dds
from repro_torch.core.graph import PaddedGraph, pad_graph
from repro_torch.core.partition import partition_transactions
from repro_torch.utils.padding import pad_to_multiple


@dataclass
class CommunityBatch:
    graph: PaddedGraph
    global_order_ids: np.ndarray   # [num_local_orders] -> static order id
    dds: object                    # DDSGraph (host-side bookkeeping)
    global_entity_ids: np.ndarray | None = None  # local entity -> static id


def make_split_masks(order_snapshot: np.ndarray, fracs=(0.8, 0.1, 0.1)):
    """Paper §4.2: first 80% of snapshots train, next 10% val, last 10% test.

    Split is on *snapshot boundaries* weighted by order counts.  Returns an
    int array [num_orders] with 0=train, 1=val, 2=test.
    """
    assert abs(sum(fracs) - 1.0) < 1e-6
    snaps = np.sort(np.unique(order_snapshot))
    counts = np.asarray([(order_snapshot == s).sum() for s in snaps], np.float64)
    cum = np.cumsum(counts) / counts.sum()
    t_train = snaps[np.searchsorted(cum, fracs[0])] if cum.size else 0
    t_val = snaps[min(np.searchsorted(cum, fracs[0] + fracs[1]), snaps.size - 1)] if cum.size else 0
    split = np.zeros(order_snapshot.shape[0], np.int32)
    split[order_snapshot > t_train] = 1
    split[order_snapshot > t_val] = 2
    return split


def standardize_features(features: np.ndarray, train_mask: np.ndarray):
    """Z-score features using train-split statistics only (no test leakage)."""
    mu = features[train_mask].mean(0, keepdims=True)
    sd = features[train_mask].std(0, keepdims=True) + 1e-6
    return ((features - mu) / sd).astype(np.float32), (mu, sd)


def build_communities(
    static: StaticGraph,
    community_size: int = 256,
    max_deg: int = 32,
    entity_history: str = "all",
    max_history: int | None = 8,
    min_orders: int = 4,
    seed: int = 0,
) -> list[CommunityBatch]:
    """Partition the static graph and build one padded DDS graph per community."""
    comm = partition_transactions(
        static.num_orders,
        static.num_entities,
        static.edges,
        community_size=community_size,
        seed=seed,
    )
    order_comm = comm[: static.num_orders]
    entity_comm = comm[static.num_orders :]

    batches: list[CommunityBatch] = []
    raw = []
    for c in np.unique(comm):
        local_orders = np.nonzero(order_comm == c)[0]
        local_entities = np.nonzero(entity_comm == c)[0]
        if local_orders.size < min_orders:
            continue
        # ClusterGCN: keep only intra-community edges (vectorized)
        keep = (order_comm[static.edges[:, 0]] == c) & (
            entity_comm[static.edges[:, 1]] == c
        )
        kept = static.edges[keep]
        if kept.size == 0:
            continue
        o_lut = np.full(static.num_orders, -1, np.int64)
        o_lut[local_orders] = np.arange(local_orders.size)
        e_lut = np.full(static.num_entities, -1, np.int64)
        e_lut[local_entities] = np.arange(local_entities.size)
        sub_edges = np.stack([o_lut[kept[:, 0]], e_lut[kept[:, 1]]], axis=1)
        sub = StaticGraph(
            num_orders=local_orders.size,
            num_entities=local_entities.size,
            edges=sub_edges,
            order_snapshot=static.order_snapshot[local_orders],
            order_features=static.order_features[local_orders],
            labels=static.labels[local_orders],
            entity_type=None
            if static.entity_type is None
            else static.entity_type[local_entities],
            num_snapshots=static.num_snapshots,
        )
        dds = build_dds(sub, entity_history=entity_history, max_history=max_history)
        raw.append((dds, local_orders, local_entities))

    if not raw:
        return batches
    budget = pad_to_multiple(max(d.coo.num_nodes for d, _, _ in raw), 8)
    for dds, local_orders, local_entities in raw:
        pg = pad_graph(dds.coo, num_nodes=budget, max_deg=max_deg)
        batches.append(CommunityBatch(graph=pg, global_order_ids=local_orders,
                                      dds=dds, global_entity_ids=local_entities))
    return batches


def apply_split_to_batches(batches: list[CommunityBatch], split: np.ndarray, which: int):
    """Return batches whose ``label_mask`` keeps only orders in split ``which``.

    The graph topology is unchanged (all history is visible); only the
    supervision mask moves — matching the paper, where partition runs on the
    whole static graph while train/val/test are snapshot ranges.
    """
    out = []
    for b in batches:
        g = b.graph
        mask = np.zeros(g.num_nodes, np.float32)
        order_rows = np.arange(b.global_order_ids.size)
        sel = split[b.global_order_ids] == which
        mask[order_rows[sel]] = 1.0
        out.append(
            CommunityBatch(
                graph=g._replace(label_mask=g.label_mask * mask),
                global_order_ids=b.global_order_ids,
                dds=b.dds,
            )
        )
    return out
