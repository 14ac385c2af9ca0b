"""Directed Dynamic Snapshot (DDS) graph construction — paper §3.2.

Transforms a static bipartite order↔entity transaction graph into a directed
snapshot graph in which information flows strictly from the past:

1. ``order_t``     — effective order vertex, carries the label.
2. ``order_t^s``   — shadow clone; exchanges messages with same-snapshot
                     entities so *future* orders can see it as history, while
                     the effective order itself never feeds the graph.
3. ``entity_t``    — entity snapshot vertex, one per (entity, active snapshot).
4. Edges (paper Table 2):
   * ``order_t^s <-> entity_t``         (same snapshot, both directions)
   * ``entity_{t-i} -> entity_t``       (history + self-loop)
   * ``entity_{t-e} -> order_t``        (one edge per linked entity, from the
                                         entity's latest *strictly past*
                                         active snapshot — the only edges
                                         needed at online inference)

The construction guarantees the **no-future-leak invariant**: every directed
edge (u→v) satisfies snapshot(u) <= snapshot(v), and the only edges *into* an
effective order come from snapshots strictly in its past or — for the
same-snapshot entity state — only via entity self-history that itself never
saw the order.  Property-tested in ``tests/test_dds_properties.py``.
"""
from __future__ import annotations

from bisect import bisect_left
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.graph import COOGraph, EdgeType, NodeType
from repro_torch.core.hetero import type_codes_array


def _tower_codes(n_nodes: int, entity_snap_ids: dict) -> np.ndarray | None:
    """Per-node entity-type tower codes for a materialized DDS graph.

    Returns ``None`` when no entity id carries a :mod:`repro_torch.core.hetero`
    type tag — homogeneous graphs keep the exact pre-hetero COO layout
    (``tower=None``), which is what the bit-parity gates compare.
    Otherwise an int32 [n_nodes] array: the type code at each entity-
    snapshot vertex, ``-1`` for orders, shadows, and untagged entities.
    """
    if not entity_snap_ids:
        return None
    ents = np.fromiter((pair[0] for pair in entity_snap_ids),
                       np.int64, len(entity_snap_ids))
    codes = type_codes_array(ents)
    if not (codes >= 0).any():
        return None
    tower = np.full(n_nodes, -1, np.int32)
    nids = np.fromiter(entity_snap_ids.values(), np.int64, len(entity_snap_ids))
    tower[nids] = codes
    return tower


@dataclass
class StaticGraph:
    """Host-side static transaction graph (paper §3.2 'Static Graph').

    ``edges`` is an [E, 2] int64 array of (order_id, entity_id); each order
    links at most one entity per entity *type* (shipping address, email, IP,
    device, phone, payment token, account — paper lists 7).
    """

    num_orders: int
    num_entities: int
    edges: np.ndarray              # [E, 2] (order, entity)
    order_snapshot: np.ndarray     # [n_ord] int — snapshot index of checkout
    order_features: np.ndarray     # [n_ord, F] float32 — raw checkout features
    labels: np.ndarray             # [n_ord] {0,1} — unauthenticated chargeback
    entity_type: np.ndarray | None = None   # [num_entities] int — optional
    num_snapshots: int = field(default=0)

    def __post_init__(self):
        if self.num_snapshots == 0:
            self.num_snapshots = int(self.order_snapshot.max()) + 1 if self.num_orders else 0


@dataclass
class DDSGraph:
    """The DDS graph plus bookkeeping to map back to static ids."""

    coo: COOGraph
    # node-id layout: [0, n_ord) effective orders; [n_ord, 2*n_ord) shadows;
    # [2*n_ord, 2*n_ord + num_entity_snap_nodes) entity-snapshot vertices.
    num_orders: int
    entity_snap_ids: dict          # (entity, t) -> node id
    # the final-hop table (speed-layer input): for each order, the entity
    # snapshot node ids feeding its ENTITY_TO_ORDER edges
    last_hop: dict                 # order id -> list[(entity, t_e, node_id)]

    @property
    def shadow_offset(self) -> int:
        return self.num_orders


def build_dds(
    g: StaticGraph,
    entity_history: str = "all",
    max_history: int | None = None,
) -> DDSGraph:
    """Build the DDS graph from a static transaction graph.

    entity_history:
      * ``'all'``          — edge from every past active snapshot (paper default:
                             "entity_t may be connected with a bunch of
                             entity_{t-i}"), optionally capped at
                             ``max_history`` most recent.
      * ``'consecutive'``  — edge only from the previous active snapshot
                             (information still flows transitively; cheaper).
    Always adds the self-loop ``entity_t -> entity_t``.
    """
    if entity_history not in ("all", "consecutive"):
        raise ValueError(entity_history)
    n_ord = g.num_orders

    # --- which (entity, t) pairs are active (linked to >= 1 order in t) ----
    order_of_edge = g.edges[:, 0]
    entity_of_edge = g.edges[:, 1]
    t_of_edge = g.order_snapshot[order_of_edge]

    # lexicographic unique over (entity, t) rows — same sorted order as the
    # old ent*(S+1)+t integer keys, but safe for tagged 43-bit entity ids
    # whose key product could overflow int64 at large snapshot counts
    pairs = np.stack([entity_of_edge.astype(np.int64),
                      t_of_edge.astype(np.int64)], axis=1)
    uniq_pairs = np.unique(pairs, axis=0) if pairs.size \
        else pairs.reshape(0, 2)
    uniq_entity, uniq_t = uniq_pairs[:, 0], uniq_pairs[:, 1]
    entity_snap_ids: dict = {}
    for i, (ent, t) in enumerate(zip(uniq_entity.tolist(), uniq_t.tolist())):
        entity_snap_ids[(ent, t)] = 2 * n_ord + i
    n_nodes = 2 * n_ord + len(entity_snap_ids)

    # active snapshots per entity, sorted ascending
    active: dict = {}
    for ent, t in zip(uniq_entity.tolist(), uniq_t.tolist()):
        active.setdefault(ent, []).append(t)
    for ent in active:
        active[ent].sort()

    src, dst, et = [], [], []

    # --- shadow <-> entity (same snapshot) --------------------------------
    for o, ent, t in zip(order_of_edge.tolist(), entity_of_edge.tolist(), t_of_edge.tolist()):
        e_node = entity_snap_ids[(ent, t)]
        s_node = n_ord + o  # shadow clone of order o
        src.append(s_node); dst.append(e_node); et.append(EdgeType.SHADOW_TO_ENTITY)
        src.append(e_node); dst.append(s_node); et.append(EdgeType.ENTITY_TO_SHADOW)

    # --- entity history (entity_{t-i} -> entity_t, incl. self loop) -------
    for ent, snaps in active.items():
        for j, t in enumerate(snaps):
            cur = entity_snap_ids[(ent, t)]
            src.append(cur); dst.append(cur); et.append(EdgeType.ENTITY_HIST)  # self-loop
            if entity_history == "consecutive":
                past = snaps[j - 1 : j] if j > 0 else []
            else:
                past = snaps[:j]
                if max_history is not None:
                    past = past[-max_history:]
            for tp in past:
                src.append(entity_snap_ids[(ent, tp)]); dst.append(cur); et.append(EdgeType.ENTITY_HIST)

    # --- effective entity -> order (the final 1-hop edges) ----------------
    last_hop: dict = {}
    for o, ent, t in zip(order_of_edge.tolist(), entity_of_edge.tolist(), t_of_edge.tolist()):
        snaps = active[ent]
        # latest active snapshot strictly before t  (paper: 0 <= t-e < t)
        idx = np.searchsorted(snaps, t) - 1
        if idx < 0:
            continue  # cold entity: no history before this order
        t_e = snaps[idx]
        e_node = entity_snap_ids[(ent, t_e)]
        src.append(e_node); dst.append(o); et.append(EdgeType.ENTITY_TO_ORDER)
        last_hop.setdefault(o, []).append((ent, t_e, e_node))

    # --- node tables -------------------------------------------------------
    F = g.order_features.shape[1]
    features = np.zeros((n_nodes, F), np.float32)
    features[:n_ord] = g.order_features
    features[n_ord : 2 * n_ord] = g.order_features  # shadows share raw features
    # entity features are zero per paper §4.2 ("initial features set to zero")

    node_type = np.full(n_nodes, NodeType.ENTITY, np.int32)
    node_type[:n_ord] = NodeType.ORDER
    node_type[n_ord : 2 * n_ord] = NodeType.SHADOW

    snapshot = np.zeros(n_nodes, np.int32)
    snapshot[:n_ord] = g.order_snapshot
    snapshot[n_ord : 2 * n_ord] = g.order_snapshot
    for (ent, t), nid in entity_snap_ids.items():
        snapshot[nid] = t

    label = np.zeros(n_nodes, np.float32)
    label[:n_ord] = g.labels
    label_mask = np.zeros(n_nodes, np.float32)
    label_mask[:n_ord] = 1.0  # only effective orders are supervised

    coo = COOGraph(
        num_nodes=n_nodes,
        src=np.asarray(src, np.int64),
        dst=np.asarray(dst, np.int64),
        etype=np.asarray(et, np.int32),
        features=features,
        node_type=node_type,
        snapshot=snapshot,
        label=label,
        label_mask=label_mask,
        tower=_tower_codes(n_nodes, entity_snap_ids),
    )
    return DDSGraph(coo=coo, num_orders=n_ord, entity_snap_ids=entity_snap_ids, last_hop=last_hop)


class IncrementalDDSBuilder:
    """Event-time incremental DDS construction — the streaming ingest path.

    ``add_order`` appends one checkout event (events must arrive in
    non-decreasing snapshot order, the event-time contract); the builder
    maintains per-entity active-snapshot lists, the final-hop table, and the
    typed edge lists incrementally, so per-event cost is O(K · history) with
    no global rebuild.  ``entity_keys`` answers the speed-layer question —
    "which ``(entity, t_e)`` KV keys feed this checkout?" — in
    O(K log S) without materializing anything.

    ``build()`` materializes a :class:`DDSGraph` whose padded form is
    bit-identical to ``build_dds`` on the equivalent accumulated
    :class:`StaticGraph` (same per-destination edge order, same node-id
    layout: entity-snapshot ids assigned in sorted ``(entity, t)`` order).
    The no-future-leak invariants hold by construction *at every prefix*:
    a node's in-neighborhood is final the moment its snapshot closes, which
    is exactly what lets the batch layer refresh embeddings incrementally
    (see ``repro.stream.refresh``).
    """

    def __init__(
        self,
        feat_dim: int,
        entity_history: str = "all",
        max_history: int | None = None,
    ):
        if entity_history not in ("all", "consecutive"):
            raise ValueError(entity_history)
        self.feat_dim = int(feat_dim)
        self.entity_history = entity_history
        self.max_history = max_history
        # accumulated static-graph state
        self._order_snapshot: list[int] = []
        self._order_features: list[np.ndarray] = []
        self._labels: list[float] = []
        self._order_entities: list[tuple] = []      # per order, linked entities
        self._active: dict[int, list[int]] = {}     # entity -> sorted snapshots
        self._entity_orders: dict[int, list[int]] = {}  # entity -> order ids
        self._pair_seq: list[tuple] = []            # (ent, t) in activation order
        # typed symbolic edge lists; entity-snap nodes are (ent, t) tuples,
        # orders are ints, shadows are ('s', order)
        self._shadow_edges: list[tuple] = []        # (order, ent, t) both dirs
        self._hist_edges: list[tuple] = []          # (ent, t_src, t_dst)
        self._final_edges: list[tuple] = []         # (ent, t_e, order)

    # ------------------------------------------------------------------ state
    @property
    def num_orders(self) -> int:
        return len(self._order_snapshot)

    @property
    def current_snapshot(self) -> int:
        return self._order_snapshot[-1] if self._order_snapshot else -1

    def entity_keys(self, entities, t: int) -> list:
        """Speed-layer key list: latest *strictly past* active snapshot per
        linked entity (cold entities contribute nothing)."""
        keys = []
        for ent in entities:
            snaps = self._active.get(int(ent))
            if not snaps:
                continue
            idx = bisect_left(snaps, t) - 1
            if idx >= 0:
                keys.append((int(ent), snaps[idx]))
        return keys

    # ----------------------------------------------------------------- ingest
    def add_order(self, entities, snapshot: int, features, label: float = 0.0) -> int:
        """Append one checkout.  Returns the new order id (arrival order).

        Raises on a snapshot regression — event-time ordering is the
        invariant that makes incremental construction leak-free.
        """
        t = int(snapshot)
        if t < self.current_snapshot:
            raise ValueError(
                f"event-time regression: snapshot {t} after {self.current_snapshot}"
            )
        o = self.num_orders
        feats = np.asarray(features, np.float32)
        if feats.shape != (self.feat_dim,):
            raise ValueError(f"features shape {feats.shape} != ({self.feat_dim},)")
        entities = [int(e) for e in entities]
        self._order_snapshot.append(t)
        self._order_features.append(feats)
        self._labels.append(float(label))
        self._order_entities.append(tuple(entities))

        for ent in entities:
            self._entity_orders.setdefault(ent, []).append(o)
            snaps = self._active.setdefault(ent, [])
            # final-hop edge from the latest strictly-past active snapshot.
            # Computed before (ent, t) activates, but t itself is excluded
            # either way — matches build_dds exactly.
            idx = bisect_left(snaps, t) - 1
            if idx >= 0:
                self._final_edges.append((ent, snaps[idx], o))
            # activate (ent, t) on first touch: history edges are final here
            # because every past snapshot of ent is already closed
            if not snaps or snaps[-1] != t:
                if self.entity_history == "consecutive":
                    past = snaps[-1:]
                else:
                    past = snaps if self.max_history is None else snaps[-self.max_history:]
                self._hist_edges.append((ent, t, t))        # self-loop first
                for tp in past:
                    self._hist_edges.append((ent, tp, t))
                snaps.append(t)
                self._pair_seq.append((ent, t))
            self._shadow_edges.append((o, ent, t))
        return o

    # ------------------------------------------------------------ materialize
    def to_static(self, num_snapshots: int = 0) -> StaticGraph:
        """The accumulated transactions as a StaticGraph (orders in arrival
        order) — ``build_dds(to_static())`` is the batch-path oracle the
        equivalence tests compare against."""
        edges = [
            (o, e) for o, ents in enumerate(self._order_entities) for e in ents
        ]
        num_entities = 1 + max((e for _, e in edges), default=-1)
        return StaticGraph(
            num_orders=self.num_orders,
            num_entities=num_entities,
            edges=np.asarray(edges, np.int64).reshape(-1, 2),
            order_snapshot=np.asarray(self._order_snapshot, np.int64),
            order_features=np.stack(self._order_features)
            if self._order_features
            else np.zeros((0, self.feat_dim), np.float32),
            labels=np.asarray(self._labels, np.float32),
            num_snapshots=num_snapshots,
        )

    def build(self) -> DDSGraph:
        """Materialize the accumulated DDS graph.

        Node ids: [0, n_ord) orders, [n_ord, 2*n_ord) shadows, then entity-snapshot
        vertices in sorted (entity, t) order — the ``build_dds`` layout.
        Per-destination edge order also matches ``build_dds`` (shadow edges
        in event order, history self-loop before ascending past, final-hop
        in event order), so ``pad_graph`` output is identical.
        """
        n_ord = self.num_orders
        entity_snap_ids = {
            pair: 2 * n_ord + i for i, pair in enumerate(sorted(self._pair_seq))
        }
        src, dst, et = [], [], []
        for o, ent, t in self._shadow_edges:
            e_node = entity_snap_ids[(ent, t)]
            src.append(n_ord + o); dst.append(e_node); et.append(EdgeType.SHADOW_TO_ENTITY)
            src.append(e_node); dst.append(n_ord + o); et.append(EdgeType.ENTITY_TO_SHADOW)
        for ent, t_src, t_dst in self._hist_edges:
            src.append(entity_snap_ids[(ent, t_src)])
            dst.append(entity_snap_ids[(ent, t_dst)])
            et.append(EdgeType.ENTITY_HIST)
        last_hop: dict = {}
        for ent, t_e, o in self._final_edges:
            e_node = entity_snap_ids[(ent, t_e)]
            src.append(e_node); dst.append(o); et.append(EdgeType.ENTITY_TO_ORDER)
            last_hop.setdefault(o, []).append((ent, t_e, e_node))

        n_nodes = 2 * n_ord + len(entity_snap_ids)
        features = np.zeros((n_nodes, self.feat_dim), np.float32)
        if n_ord:
            of = np.stack(self._order_features)
            features[:n_ord] = of
            features[n_ord : 2 * n_ord] = of
        node_type = np.full(n_nodes, NodeType.ENTITY, np.int32)
        node_type[:n_ord] = NodeType.ORDER
        node_type[n_ord : 2 * n_ord] = NodeType.SHADOW
        snapshot = np.zeros(n_nodes, np.int32)
        snapshot[:n_ord] = self._order_snapshot
        snapshot[n_ord : 2 * n_ord] = self._order_snapshot
        for (ent, t), nid in entity_snap_ids.items():
            snapshot[nid] = t
        label = np.zeros(n_nodes, np.float32)
        label[:n_ord] = self._labels
        label_mask = np.zeros(n_nodes, np.float32)
        label_mask[:n_ord] = 1.0
        coo = COOGraph(
            num_nodes=n_nodes,
            src=np.asarray(src, np.int64),
            dst=np.asarray(dst, np.int64),
            etype=np.asarray(et, np.int32),
            features=features,
            node_type=node_type,
            snapshot=snapshot,
            label=label,
            label_mask=label_mask,
            tower=_tower_codes(n_nodes, entity_snap_ids),
        )
        dds = DDSGraph(coo=coo, num_orders=n_ord, entity_snap_ids=entity_snap_ids,
                       last_hop=last_hop)
        return dds

    def build_subgraph(self, entities) -> DDSGraph:
        """Materialize the DDS subgraph induced by a **component-closed**
        entity set — the community-local batch-layer input.

        ``entities`` must be a union of connected components of the
        order↔entity graph (see ``core.partition.IncrementalPartitioner``);
        an order linking both an in-set and an out-of-set entity raises
        ``ValueError``, because such a cut would silently drop in-edges and
        break the bit-identical refresh guarantee.  Closure means NO DDS
        edge crosses the subgraph boundary, so every included node keeps
        its full in-neighborhood at any GNN depth.

        Cost is O(touched orders + touched pairs) — never O(total stream).

        Local node-id layout mirrors ``build()``: [0, n_sub) selected
        orders in arrival order, then shadows, then entity snapshots in
        sorted (entity, t) order; per-destination edge order also matches
        (shadow edges in event order, history self-loop before ascending
        past, final-hop in event order).  ``pad_graph`` rows of this
        subgraph are therefore bit-identical to the corresponding rows of
        the padded full ``build()`` graph modulo the local→global id
        remapping (sliced-build parity test), which is what makes
        community-local stage-1 embeddings equal the whole-graph ones
        bit-for-bit.
        """
        ents = {int(e) for e in entities}
        touched = sorted({o for e in ents
                          for o in self._entity_orders.get(e, ())})
        for o in touched:
            for e2 in self._order_entities[o]:
                if e2 not in ents:
                    raise ValueError(
                        f"entity set is not component-closed: order {o} links "
                        f"entity {e2} outside the set"
                    )
        n_sub = len(touched)
        order_local = {o: i for i, o in enumerate(touched)}
        pairs = sorted((e, t) for e in ents for t in self._active.get(e, ()))
        entity_snap_ids = {p: 2 * n_sub + i for i, p in enumerate(pairs)}

        src, dst, et = [], [], []
        # shadow <-> entity, in event order (ascending order id, per-order
        # entity order preserved) — matches the filtered _shadow_edges list
        for o in touched:
            t = self._order_snapshot[o]
            s_node = n_sub + order_local[o]
            for ent in self._order_entities[o]:
                e_node = entity_snap_ids[(ent, t)]
                src.append(s_node); dst.append(e_node); et.append(EdgeType.SHADOW_TO_ENTITY)
                src.append(e_node); dst.append(s_node); et.append(EdgeType.ENTITY_TO_SHADOW)
        # entity history: reconstruct each activation's edges from the
        # active-snapshot list (the state at activation time was the strict
        # prefix, so snaps[:j] reproduces _hist_edges exactly); only
        # per-destination order matters to pad_graph, so iterating entities
        # sorted rather than in global activation order is equivalent
        for ent in sorted(ents):
            snaps = self._active.get(ent, [])
            for j, t in enumerate(snaps):
                cur = entity_snap_ids[(ent, t)]
                src.append(cur); dst.append(cur); et.append(EdgeType.ENTITY_HIST)
                if self.entity_history == "consecutive":
                    past = snaps[j - 1 : j] if j > 0 else []
                else:
                    past = snaps[:j]
                    if self.max_history is not None:
                        past = past[-self.max_history:]
                for tp in past:
                    src.append(entity_snap_ids[(ent, tp)]); dst.append(cur)
                    et.append(EdgeType.ENTITY_HIST)
        # final hop: latest strictly-past active snapshot per linked entity.
        # Recomputing against the *current* active list is exact — snapshots
        # activated after the order are never strictly before it
        last_hop: dict = {}
        for o in touched:
            t = self._order_snapshot[o]
            lo = order_local[o]
            for ent in self._order_entities[o]:
                snaps = self._active[ent]
                idx = bisect_left(snaps, t) - 1
                if idx < 0:
                    continue
                t_e = snaps[idx]
                e_node = entity_snap_ids[(ent, t_e)]
                src.append(e_node); dst.append(lo); et.append(EdgeType.ENTITY_TO_ORDER)
                last_hop.setdefault(lo, []).append((ent, t_e, e_node))

        n_nodes = 2 * n_sub + len(entity_snap_ids)
        features = np.zeros((n_nodes, self.feat_dim), np.float32)
        node_type = np.full(n_nodes, NodeType.ENTITY, np.int32)
        node_type[:n_sub] = NodeType.ORDER
        node_type[n_sub : 2 * n_sub] = NodeType.SHADOW
        snapshot = np.zeros(n_nodes, np.int32)
        label = np.zeros(n_nodes, np.float32)
        label_mask = np.zeros(n_nodes, np.float32)
        label_mask[:n_sub] = 1.0
        for o in touched:
            lo = order_local[o]
            features[lo] = self._order_features[o]
            features[n_sub + lo] = self._order_features[o]
            snapshot[lo] = snapshot[n_sub + lo] = self._order_snapshot[o]
            label[lo] = self._labels[o]
        for (ent, t), nid in entity_snap_ids.items():
            snapshot[nid] = t
        coo = COOGraph(
            num_nodes=n_nodes,
            src=np.asarray(src, np.int64),
            dst=np.asarray(dst, np.int64),
            etype=np.asarray(et, np.int32),
            features=features,
            node_type=node_type,
            snapshot=snapshot,
            label=label,
            label_mask=label_mask,
            tower=_tower_codes(n_nodes, entity_snap_ids),
        )
        return DDSGraph(coo=coo, num_orders=n_sub,
                        entity_snap_ids=entity_snap_ids, last_hop=last_hop)


def check_no_future_leak(dds: DDSGraph) -> None:
    """Assert the DDS invariants (used by property tests):

    1. every edge u->v has snapshot(u) <= snapshot(v);
    2. edges into an effective ORDER come only from strictly-past entity
       snapshots (EdgeType.ENTITY_TO_ORDER with snapshot(u) < snapshot(v));
    3. effective ORDER vertices have no outgoing edges (labels never leak);
    4. same-snapshot edges only connect shadows and entities.
    """
    coo = dds.coo
    s_snap = coo.snapshot[coo.src]
    d_snap = coo.snapshot[coo.dst]
    if not np.all(s_snap <= d_snap):
        raise AssertionError("edge from future snapshot found")
    into_order = coo.node_type[coo.dst] == NodeType.ORDER
    if into_order.any():
        if not np.all(coo.etype[into_order] == EdgeType.ENTITY_TO_ORDER):
            raise AssertionError("non-final-hop edge into effective order")
        if not np.all(s_snap[into_order] < d_snap[into_order]):
            raise AssertionError("same/future-snapshot edge into effective order")
    from_order = coo.node_type[coo.src] == NodeType.ORDER
    if from_order.any():
        raise AssertionError("effective order has outgoing edge (label leak)")
    same = s_snap == d_snap
    if same.any():
        ok_types = np.isin(
            coo.etype[same],
            [EdgeType.SHADOW_TO_ENTITY, EdgeType.ENTITY_TO_SHADOW, EdgeType.ENTITY_HIST],
        )
        if not np.all(ok_types):
            raise AssertionError("same-snapshot edge of illegal type")
