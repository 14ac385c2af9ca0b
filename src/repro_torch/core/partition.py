"""Graph partition — paper §3.2 'Graph Partition'.

The paper partitions the months-long static transaction graph with
Power Iteration Clustering (PIC, Lin & Cohen 2010 — expected partition size
~1e6) and then refines with METIS (Karypis & Kumar) to communities of ~1024
nodes ("the business understanding for a gang of fraudsters"), training in
ClusterGCN flavor on the mini-communities.

Here both stages are implemented directly (no Spark / metis binding):

* ``power_iteration_clustering`` — the PIC algorithm on the normalized
  affinity matrix of the *order-entity bipartite* graph projected to a
  symmetric adjacency; early-stops on the acceleration criterion from the
  paper and 1-D k-means clusters the resulting pseudo-eigenvector.
* ``refine_partition`` — METIS-style size-balanced refinement: connected
  components inside each PIC cluster, then BFS-grown chunks capped at the
  target community size (greedy multilevel coarsening is overkill at our
  synthetic scale; BFS growth preserves locality, which is what ClusterGCN
  needs).
"""
from __future__ import annotations

import numpy as np


def _csr_from_edges(num_nodes: int, src: np.ndarray, dst: np.ndarray):
    """Symmetric CSR adjacency (indices only) from an undirected edge list."""
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    order = np.argsort(s, kind="stable")
    s, d = s[order], d[order]
    indptr = np.zeros(num_nodes + 1, np.int64)
    np.add.at(indptr, s + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, d


def power_iteration_clustering(
    num_nodes: int,
    src: np.ndarray,
    dst: np.ndarray,
    num_clusters: int,
    max_iter: int = 50,
    tol: float = 1e-5,
    seed: int = 0,
) -> np.ndarray:
    """PIC (Lin & Cohen 2010): truncated power iteration of W = D^-1 A.

    Returns an int cluster id per node.  Isolated nodes go to cluster 0.
    """
    indptr, indices = _csr_from_edges(num_nodes, src, dst)
    deg = np.diff(indptr).astype(np.float64)
    inv_deg = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)

    rng = np.random.default_rng(seed)
    v = rng.uniform(0.0, 1.0, num_nodes)
    v /= np.abs(v).sum()

    prev_delta = None
    for _ in range(max_iter):
        # v_new = D^-1 A v  (row-normalized affinity)
        acc = np.zeros(num_nodes)
        # segment sum: acc[i] = sum_j in nbr(i) v[j]
        np.add.at(acc, np.repeat(np.arange(num_nodes), np.diff(indptr)), v[indices])
        v_new = acc * inv_deg
        norm = np.abs(v_new).sum()
        if norm == 0:
            break
        v_new /= norm
        delta = np.abs(v_new - v).max()
        v = v_new
        # acceleration-based early stop (Lin & Cohen §3)
        if prev_delta is not None and abs(prev_delta - delta) < tol / num_nodes:
            break
        prev_delta = delta

    return _kmeans_1d(v, num_clusters, seed=seed)


def _kmeans_1d(x: np.ndarray, k: int, iters: int = 50, seed: int = 0) -> np.ndarray:
    """1-D k-means on the PIC pseudo-eigenvector (exact assignment step)."""
    k = max(1, min(k, np.unique(x).size))
    # init centers at quantiles — deterministic and robust for 1-D
    centers = np.quantile(x, np.linspace(0, 1, k))
    for _ in range(iters):
        assign = np.argmin(np.abs(x[:, None] - centers[None, :]), axis=1)
        new_centers = centers.copy()
        for c in range(k):
            m = assign == c
            if m.any():
                new_centers[c] = x[m].mean()
        if np.allclose(new_centers, centers):
            break
        centers = new_centers
    return np.argmin(np.abs(x[:, None] - centers[None, :]), axis=1).astype(np.int32)


def _connected_components(nodes: np.ndarray, indptr, indices) -> list:
    """Connected components restricted to ``nodes`` (BFS)."""
    nodeset = set(nodes.tolist())
    seen = set()
    comps = []
    for start in nodes.tolist():
        if start in seen:
            continue
        comp = []
        stack = [start]
        seen.add(start)
        while stack:
            u = stack.pop()
            comp.append(u)
            for w in indices[indptr[u] : indptr[u + 1]].tolist():
                if w in nodeset and w not in seen:
                    seen.add(w)
                    stack.append(w)
        comps.append(np.asarray(comp, np.int64))
    return comps


def refine_partition(
    num_nodes: int,
    src: np.ndarray,
    dst: np.ndarray,
    coarse: np.ndarray,
    target_size: int = 1024,
) -> np.ndarray:
    """METIS-style refinement: split each coarse cluster into connected,
    BFS-local chunks of at most ``target_size`` nodes; merge tiny chunks
    greedily up to the target.  Returns a community id per node.
    """
    indptr, indices = _csr_from_edges(num_nodes, src, dst)
    community = np.full(num_nodes, -1, np.int64)
    next_id = 0
    for c in np.unique(coarse):
        nodes = np.nonzero(coarse == c)[0]
        pending: list[np.ndarray] = []
        for comp in _connected_components(nodes, indptr, indices):
            if comp.size <= target_size:
                pending.append(comp)
                continue
            # BFS-grow chunks of target_size to keep locality
            compset = set(comp.tolist())
            seen: set = set()
            for s0 in comp.tolist():
                if s0 in seen:
                    continue
                chunk = []
                queue = [s0]
                seen.add(s0)
                while queue and len(chunk) < target_size:
                    u = queue.pop(0)
                    chunk.append(u)
                    for w in indices[indptr[u] : indptr[u + 1]].tolist():
                        if w in compset and w not in seen:
                            seen.add(w)
                            queue.append(w)
                # anything left in queue returns to the pool via outer loop
                for leftover in queue:
                    seen.discard(leftover)
                pending.append(np.asarray(chunk, np.int64))
        # greedy first-fit merge of small chunks
        pending.sort(key=len, reverse=True)
        merged: list[list] = []
        for chunk in pending:
            placed = False
            for m in merged:
                if len(m) + chunk.size <= target_size:
                    m.extend(chunk.tolist())
                    placed = True
                    break
            if not placed:
                merged.append(chunk.tolist())
        for m in merged:
            community[np.asarray(m, np.int64)] = next_id
            next_id += 1
    # isolated / untouched nodes -> own community buckets of target_size
    rest = np.nonzero(community < 0)[0]
    for i in range(0, rest.size, target_size):
        community[rest[i : i + target_size]] = next_id
        next_id += 1
    return community


# ---------------------------------------------------------------------------
# Streaming refresh communities (connected components, exact)
# ---------------------------------------------------------------------------
#
# The training-time pipeline above (PIC + METIS-style refinement) may CUT
# edges when it caps community size — fine for ClusterGCN mini-batching,
# fatal for the batch-layer's community-local refresh, where a community must
# contain the *entire* GNN receptive field of every node it owns so that
# stage-1 embeddings computed per community are bit-identical to the
# whole-graph run.  Refresh communities are therefore the connected
# components of the order↔entity bipartite graph: no DDS edge ever crosses a
# component (orders link only their own entities; entity-history edges stay
# within one entity), so a component is closed under in-neighborhoods at any
# GNN depth.  Components are labeled canonically by their smallest entity id,
# which makes the incremental assignment comparable against the batch one at
# every stream prefix.


def entity_communities(num_entities: int, edges: np.ndarray) -> np.ndarray:
    """Batch oracle: connected-component community id per entity of the
    accumulated bipartite order↔entity graph.

    ``edges`` is the StaticGraph [E, 2] (order, entity) array.  Returns an
    int64 array of length ``num_entities``: the smallest entity id in each
    entity's component (an entity linked to no order is its own singleton
    community).  ``IncrementalPartitioner.assignment()`` must match this on
    the accumulated transactions at any prefix (property-tested).
    """
    community = np.arange(num_entities, dtype=np.int64)
    if edges.size == 0 or num_entities == 0:
        return community
    # union entities that share an order: group edge list by order id
    order_ids = edges[:, 0].astype(np.int64)
    ent_ids = edges[:, 1].astype(np.int64)
    sort = np.argsort(order_ids, kind="stable")
    order_s, ent_s = order_ids[sort], ent_ids[sort]
    parent = np.arange(num_entities, dtype=np.int64)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:            # path compression
            parent[x], x = root, parent[x]
        return root

    start = 0
    for i in range(1, order_s.size + 1):
        if i == order_s.size or order_s[i] != order_s[start]:
            ents = ent_s[start:i]
            r0 = find(int(ents[0]))
            for e in ents[1:]:
                r = find(int(e))
                if r != r0:
                    # union by smaller-root-wins keeps labels canonical-ish;
                    # the final min-label pass below is what actually matters
                    if r < r0:
                        r0, r = r, r0
                    parent[r] = r0
            start = i
    roots = np.fromiter((find(int(e)) for e in range(num_entities)),
                        np.int64, num_entities)
    # label each component by its minimum entity id
    min_of_root: dict = {}
    for e, r in enumerate(roots.tolist()):
        if r not in min_of_root or e < min_of_root[r]:
            min_of_root[r] = e
    return np.fromiter((min_of_root[r] for r in roots.tolist()),
                       np.int64, num_entities)


class IncrementalPartitioner:
    """Streaming connected-component assignment over arriving checkouts.

    Union-find with path compression and union-by-size; every component
    tracks its canonical label (minimum entity id), its member list, and how
    many orders it has absorbed — the bookkeeping the community-local
    refresh driver needs to group dirty ``(entity, t)`` pairs and to
    estimate per-community DDS node counts without touching the full graph.

    ``add_order(entities)`` merges the components of all linked entities
    (the order itself is the merge witness) in O(K·α).  Community ids are
    *canonical, not stable*: when two components merge, the surviving label
    is the smaller of the two minima — callers must resolve
    ``community_of`` at use time, never cache ids across merges.
    ``assignment()`` equals :func:`entity_communities` on the accumulated
    edge list at every prefix (property-tested in
    ``tests/test_refresh_communities.py``).
    """

    def __init__(self):
        self._parent: dict[int, int] = {}
        self._size: dict[int, int] = {}       # component size, by root
        self._min: dict[int, int] = {}        # canonical label, by root
        self._members: dict[int, list] = {}   # entity members, by root
        self._orders: dict[int, int] = {}     # orders absorbed, by root
        self.merges = 0

    def _find(self, e: int) -> int:
        root = e
        while self._parent[root] != root:
            root = self._parent[root]
        while self._parent[e] != root:        # path compression
            self._parent[e], e = root, self._parent[e]
        return root

    def _add_entity(self, e: int) -> int:
        if e not in self._parent:
            self._parent[e] = e
            self._size[e] = 1
            self._min[e] = e
            self._members[e] = [e]
            self._orders[e] = 0
            return e
        return self._find(e)

    def add_order(self, entities) -> int | None:
        """Merge the components of all linked entities; returns the merged
        component's canonical community id (None for entity-less orders,
        which belong to no community and carry no entity embeddings)."""
        ents = [int(e) for e in entities]
        if not ents:
            return None
        r0 = self._add_entity(ents[0])
        for e in ents[1:]:
            r = self._add_entity(e)
            if r == r0:
                continue
            if self._size[r] > self._size[r0]:   # union by size
                r0, r = r, r0
            self._parent[r] = r0
            self._size[r0] += self._size.pop(r)
            self._min[r0] = min(self._min[r0], self._min.pop(r))
            self._members[r0].extend(self._members.pop(r))
            self._orders[r0] += self._orders.pop(r)
            self.merges += 1
        self._orders[r0] += 1
        return self._min[r0]

    def community_of(self, entity: int) -> int:
        """Canonical community id (an entity never seen is its own
        singleton — no state is created for it)."""
        e = int(entity)
        if e not in self._parent:
            return e
        return self._min[self._find(e)]

    def members(self, entity_or_community: int) -> list:
        """All entities in the component containing the given entity (a
        community id IS an entity id — the component's smallest)."""
        e = int(entity_or_community)
        if e not in self._parent:
            return [e]
        return list(self._members[self._find(e)])

    def type_histogram(self, entity_or_community: int) -> dict:
        """Entity-type composition of one community: ``{type_name: count}``.

        Communities are id-agnostic (the union-find never decodes ids), so
        heterogeneous graphs get typed communities for free — this is the
        introspection side: tagged members count under their
        :data:`~repro_torch.core.hetero.ENTITY_TYPE_NAMES` name, untagged ones
        under ``"untyped"``.  A fraud ring shows up here as one community
        whose histogram spans many devices/payments but few buyers.
        """
        from repro_torch.core.hetero import ENTITY_TYPE_NAMES, type_code_of

        hist: dict = {}
        for e in self.members(entity_or_community):
            code = type_code_of(e)
            name = (ENTITY_TYPE_NAMES[code]
                    if 0 <= code < len(ENTITY_TYPE_NAMES) else "untyped")
            hist[name] = hist.get(name, 0) + 1
        return hist

    def order_count(self, entity_or_community: int) -> int:
        """Orders absorbed by the component containing the given entity."""
        e = int(entity_or_community)
        if e not in self._parent:
            return 0
        return self._orders[self._find(e)]

    @property
    def num_communities(self) -> int:
        return len(self._size)

    def assignment(self) -> dict:
        """entity -> canonical community id, for every entity ever seen."""
        return {e: self._min[self._find(e)] for e in self._parent}


def partition_transactions(
    num_orders: int,
    num_entities: int,
    edges: np.ndarray,
    pic_cluster_size: int = 1_000_000,
    community_size: int = 1024,
    seed: int = 0,
) -> np.ndarray:
    """End-to-end partition of the static bipartite graph (paper pipeline).

    Nodes 0..num_orders are orders; entities follow.  Returns a community id
    for every static node; DDS construction then runs per community.
    """
    n = num_orders + num_entities
    src = edges[:, 0].astype(np.int64)
    dst = edges[:, 1].astype(np.int64) + num_orders
    n_pic = max(1, n // max(pic_cluster_size, 1))
    coarse = (
        power_iteration_clustering(n, src, dst, n_pic, seed=seed)
        if n_pic > 1
        else np.zeros(n, np.int32)
    )
    return refine_partition(n, src, dst, coarse, target_size=community_size)
