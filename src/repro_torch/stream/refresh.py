"""Async batch-layer refresh driver — the periodic half of the Lambda loop.

Re-runs LNN stage 1 and pushes **only the dirty** entity-snapshot embeddings
(those whose windows closed since the last run) into the KV store with a
monotonically increasing refresh version.  Correctness hinges on the DDS
invariant: an ``entity_t`` vertex's in-neighborhood is final once snapshot
``t`` closes, so its stage-1 embedding computed from the *partial* stream
equals the one the full batch graph would produce — refreshing incrementally
loses nothing.

Community-local mode (the default): instead of padding and re-running
stage 1 over the **entire accumulated DDS graph** — O(total stream) work per
refresh, the unbounded-stream bottleneck — the driver groups dirty
``(entity, t)`` pairs by their connected component of the order↔entity graph
(``StreamIngester.take_refreshable_by_community``), bin-packs those
components into node budgets of at most ``community_size``, materializes
each bin with ``IncrementalDDSBuilder.build_subgraph``, and runs stage 1 per
bin.  Components are closed under DDS in-neighborhoods at any GNN depth, so
every per-community embedding is **bit-identical** to the whole-graph run
(parity-tested in ``tests/test_torch_stream.py``); refresh cost scales
with the communities that changed, not with stream length.  Each bin is
padded to a power-of-two node budget, so stage 1 sees O(log max-community)
shapes as individual communities grow.

Stage 1 runs on ``device`` (default: CUDA): ``lnn_stage1`` over each
padded graph moved to the card, under ``torch.no_grad()``, then one
device-to-host copy per graph — on the card the aggregation kernels
(``csr_spmm`` for gcn and sage, ``edge_softmax`` for gat) launch once per
GNN layer of stage 1.

Worker-aware fan-out: when the engine runs a sharded speed layer, the
driver groups each refresh's puts by the router's entity -> worker map and
writes shard by shard (``stats["per_shard_written"]``).  With an
entity-affine store each group touches exactly one KV shard — the write
pattern a real deployment has, where every worker's KV shard is refreshed
by its own feed from the batch layer.  The refresh version is global (one
batch-layer run is one version, however many shards it fans out to), and
within a group writes stay sorted, so the fan-out is deterministic.

Staleness model: an entity key requested as ``(e, t_e)`` but served from an
older stored snapshot ``t' < t_e`` is ``t_e - t'`` snapshots stale (the KV
store tracks this, see ``lookup_batch_versioned``).  Refreshing every
closed window keeps staleness at zero; refreshing every N windows trades
freshness for batch-layer cost.

``async_mode=True`` runs stage 1 on a single background worker thread (the
batch layer is off the scoring hot path in production); ``drain()`` joins
outstanding work, and completed futures are pruned on every window-close
hook so the in-flight list stays bounded over an unbounded stream.  Grad
mode is per thread in PyTorch, so the worker enters ``torch.no_grad()``
itself; it launches on the device's current stream, the default stream
of both threads, so its kernels and copies are ordered with the scoring
thread's.  Tests use the default synchronous mode.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.core.graph import pad_graph
from repro_torch.core.layers import row_stable_matmul
from repro_torch.core.lnn import LNNConfig, lnn_stage1
from repro_torch.serve.kvstore import KVStore, pack_key
from repro_torch.stream.ingest import StreamIngester
from repro_torch.utils import crashpoint
from repro_torch.utils.device import resolve_device


def _pow2_at_least(n: int, floor: int = 64) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


class RefreshDriver:
    """The batch layer on a timer: when ingest closes snapshot windows, runs
    stage 1 over the affected (community-local by default) subgraph and
    writes the refreshed entity embeddings to the KV store as versioned,
    model-stamped puts — sharded to match the speed layer's key-affine
    routing.  Stage 1 runs on ``device`` (default: CUDA)."""

    def __init__(
        self,
        params,
        cfg: LNNConfig,
        store: KVStore,
        ingester: StreamIngester,
        max_deg: int = 32,
        refresh_every: int = 1,
        async_mode: bool = False,
        router=None,
        community_local: bool = True,
        community_size: int = 4096,
        stage1_executor=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.store = store
        self.ingester = ingester
        self.max_deg = max_deg
        self.refresh_every = max(1, int(refresh_every))
        # anything with worker_of(entity) -> int (stream.workers.ShardRouter);
        # None = single feed, no fan-out grouping
        self.router = router
        self.community_local = bool(community_local)
        self.community_size = max(1, int(community_size))
        self.version = 0
        self.model_version = 0
        # optional off-GIL stage-1 backend:
        # ``executor(padded_graphs, entity_hints, model_version) -> [h]``
        # (``ProcessWorkerPool.refresh_bins``: each padded bin computes in
        # the shard process owning the bin's first dirty entity).  None =
        # stage 1 inline on ``device``.  Padding, bin-packing, and
        # row gathering stay here either way, so executor outputs are
        # bit-identical by the same argument as scoring (pure fixed-shape
        # compute).
        self.stage1_executor = stage1_executor
        self._windows_since_refresh = 0
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=1) if async_mode else None
        self._inflight = []
        # budget_history holds one int per refresh — the per-refresh
        # padded-node cost curve the scope bench plots.  Bounded: over an
        # unbounded stream only the most recent window of refreshes is
        # kept, so the stats dict can never grow without limit
        self.stats = {"refreshes": 0, "entities_written": 0, "seconds": 0.0,
                      "last_budget": 0, "per_shard_written": {},
                      "nodes_padded": 0, "communities_refreshed": 0,
                      "stage1_launches": 0,
                      "budget_history": deque(maxlen=4096)}

    # --------------------------------------------------------------- hot-swap
    def set_model(self, params, model_version: int) -> None:
        """Swap to a new parameter version: refreshes *started* after this
        call compute with it and stamp their KV puts with it (an async
        refresh already snapshotted keeps the params it captured)."""
        with self._lock:
            self.params = params
            self.model_version = int(model_version)

    def _snapshot_model(self):
        """(params, model_version) as one atomic pair — a concurrent
        ``set_model`` can never mix new params with an old version stamp."""
        with self._lock:
            return self.params, self.model_version

    # ----------------------------------------------------------------- policy
    def on_windows_closed(self, closed_window) -> bool:
        """Called by the engine when event time advances past one or more
        snapshots; ``closed_window`` is the (first, last) closed range.
        Triggers a refresh once ``refresh_every`` windows have closed.
        Returns True if a refresh was started (sync: already finished)."""
        if closed_window is None:
            return False
        first, last = closed_window
        self._windows_since_refresh += last - first + 1
        if self._windows_since_refresh < self.refresh_every:
            return False
        # carry the overshoot: a sparse snapshot jump (+5 windows with
        # refresh_every=2) leaves a remainder of 1, so the NEXT close fires
        # after 1 more window, keeping long-run cadence at refresh_every
        self._windows_since_refresh %= self.refresh_every
        up_to = last
        if self._pool is None:
            self.refresh(up_to)
        else:
            # prune completed futures first — over an unbounded stream the
            # in-flight list must stay bounded between drains — and read
            # each one's result, so a refresh that raised (a crash on the
            # worker thread) re-raises here instead of vanishing
            done = [f for f in self._inflight if f.done()]
            self._inflight = [f for f in self._inflight if f not in done]
            for f in done:
                f.result()
            # snapshot the ingester state AND the active model on the
            # calling thread (both keep mutating under new events /
            # hot-swaps); only stage 1 + puts go async
            params, model_version = self._snapshot_model()
            pending, work, n_comms = self._snapshot_graph(up_to)
            if pending:
                self._inflight.append(
                    self._pool.submit(self._run, pending, work, n_comms,
                                      params, model_version))
        return True

    def drain(self):
        """Join outstanding async refreshes (replay-end barrier).  A refresh
        that raised re-raises here, once."""
        inflight, self._inflight = self._inflight, []
        for f in inflight:
            f.result()

    def close(self) -> None:
        """Join outstanding refreshes and stop the async worker thread — the
        thread stops also when a refresh on it raised (a crash there then
        reaches the caller, with no refresh left running)."""
        try:
            self.drain()
        finally:
            if self._pool is not None:
                self._pool.shutdown()

    # ------------------------------------------------------------------- work
    def _snapshot_graph(self, up_to_snapshot: int):
        """Drain dirty pairs and materialize the batch-layer input on the
        calling thread (the builder keeps mutating under new events).

        Returns ``(pending, work, n_communities)`` where ``work`` is the
        full accumulated :class:`DDSGraph` (whole-graph mode) or a list of
        ``(subgraph, pairs)`` community bins (community-local mode)."""
        if not self.community_local:
            pending = self.ingester.take_refreshable(up_to_snapshot)
            return pending, (self.ingester.materialize() if pending else None), 0
        groups = self.ingester.take_refreshable_by_community(up_to_snapshot)
        if not groups:
            return [], None, 0
        pending = sorted(p for _, pairs in groups for p in pairs)
        work = [(self.ingester.materialize_communities(cids), pairs)
                for cids, pairs in self._pack_bins(groups)]
        return pending, work, len(groups)

    def _pack_bins(self, groups) -> list:
        """Greedily pack dirty communities (ascending id — deterministic)
        into bins of at most ``community_size`` DDS nodes; a community
        bigger than the budget forms its own bin.  Fewer stage-1 launches
        for many small communities, one pow2-padded launch per bin."""
        bins: list = []
        cur_cids: list = []
        cur_pairs: list = []
        cur_nodes = 0
        for cid, pairs in groups:
            nodes = self.ingester.community_node_count(cid)
            if cur_cids and cur_nodes + nodes > self.community_size:
                bins.append((cur_cids, cur_pairs))
                cur_cids, cur_pairs, cur_nodes = [], [], 0
            cur_cids.append(cid)
            cur_pairs.extend(pairs)
            cur_nodes += nodes
        if cur_cids:
            bins.append((cur_cids, cur_pairs))
        return bins

    def refresh(self, up_to_snapshot: int) -> dict:
        """Run stage 1 over the dirty communities (or the whole accumulated
        graph with ``community_local=False``); write embeddings for the
        dirty (entity, t) pairs with t <= up_to_snapshot, versioned."""
        params, model_version = self._snapshot_model()
        pending, work, n_comms = self._snapshot_graph(up_to_snapshot)
        if not pending:
            return {"entities_written": 0, "seconds": 0.0}
        return self._run(pending, work, n_comms, params, model_version)

    def _shard_groups(self, pending) -> list[tuple[int, list]]:
        """Group dirty (entity, t) pairs by owning speed-layer shard, shard
        order ascending, sorted within each group — the deterministic
        per-shard write feeds of one batch-layer run."""
        if self.router is None:
            return [(0, sorted(pending))]
        groups: dict[int, list] = {}
        for pair in pending:
            groups.setdefault(self.router.worker_of(pair[0]), []).append(pair)
        return [(s, sorted(groups[s])) for s in sorted(groups)]

    def _run_stage1(self, pgs: list, entity_hints: list, params,
                    model_version: int) -> list[np.ndarray]:
        """One stage-1 forward per padded graph: via the executor (shard
        processes, off the serving GIL) when one is attached, else inline
        on ``device``, one device-to-host copy per graph — identical
        outputs either way.  Its dense products run through
        ``core.layers.row_stable_matmul``, so an entity's row has the same
        bits in a community's bin as in the whole graph.  ``no_grad`` here,
        not in the caller: grad mode is per thread, and this runs on the
        async worker thread too."""
        if self.stage1_executor is not None:
            return self.stage1_executor(pgs, entity_hints, int(model_version))
        out = []
        with torch.no_grad():
            for pg in pgs:
                h = lnn_stage1(params, self.cfg, pg.to(self.device),
                               mm=row_stable_matmul)
                out.append(h.cpu().numpy())
        return out

    def _stage1_embeddings(self, params, model_version, pending,
                           work) -> tuple[dict, int, int]:
        """Run stage 1 over ``work`` and gather the dirty pairs' rows.

        Returns ``({(ent, t): row}, nodes_padded, launches)``.  Each padded
        graph gets a power-of-two node budget, so stage 1 sees O(log N)
        shapes over an unbounded stream, not one per refresh.
        Two passes: pad every bin first, then launch them all through
        ``_run_stage1`` — an executor sees the whole refresh at once and
        can overlap the bins across shard processes."""
        emb: dict = {}
        if isinstance(work, list):          # community-local bins
            pgs, hints, total = [], [], 0
            for sub, pairs in work:
                budget = _pow2_at_least(sub.coo.num_nodes)
                pgs.append(pad_graph(sub.coo, num_nodes=budget,
                                     max_deg=self.max_deg))
                # dispatch hint: the bin's first dirty entity — community-
                # local bins land on the shard process owning their entities
                hints.append(pairs[0][0] if pairs else 0)
                total += budget
            hs = self._run_stage1(pgs, hints, params, model_version)
            for h, (sub, pairs) in zip(hs, work):
                for ent, t in pairs:
                    nid = sub.entity_snap_ids.get((ent, t))
                    if nid is not None:
                        emb[(ent, t)] = h[nid]
            return emb, total, len(work)
        dds = work                           # whole-graph path
        budget = _pow2_at_least(dds.coo.num_nodes)
        pg = pad_graph(dds.coo, num_nodes=budget, max_deg=self.max_deg)
        hint = pending[0][0] if pending else 0
        h = self._run_stage1([pg], [hint], params, model_version)[0]
        for ent, t in pending:
            nid = dds.entity_snap_ids.get((ent, t))
            if nid is not None:
                emb[(ent, t)] = h[nid]
        return emb, budget, 1

    def _run(self, pending, work, n_comms: int, params,
             model_version: int) -> dict:
        crashpoint.fire("refresh.before_stage1")
        t0 = time.monotonic()
        emb, nodes_padded, launches = self._stage1_embeddings(
            params, model_version, pending, work)
        groups = self._shard_groups(pending)
        crashpoint.fire("refresh.before_puts")
        with self._lock:
            self.version += 1
            written = 0
            for shard, pairs in groups:
                # one batched put per shard feed: a single store lock
                # acquisition per group instead of one per embedding
                resolved = [(pack_key(ent, t), emb[(ent, t)])
                            for ent, t in pairs if (ent, t) in emb]
                shard_written = self.store.put_batch(
                    [k for k, _ in resolved],
                    (v for _, v in resolved),
                    version=self.version, model_version=model_version,
                ) if resolved else 0
                per = self.stats["per_shard_written"]
                per[shard] = per.get(shard, 0) + shard_written
                written += shard_written
            # stats are read-modify-writes shared with concurrent sync
            # callers — they stay under the same lock as the puts
            dt = time.monotonic() - t0
            self.stats["refreshes"] += 1
            self.stats["entities_written"] += written
            self.stats["seconds"] += dt
            self.stats["last_budget"] = nodes_padded
            self.stats["nodes_padded"] += nodes_padded
            self.stats["communities_refreshed"] += n_comms
            self.stats["stage1_launches"] += launches
            self.stats["budget_history"].append(nodes_padded)
        crashpoint.fire("refresh.after")
        return {"entities_written": written, "seconds": dt, "version": self.version,
                "shards_touched": len(groups), "nodes_padded": nodes_padded,
                "communities": n_comms, "stage1_launches": launches}
