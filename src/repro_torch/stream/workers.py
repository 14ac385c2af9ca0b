"""Multi-worker sharded speed layer — ``repro_torch.stream.workers``.

One micro-batch queue on one worker caps the speed layer at a single
dispatch stream; the serving tier, not the model, is the scaling bottleneck
(BRIGHT, arXiv 2205.13084).  This module shards that queue:

* :class:`ShardRouter` — key-affine routing: an event's primary entity maps
  to a worker by the SAME rendezvous hash the KV store uses for
  ``shard_by_entity`` placement (``serve.kvstore.entity_shard``, built on
  ``dist.sharding.rendezvous_shard``), so a request always lands on the
  worker that owns its entity's KV shard.  The worker count is fixed at
  construction and changes ONLY through an explicit :meth:`reshard` —
  never silently (property-tested).
* :class:`SpeedLayerWorker` — one shard's server: its own
  :class:`~repro_torch.stream.microbatch.MicroBatcher` (independent
  size/deadline triggers) and its own :class:`Stage2Scorer` with private
  stage-2 weight packs (production workers are separate processes; private
  packs keep the simulation honest about per-worker warmup).
* :class:`WorkerPool` — fans submissions out through the router, pumps every
  worker's triggers on each virtual-clock advance, steals work from a
  backed-up shard into idle workers, and reassembles flushed scores in
  submission order through a reorder buffer.

Determinism: all queueing decisions run on the virtual clock (arrival
times), service occupancy is modeled by the configurable virtual
``service_model_s`` (0 = infinitely fast workers, the single-worker
default), and per-row scores are invariant to flush composition (pow2
buckets floored at 2 — see ``microbatch.bucket_size`` — the
``stage2_score`` kernel's rows independent of the batch on the card, and
the f64 host sigmoid).  Hence an N-worker replay produces
**bit-identical** scores to the single-worker engine for any N and any
flush interleaving (``tests/test_torch_stream.py`` replay parity).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.hetero import type_code_of
from repro_torch.core.lnn import LNNConfig, lnn_stage2_online
from repro_torch.kernels.stage2_score import flatten_stage2_params, pack_stage2_params
from repro_torch.models.hybrid import HybridModel, embed_rows
from repro_torch.serve.kvstore import KVStore, entity_shard
from repro_torch.serve.lambda_pipeline import host_sigmoid
from repro_torch.stream.microbatch import (
    MicroBatcher,
    PendingFlush,
    ScoredResult,
    ScoreRequest,
    bucket_size,
)
from repro_torch.utils.device import resolve_device


def check_model(params) -> None:
    """Raise ``TypeError`` for a hybrid-looking model (one with
    ``lnn_params``) that is not the port's
    :class:`~repro_torch.models.hybrid.HybridModel` — the reference's, say,
    whose leaves are numpy arrays: ``models.hybrid.load_hybrid`` reads its
    file into the port's."""
    if hasattr(params, "lnn_params") and not isinstance(params, HybridModel):
        raise TypeError(
            f"a hybrid model must be a repro_torch.models.hybrid.HybridModel, "
            f"got {type(params).__module__}.{type(params).__name__}; load its "
            "file with repro_torch.models.hybrid.load_hybrid")


class ShardRouter:
    """Key-affine entity -> worker map (rendezvous placement).

    ``worker_of(entity) == KVStore(shard_by_entity=True).shard_of(key)``
    for every snapshot key of that entity, provided the store's
    ``num_shards`` equals the router's worker count — the pool constructs
    its store that way, so shard ownership and request routing agree by
    construction.

    The mapping is a pure function of (entity, num_workers): two routers
    with the same worker count agree on every entity, and the worker count
    is immutable except through :meth:`reshard` (which bumps ``epoch`` so
    observers can notice).  Growing N -> N+1 moves only ~1/(N+1) of the
    entities, all of them onto the new worker — the rendezvous minimal-
    movement property (property-tested in ``tests/test_workers.py``).
    """

    def __init__(self, num_workers: int):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        self._num_workers = int(num_workers)
        self._epoch = 0

    @property
    def num_workers(self) -> int:
        return self._num_workers

    @property
    def epoch(self) -> int:
        """Bumped on every explicit reshard (observers cache against it)."""
        return self._epoch

    def worker_of(self, entity: int) -> int:
        return entity_shard(int(entity), self._num_workers)

    def route(self, entity_keys: list) -> int:
        """Worker for one request: the shard of its primary (first) entity
        key.  A request's other entities may live on other shards — their
        lookups are cross-shard reads, exactly like a remote KV fetch — but
        the *primary* entity's embedding is always shard-local.  Requests
        with no history (cold start, empty key list) carry no KV reads to
        co-locate; they pin to worker 0."""
        if not entity_keys:
            return 0
        return self.worker_of(entity_keys[0][0])

    def reshard(self, num_workers: int) -> int:
        """The ONLY way to change the worker count.  Returns the new epoch.

        On a live pool call :meth:`WorkerPool.reshard` instead — it drains
        the queues and migrates the worker list and the entity-affine KV
        shards together with the router (the pool guards against a router
        resharded out from under it)."""
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        self._num_workers = int(num_workers)
        self._epoch += 1
        return self._epoch


class Stage2Scorer:
    """The speed-layer scoring callable for one worker: one versioned KV
    multi-get (snapshot fallback + staleness) and ONE ``lnn_stage2_online``
    call on ``device`` (default: CUDA) — on the card, one launch of the
    fused ``stage2_score`` kernel.  Each worker owns its own instance, hence
    its own weight packs.

    The packs are **version-aware**: :meth:`set_model` packs a parameter
    version's weights once (``kernels.stage2_score.pack_stage2_params``)
    and keeps the pack under its version, so swapping back to a
    previously-served version reuses it, and a flush that already entered
    ``__call__`` finishes on the (params, version, pack) triple it captured
    at entry — in-flight micro-batches complete on the old model, the next
    flush scores on the new one.

    A :class:`~repro_torch.models.hybrid.HybridModel` version (GNN
    embedding -> GBDT) has no pack: its flush runs ``lnn_stage2_embed`` on
    ``device`` (``models.hybrid.embed_rows``, one copy back) and the
    booster on the host.
    """

    def __init__(self, params, cfg: LNNConfig, store: KVStore, k_max: int,
                 model_version: int = 0, device=None):
        self.cfg = cfg
        self.store = store
        self.k_max = int(k_max)
        self.device = resolve_device(device)
        self._typed = bool(cfg.entity_types)
        self._packs: dict[int, tuple] = {}     # version -> (params, pack)
        self.set_model(params, model_version)

    def _pack_for(self, params, version: int):
        """The stage-2 pack of ``params`` registered as ``version`` (None for
        a hybrid model), built once per version and again only if the
        version is registered anew with other params."""
        held = self._packs.get(version)
        if held is None or held[0] is not params:
            pack = None
            if not isinstance(params, HybridModel):
                gnn, typed = self.cfg.gnn_type, "typed" in params
                pack = pack_stage2_params(flatten_stage2_params(params, gnn), gnn, typed)
            self._packs[version] = (params, pack)
        return self._packs[version][1]

    def set_model(self, params, model_version: int) -> None:
        """Activate a parameter version.  New flushes score under it.

        ``params`` is an ``lnn_init`` tree or a
        :class:`~repro_torch.models.hybrid.HybridModel`, on this scorer's
        device."""
        check_model(params)
        version = int(model_version)
        pack = self._pack_for(params, version)
        # assign the pack before the version and the params, so that a
        # concurrent flush reading (params, version, pack) at entry never
        # pairs new params with an old version stamp
        self._pack = pack
        self.model_version = version
        self.params = params

    def _slot_types(self, entity_t_lists: list) -> np.ndarray:
        """Per-slot entity-type codes ``[B, k_max]`` (-1 = empty/untagged),
        aligned with the KV lookup's slot order (pair j -> slot j)."""
        st = np.full((len(entity_t_lists), self.k_max), -1, np.int32)
        for i, pairs in enumerate(entity_t_lists):
            for j, (ent, _t) in enumerate(pairs[: self.k_max]):
                st[i, j] = type_code_of(ent)
        return st

    def __call__(self, feats: np.ndarray, entity_t_lists: list):
        # capture the active model ONCE per flush: an in-flight micro-batch
        # finishes on the version it started with even if set_model lands
        # mid-flush (async refresh thread / live hot-swap)
        params, version, pack = self.params, self.model_version, self._pack
        emb, mask, stale = self.store.lookup_batch_versioned(
            entity_t_lists, self.k_max, expected_model_version=version
        )
        return self._score(params, version, pack, feats, entity_t_lists,
                           emb, mask, stale)

    def score_slots(self, feats: np.ndarray, entity_t_lists: list,
                    emb: np.ndarray, mask: np.ndarray, stale: np.ndarray):
        """Score a batch whose KV slots were already resolved (``emb``,
        ``mask``, ``stale`` as ``KVStore.lookup_batch_versioned`` returns
        them) under the active version — the same ``_score`` tail as
        ``__call__``, so numerically identical to it."""
        params, version, pack = self.params, self.model_version, self._pack
        return self._score(params, version, pack, feats, entity_t_lists,
                           emb, mask, stale)

    def _score(self, params, version, pack, feats, entity_t_lists, emb, mask,
               stale):
        dev = self.device
        f = np.ascontiguousarray(feats, np.float32)
        st = None
        if self._typed:
            st = torch.from_numpy(self._slot_types(entity_t_lists)).to(dev)
        emb_t, mask_t = torch.from_numpy(emb).to(dev), torch.from_numpy(mask).to(dev)
        f_t = torch.from_numpy(f).to(dev)
        if isinstance(params, HybridModel):
            # the embedding on the device, the booster on the host: numpy
            # trees are element-deterministic, so replay parity holds
            x = embed_rows(params.lnn_params, self.cfg, emb_t, mask_t, f_t, st)
            probs = params.gbdt.predict_proba(x).astype(np.float32)
            return probs, stale.max(axis=1), version
        with torch.no_grad():
            logits = lnn_stage2_online(params, self.cfg, emb_t, mask_t, f_t,
                                       slot_type=st, pack=pack)
        # host-side f64 sigmoid: numpy ufuncs are element-deterministic for
        # any array length — required for the bit-exact replay parity
        probs = host_sigmoid(logits.cpu().numpy())
        return probs, stale.max(axis=1), version

    def warmup(self, max_batch: int, models: dict | None = None):
        """Run every pow2 bucket shape this worker's batcher can emit, on
        the device, under the active version and under each of ``models``
        (``{version: params}``, their packs built here): the kernel
        library's build, the packs and the first launches are then off the
        measured path, also for a flush right after a hot swap."""
        buckets = sorted({bucket_size(n, max_batch)
                          for n in range(1, max_batch + 1)})
        h, k = self.cfg.hidden_dim, self.k_max
        for b in buckets:
            self(np.zeros((b, self.cfg.feat_dim), np.float32),
                 [[] for _ in range(b)])
        for version, params in (models or {}).items():
            pack = self._pack_for(params, int(version))
            for b in buckets:
                self._score(params, int(version), pack,
                            np.zeros((b, self.cfg.feat_dim), np.float32),
                            [[] for _ in range(b)], np.zeros((b, k, h), np.float32),
                            np.zeros((b, k), np.float32), np.full((b, k), -1, np.int32))


class SpeedLayerWorker:
    """One shard of the speed layer: a private micro-batch queue with
    independent size/deadline flush triggers, private weight packs, and a
    virtual single-server occupancy model.

    ``service_model_s`` is the *virtual* seconds one flush occupies the
    worker (0 = flushes are instantaneous, matching the single-worker
    engine).  While a flush's virtual service window is open the worker
    defers further flushes, its queue backs up past ``max_batch``, and the
    pool's work stealing can move the overflow to an idle worker — all on
    the virtual clock, so replays stay deterministic on any host.
    """

    def __init__(self, wid: int, scorer: Stage2Scorer,
                 max_batch: int = 16, max_wait_s: float = 0.005,
                 service_model_s: float = 0.0):
        self.wid = int(wid)
        self.scorer = scorer
        self.batcher = MicroBatcher(scorer, max_batch=max_batch,
                                    max_wait_s=max_wait_s)
        self.service_model_s = float(service_model_s)
        self.busy_until = 0.0
        # stamps never fall below this: stolen work reached this worker at
        # the steal time, so its recorded waits must not be backdated to
        # the victim's original (long-missed) triggers
        self.stamp_floor = 0.0
        self.stats = {"stolen_in": 0, "stolen_out": 0,
                      "max_queue_depth": 0, "depth_sum": 0,
                      "depth_samples": 0, "restarts": 0}

    def __len__(self) -> int:
        return len(self.batcher)

    def free(self, now: float) -> bool:
        return now >= self.busy_until

    def enqueue(self, req: ScoreRequest) -> None:
        self.batcher.enqueue(req)
        d = len(self.batcher)
        self.stats["max_queue_depth"] = max(self.stats["max_queue_depth"], d)

    def sample_depth(self) -> None:
        """Record queue depth for the bench's mean-depth counter."""
        self.stats["depth_sum"] += len(self.batcher)
        self.stats["depth_samples"] += 1

    def _flush_at(self, trigger: float, kind: str) -> list[ScoredResult]:
        """Serve one flush whose trigger fired at virtual time ``trigger``:
        the flush is stamped when the worker actually gets to it (the
        trigger, the end of the previous flush's service window, or the
        moment stolen work arrived — whichever is latest)."""
        stamp = max(trigger, self.busy_until, self.stamp_floor)
        out = self.batcher.flush(stamp)
        if out:
            self.batcher.stats[kind] += 1
            if isinstance(out, PendingFlush):
                # process backend: the batch is in flight to this worker's
                # shard process; the pool resolves it before any release
                out.worker = self.wid
                out = [out]
            else:
                for r in out:
                    r.worker = self.wid
            if self.service_model_s > 0.0:
                self.busy_until = stamp + self.service_model_s
        return out

    def pump(self, now: float) -> list[ScoredResult]:
        """Run every flush whose trigger has fired and whose service window
        the worker can open by ``now`` — size triggers first (they fired
        earlier, when the queue filled), then the deadline trigger."""
        out: list[ScoredResult] = []
        while len(self.batcher) >= self.batcher.max_batch and self.free(now):
            trigger = self.batcher.nth_arrival(self.batcher.max_batch - 1)
            if trigger is None:      # raced away (steal) — queue re-checked
                break
            out.extend(self._flush_at(trigger, "size_flushes"))
        dl = self.batcher.deadline()
        if dl is not None and now >= dl and self.free(now):
            out.extend(self._flush_at(dl, "deadline_flushes"))
        return out

    def drain(self, now: float | None = None) -> list[ScoredResult]:
        """Force-flush everything queued (stream end).  Without an explicit
        ``now`` each residual batch is stamped at its own deadline — it
        would have flushed then anyway (timer semantics)."""
        out: list[ScoredResult] = []
        while len(self.batcher):
            dl = self.batcher.deadline()
            stamp = now if now is not None else (dl or 0.0)
            out.extend(self._flush_at(stamp, "deadline_flushes"))
        return out


class _ReorderBuffer:
    """Reassemble flushed results in submission (event) order.

    Workers flush independently, so scores surface out of order; the buffer
    holds them until the contiguous prefix of submission sequence numbers
    is complete — the result collector of the fan-out/fan-in topology."""

    def __init__(self):
        self._next = 0
        self._held: dict[int, ScoredResult] = {}
        self.max_held = 0

    def add(self, results: list[ScoredResult]) -> None:
        for r in results:
            self._held[r.request.seq] = r
        self.max_held = max(self.max_held, len(self._held))

    def release(self) -> list[ScoredResult]:
        out = []
        while self._next in self._held:
            out.append(self._held.pop(self._next))
            self._next += 1
        return out

    def __len__(self) -> int:
        return len(self._held)


class WorkerPool:
    """N key-affine speed-layer workers behind one submission interface.

    ``submit(request, now)`` routes by primary entity, pumps every worker's
    flush triggers at the new virtual time, runs the work-stealing pass,
    and returns whatever scored results completed *in submission order*
    (later results are held in the reorder buffer until their turn).

    Work stealing: when a shard's queue backs up past ``steal_threshold``
    requests (only possible when ``service_model_s`` > 0 keeps its worker
    busy), an idle worker with an empty queue takes the oldest half of the
    victim's queue and serves it — affinity is traded away only under
    pressure, and only explicitly (counted in ``stats["steals"]``).

    With ``num_workers=1`` the pool degenerates to exactly the single
    MicroBatcher engine: same triggers, same stamps, same scores.  Every
    worker scores on ``device`` (default: CUDA).
    """

    def __init__(self, params, cfg: LNNConfig, store: KVStore,
                 num_workers: int = 1, k_max: int = 8,
                 max_batch: int = 16, max_wait_s: float = 0.005,
                 service_model_s: float = 0.0,
                 steal_threshold: int | None = None, device=None):
        self.device = resolve_device(device)
        self.router = ShardRouter(num_workers)
        self.store = store
        self.max_batch = int(max_batch)
        self.steal_threshold = steal_threshold
        self.workers = [
            SpeedLayerWorker(
                w,
                Stage2Scorer(params, cfg, store, k_max, device=self.device),
                max_batch=max_batch,
                max_wait_s=max_wait_s,
                service_model_s=service_model_s,
            )
            for w in range(num_workers)
        ]
        self._reorder = _ReorderBuffer()
        self._seq = 0
        self.pool_stats = {"steals": 0, "stolen_requests": 0, "routed": 0}

    @property
    def num_workers(self) -> int:
        return self.router.num_workers

    def __len__(self) -> int:
        return sum(len(w) for w in self.workers)

    # ------------------------------------------------------------------ pump
    def _collect(self, results: list) -> list[ScoredResult]:
        """Resolve any in-flight process flushes before results enter the
        reorder buffer.  Inline flushes are already ScoredResults, so this
        is the identity for the in-process backend; the process backend's
        parallelism comes from several posted flushes resolving here
        together after one pump pass — delivery order, checkpoint state,
        and accounting stay inline-identical."""
        if not any(isinstance(r, PendingFlush) for r in results):
            return results
        out: list[ScoredResult] = []
        for r in results:
            out.extend(r.resolve() if isinstance(r, PendingFlush) else [r])
        return out

    def poll(self, now: float) -> list[ScoredResult]:
        """Advance the virtual clock: fire every due trigger, then let idle
        workers steal from backed-up shards."""
        results: list[ScoredResult] = []
        for w in self.workers:
            results.extend(w.pump(now))
        results.extend(self._steal_pass(now))
        self._reorder.add(self._collect(results))
        return self._reorder.release()

    def submit(self, request: ScoreRequest, now: float) -> list[ScoredResult]:
        """Route and enqueue one request, firing only the target worker's
        own triggers.  Callers advance the virtual clock with ``poll(now)``
        before submitting (the engine does exactly that), so other workers'
        due flushes have already fired — repeating the full sweep here
        would be a per-event no-op."""
        if self.router.num_workers != len(self.workers):
            raise RuntimeError(
                f"router has {self.router.num_workers} workers but the pool "
                f"has {len(self.workers)} — the router was resharded without "
                "the pool; use WorkerPool.reshard(n)"
            )
        request.seq = self._seq
        self._seq += 1
        w = self.workers[self.router.route(request.entity_keys)]
        w.enqueue(request)
        self.pool_stats["routed"] += 1
        results = w.pump(now)
        for worker in self.workers:
            worker.sample_depth()
        self._reorder.add(self._collect(results))
        return self._reorder.release()

    def _steal_pass(self, now: float) -> list[ScoredResult]:
        if self.steal_threshold is None:
            return []
        out: list[ScoredResult] = []
        for thief in self.workers:
            if not thief.free(now) or len(thief) > 0:
                continue
            # deterministic victim choice: deepest queue, lowest wid wins ties
            victim = max(
                (w for w in self.workers if w is not thief),
                key=lambda w: (len(w), -w.wid),
                default=None,
            )
            if victim is None or len(victim) < self.steal_threshold:
                continue
            stolen = victim.batcher.take(len(victim) // 2)
            if not stolen:
                continue
            victim.stats["stolen_out"] += len(stolen)
            thief.stats["stolen_in"] += len(stolen)
            self.pool_stats["steals"] += 1
            self.pool_stats["stolen_requests"] += len(stolen)
            # the work only reached the thief now: flushes of it must not be
            # backdated to the victim's long-missed triggers
            thief.stamp_floor = max(thief.stamp_floor, now)
            for r in stolen:
                thief.enqueue(r)
            out.extend(thief.pump(now))
        return out

    # --------------------------------------------------------------- reshard
    def reshard(self, num_workers: int) -> list[ScoredResult]:
        """Atomically change the worker count on a live pool.

        Drains every queue first (returned in submission order — those
        scores were produced under the old topology), then moves the
        router, the entity-affine KV shards, and the worker list together,
        so the affinity contract ``worker_of(entity) == store.shard_of``
        holds before and after.  New workers start with fresh weight packs —
        a genuinely cold process, as in production."""
        out = self.flush()
        self.router.reshard(num_workers)
        if getattr(self.store, "shard_by_entity", False):
            self.store.reshard(num_workers)
        tmpl = self.workers[0]
        self.workers = [
            SpeedLayerWorker(
                w,
                Stage2Scorer(tmpl.scorer.params, tmpl.scorer.cfg,
                             self.store, tmpl.scorer.k_max,
                             model_version=tmpl.scorer.model_version,
                             device=self.device),
                max_batch=tmpl.batcher.max_batch,
                max_wait_s=tmpl.batcher.max_wait_s,
                service_model_s=tmpl.service_model_s,
            )
            for w in range(num_workers)
        ]
        return out

    # ------------------------------------------------------------- hot-swap
    def set_model(self, params, model_version: int) -> None:
        """Activate a parameter version on every worker.  Flushes already
        executing finish on the version they captured at entry; every
        subsequent flush (on any worker) scores under the new one."""
        for w in self.workers:
            w.scorer.set_model(params, model_version)

    # ------------------------------------------------------------ admission
    def busy_workers(self, now: float) -> int:
        """Workers whose virtual service window is open at ``now`` — the
        admission controller's in-flight count."""
        return sum(1 for w in self.workers if not w.free(now))

    def force_flush_deepest(self, now: float) -> list[ScoredResult]:
        """Flush one batch off the deepest queue at virtual time ``now`` —
        the admission controller's block policy: the producer stalls while
        the most backed-up worker drains a batch.  Returns completed
        results in submission order (empty if every queue is empty)."""
        victim = max(self.workers, key=lambda w: (len(w), -w.wid))
        if len(victim) == 0:
            return []
        results = victim._flush_at(now, "forced_flushes")
        self._reorder.add(self._collect(results))
        return self._reorder.release()

    def drain_to_depth(self, max_depth: int, now: float,
                       budget_s: float | None = None,
                       clock=time.monotonic) -> tuple[list[ScoredResult], bool]:
        """Bounded block-admission wait: force-flush the deepest queue until
        total depth drops below ``max_depth`` or the wall-clock ``budget_s``
        runs out.

        Returns ``(results, admitted)``.  ``admitted`` is False exactly when
        the stall timed out — the budget expired, or a flush pass freed no
        capacity (wedged queue) while a finite budget was set.  With
        ``budget_s=None`` a no-progress pass stops the stall and the caller
        admits over-cap.
        """
        results: list[ScoredResult] = []
        deadline = None if budget_s is None else clock() + budget_s
        while len(self) >= max_depth:
            if deadline is not None and clock() >= deadline:
                return results, False
            before = len(self)
            results.extend(self.force_flush_deepest(now))
            if len(self) >= before:
                # nothing freed (every queue empty, or the flush raced away):
                # an unbounded stall admits over-cap; a bounded one sheds
                return results, deadline is None
        return results, True

    # ----------------------------------------------------------------- drain
    def flush(self, now: float | None = None) -> list[ScoredResult]:
        """Drain every worker's queue (stream end) and the reorder buffer."""
        results: list[ScoredResult] = []
        for w in self.workers:
            results.extend(w.drain(now))
        self._reorder.add(self._collect(results))
        out = self._reorder.release()
        assert len(self._reorder) == 0, "reorder buffer retained results"
        return out

    def warmup(self, models: dict | None = None) -> None:
        """Run every bucket shape on every worker, under the active version
        and under each of ``models`` (``{version: params}``, registered
        versions whose packs are built here)."""
        for w in self.workers:
            w.scorer.warmup(w.batcher.max_batch, models)

    def shutdown(self) -> None:
        """Release backend resources.  The inline pool holds none; the
        process backend overrides this to stop its shard processes and
        unlink shared memory (``FraudService.close`` calls it)."""

    # ----------------------------------------------------------------- stats
    @property
    def stats(self) -> dict:
        """Aggregated MicroBatcher counters across workers (the single-
        worker engine's ``batcher.stats`` shape, so reports don't care
        how many workers ran) plus pool-level routing/steal counters."""
        agg: dict = {}
        for w in self.workers:
            for k, v in w.batcher.stats.items():
                agg[k] = agg.get(k, 0) + v
        agg.update(self.pool_stats)
        agg["reorder_max_held"] = self._reorder.max_held
        return agg

    def worker_summary(self) -> list[dict]:
        out = []
        for w in self.workers:
            s = w.batcher.stats
            mean_depth = (w.stats["depth_sum"] / w.stats["depth_samples"]
                          if w.stats["depth_samples"] else 0.0)
            out.append({
                "worker": w.wid,
                "requests": s["requests"],
                "flushes": s["flushes"],
                "size_flushes": s["size_flushes"],
                "deadline_flushes": s["deadline_flushes"],
                "stolen_in": w.stats["stolen_in"],
                "stolen_out": w.stats["stolen_out"],
                "max_queue_depth": w.stats["max_queue_depth"],
                "mean_queue_depth": mean_depth,
                "queue_depth": len(w),
                "restarts": w.stats.get("restarts", 0),
                "alive": True,
            })
        return out


class DepthAutoscaler:
    """Queue-depth-driven pool sizing + adaptive steal threshold.

    Observes total queued depth once per submission (virtual-clock
    telemetry, so replays are deterministic) and applies classic
    watermark-with-hysteresis control:

    * mean depth per worker above ``high_depth`` for ``sustain``
      consecutive observations -> grow by one worker
      (``WorkerPool.reshard``), up to ``max_workers``;
    * below ``low_depth`` for ``sustain`` observations -> shrink by one,
      down to ``min_workers``;
    * after any reshard, ``cooldown`` observations pass before another
      decision — reshard drains the queues, so depth right after a scale
      event says nothing about steady state.

    With ``adaptive_steal`` the pool's ``steal_threshold`` is re-derived
    each observation from a rolling depth window: twice the rolling mean
    depth per worker, floored at ``max_batch`` — backed-up shards shed
    work sooner under sustained pressure, and stealing quiets down when
    queues are shallow.  All state is plain counters + a bounded window,
    exposed via ``state_dict``/``load_state`` so checkpoints capture it
    and replay reproduces every scale decision bit-identically.
    """

    WINDOW = 32

    def __init__(self, pool: WorkerPool, *, min_workers: int = 1,
                 max_workers: int = 8, high_depth: float = 8.0,
                 low_depth: float = 1.0, sustain: int = 16,
                 cooldown: int = 64, autoscale: bool = True,
                 adaptive_steal: bool = False):
        if not 1 <= min_workers <= max_workers:
            raise ValueError("need 1 <= min_workers <= max_workers")
        if low_depth >= high_depth:
            raise ValueError("low_depth must be < high_depth")
        self.pool = pool
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self.high_depth = float(high_depth)
        self.low_depth = float(low_depth)
        self.sustain = max(1, int(sustain))
        self.cooldown = max(0, int(cooldown))
        self.autoscale = bool(autoscale)
        self.adaptive_steal = bool(adaptive_steal)
        self._above = 0
        self._below = 0
        self._cool = 0
        self._window: list[int] = []
        self.stats = {"scale_ups": 0, "scale_downs": 0, "observations": 0}

    def observe(self, now: float) -> list[ScoredResult]:
        """One control step.  Returns results drained by a reshard (they
        were scored under the old topology and must reach the caller)."""
        pool = self.pool
        depth = len(pool)
        n = pool.num_workers
        self.stats["observations"] += 1
        self._window.append(depth)
        if len(self._window) > self.WINDOW:
            self._window.pop(0)
        if self.adaptive_steal:
            mean = sum(self._window) / len(self._window)
            pool.steal_threshold = max(
                pool.max_batch, int(2.0 * mean / max(1, n)))
        if not self.autoscale:
            return []
        if self._cool > 0:
            self._cool -= 1
            return []
        per_worker = depth / max(1, n)
        self._above = self._above + 1 if per_worker > self.high_depth else 0
        self._below = self._below + 1 if per_worker < self.low_depth else 0
        target = n
        if self._above >= self.sustain and n < self.max_workers:
            target = n + 1
            self.stats["scale_ups"] += 1
        elif self._below >= self.sustain and n > self.min_workers:
            target = n - 1
            self.stats["scale_downs"] += 1
        if target == n:
            return []
        self._above = self._below = 0
        self._cool = self.cooldown
        return pool.reshard(target)

    # ----------------------------------------------------------- durability
    def state_dict(self) -> dict:
        """Control state for the checkpoint manifest — restoring it makes
        WAL-replayed traffic reproduce every scale decision exactly."""
        return {"above": self._above, "below": self._below,
                "cool": self._cool, "window": list(self._window),
                "stats": dict(self.stats)}

    def load_state(self, d: dict) -> None:
        self._above = int(d.get("above", 0))
        self._below = int(d.get("below", 0))
        self._cool = int(d.get("cool", 0))
        self._window = [int(x) for x in d.get("window", [])]
        self.stats.update(d.get("stats", {}))
