"""Streaming serving engine — the closed Lambda loop.

Per checkout event:

  event ──> StreamIngester ──────────────┐ (extends DDS graph, dirty marks)
        │        │ window closed?        │
        │        └─> RefreshDriver ──────┤ (stage 1 on closed windows,
        │                                │  per-shard versioned KV puts)
        └─> entity keys ─> ShardRouter ──┴─> SpeedLayerWorker[i] ─> score
                              (key-affine fan-out, N micro-batch queues,
                               reorder buffer reassembles event order)

Scoring is exact with respect to the paper's monolithic forward: when the
refresh driver runs every closed window, each request's ``(entity, t_e)``
keys hit embeddings whose in-neighborhoods were final at refresh time, so
micro-batched speed-layer scores equal ``lnn_forward`` on the full graph
(stage-equivalence test in ``tests/test_torch_stream.py``).  Lower refresh rates
trade exactness for batch-layer cost; the KV fallback then serves older
snapshots and reports staleness per request.

The engine is a thin façade over :class:`~repro_torch.stream.workers.WorkerPool`:
``num_workers=1`` (default) is behaviorally identical to the original
single-queue engine, ``num_workers=N`` shards the micro-batch queue across
N key-affine workers with private weight packs and work stealing — and the
replayed scores stay bit-identical for any N (replay-parity test).

The engine runs a deterministic discrete-event simulation of an N-server
queue: *virtual* arrival times drive flush triggers and the per-flush
virtual service model, *real* wall time is measured for each flush's KV
lookup and stage-2 call, and per-request latency = queue wait + service —
so benchmark numbers are reproducible yet reflect true compute cost.

Both halves run on ``device`` (default: CUDA): the refresh driver's stage 1
and every worker's stage 2 — with ``backend="process"`` in the workers'
shard processes (``repro_torch.stream.procpool``), each on the same device.
With ``device="cpu"`` they take the kernels' plain PyTorch versions.  The
serving entry point is the facade that wraps this engine,
``repro_torch.service.FraudService(mode="streaming")``.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.lnn import LNNConfig
from repro_torch.serve.kvstore import KVStore
from repro_torch.stream.events import CheckoutEvent
from repro_torch.stream.ingest import StreamIngester
from repro_torch.stream.microbatch import ScoredResult, ScoreRequest
from repro_torch.stream.refresh import RefreshDriver
from repro_torch.stream.workers import WorkerPool
from repro_torch.utils.device import resolve_device


def _stage1_params(params):
    """The LNN tree driving batch-layer refreshes: hybrid models carry it
    under ``.lnn_params`` (the booster only replaces online stage 2)."""
    from repro_torch.models.hybrid import HybridModel

    return params.lnn_params if isinstance(params, HybridModel) else params


@dataclass
class EngineConfig:
    """Knobs for :class:`StreamingEngine` — micro-batching, refresh cadence,
    DDS history, KV store sizing/sharding, and the multi-worker speed layer.
    ``FraudService`` builds one from ``ServiceConfig.to_engine_config()``."""

    k_max: int = 8                  # entity slots per request
    max_batch: int = 16             # micro-batch size trigger (per worker)
    max_wait_s: float = 0.005       # micro-batch deadline trigger (virtual s)
    refresh_every: int = 1          # batch-layer cadence, in closed windows
    community_local: bool = True    # refresh only dirty communities (exact)
    community_size: int = 4096      # node budget per stage-1 refresh launch
    entity_history: str = "all"     # DDS history mode (see core.dds)
    max_history: int | None = 8
    max_deg: int = 32               # padded in-degree for the batch graph
    async_refresh: bool = False     # stage 1 on a background thread
    store_capacity: int | None = None    # KV LRU cap (None = unbounded)
    store_ttl_s: float | None = None     # KV TTL (None = no expiry)
    store_shards: int = 4
    # ------------------------------------------------- multi-worker speed layer
    num_workers: int = 1            # sharded micro-batch queues (1 = classic)
    service_model_s: float = 0.0    # virtual service time per flush (0 = instant)
    steal_threshold: int | None = None   # queue depth that triggers stealing
    # None = auto: entity-affine KV shards (num_shards == num_workers) when
    # num_workers > 1, classic key-spread shards otherwise
    shard_by_entity: bool | None = None
    # "inline" = workers simulated in-process (classic); "process" = each
    # worker an OS process owning its KV shard, scheduling stays in the
    # parent (repro_torch.stream.procpool) — replay bit-identical
    backend: str = "inline"


class StreamingEngine:
    """The closed Lambda loop over a live event stream.

    ``submit(event)`` ingests one :class:`CheckoutEvent` (growing the
    incremental DDS, triggering batch-layer refreshes on window close) and
    returns whatever :class:`ScoredResult` lists completed by the event's
    arrival — in submission order, reassembled by the pool's reorder
    buffer; ``flush()`` force-drains every worker queue and
    ``replay(events)`` drives a whole stream and returns a
    :class:`ReplayReport`.

    Per micro-batch flush a worker makes one versioned KV multi-get and ONE
    stage-2 call (``lnn_stage2_online`` — on the card one launch of the
    fused ``stage2_score`` kernel, with the weights packed once per model
    version); the order tower is folded into that call, so the hot path is
    a single fixed-shape kernel per flush, per worker.

    ``device`` (default: CUDA) is where stage 1 and stage 2 run; ``params``
    lie on it.  Constructing the engine directly is deprecated, as in the
    reference: the facade (``repro_torch.service.FraudService``,
    ``mode="streaming"``) wraps it bit-identically and passes
    ``_via_service=True``.
    """

    def __init__(self, params, cfg: LNNConfig, engine_cfg: EngineConfig | None = None,
                 store: KVStore | None = None, _via_service: bool = False,
                 device=None):
        if not _via_service:
            warnings.warn(
                "constructing StreamingEngine directly is deprecated; use "
                "repro_torch.service.FraudService(mode='streaming')",
                DeprecationWarning, stacklevel=2,
            )
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.model_version = 0
        self.ecfg = engine_cfg or EngineConfig()
        backend = self.ecfg.backend
        if backend not in ("inline", "process"):
            raise ValueError(
                f"unknown workers backend {backend!r} (inline | process)")
        by_entity = self.ecfg.shard_by_entity
        if by_entity is None:
            by_entity = self.ecfg.num_workers > 1
        store_kwargs = dict(
            capacity=self.ecfg.store_capacity,
            ttl_seconds=self.ecfg.store_ttl_s,
            # entity-affine mode: one KV shard per worker, placed by the
            # same rendezvous hash the router uses (key-affinity)
            num_shards=(self.ecfg.num_workers if by_entity
                        else self.ecfg.store_shards),
            shard_by_entity=by_entity,
            # heterogeneous model => every entity id must carry a type tag;
            # an untagged id in a typed deployment is a caller bug the
            # store rejects loudly (core.hetero.tag_entity)
            require_typed=bool(cfg.entity_types),
        )
        self.ingester = StreamIngester(
            cfg.feat_dim,
            entity_history=self.ecfg.entity_history,
            max_history=self.ecfg.max_history,
        )
        pool_kwargs = dict(
            num_workers=self.ecfg.num_workers,
            k_max=self.ecfg.k_max,
            max_batch=self.ecfg.max_batch,
            max_wait_s=self.ecfg.max_wait_s,
            service_model_s=self.ecfg.service_model_s,
            steal_threshold=self.ecfg.steal_threshold,
            device=self.device,
        )
        if backend == "process":
            if store is not None:
                raise ValueError(
                    "backend='process' owns its KV shards inside the worker "
                    "processes — an injected store cannot be used")
            from repro_torch.stream.procpool import ProcessWorkerPool

            self.pool = ProcessWorkerPool(
                params, cfg, dict(dim=cfg.hidden_dim, **store_kwargs), **pool_kwargs)
            # the parent-side facade over the children's shards: same read/
            # write/checkpoint surface as the inline KVStore
            self.store = self.pool.store
        else:
            self.store = store or KVStore(cfg.hidden_dim, **store_kwargs)
            self.pool = WorkerPool(params, cfg, self.store, **pool_kwargs)
        self.refresher = RefreshDriver(
            _stage1_params(params), cfg, self.store, self.ingester,
            max_deg=self.ecfg.max_deg,
            refresh_every=self.ecfg.refresh_every,
            async_mode=self.ecfg.async_refresh,
            router=self.pool.router,
            community_local=self.ecfg.community_local,
            community_size=self.ecfg.community_size,
            # process backend: padded stage-1 bins compute in the shard
            # processes, off the serving GIL (bit-identical outputs)
            stage1_executor=(self.pool.refresh_bins
                             if backend == "process" else None),
            device=self.device,
        )

    # ------------------------------------------------------------- speed layer
    def _score_batch(self, feats: np.ndarray, entity_t_lists: list):
        """[B, F] features + per-row (entity, t_e) lists -> (probs, staleness).

        Worker 0's scorer — one KV multi-get (with snapshot fallback) and
        one stage-2 call, the checkout-approval hot path.  Kept as
        the direct entry the benches and parity tests drive (the scorer's
        model-version stamp is dropped here; results carry it)."""
        probs, staleness, _ = self.pool.workers[0].scorer(feats, entity_t_lists)
        return probs, staleness

    def warmup(self):
        """Run every micro-batch bucket shape on every worker up front, on
        the device (cold start off the measured path).  Buckets are the pow2 sizes
        floored at 2 and capped at max_batch — exactly what
        ``bucket_size`` can produce."""
        self.pool.warmup()

    # --------------------------------------------------------------- hot-swap
    def load_model(self, params, version: int | None = None) -> int:
        """Versioned model hot-swap: register ``params`` as the active
        version on every speed-layer worker AND the refresh driver.
        In-flight flushes finish on the weight pack they captured at entry;
        every subsequent flush scores under the new version; subsequent
        batch-layer puts are stamped with it (so reads of pre-swap
        embeddings are detectable via ``store.stats['model_stale_reads']``).
        ``params`` is an ``lnn_init`` tree or a
        :class:`~repro_torch.models.hybrid.HybridModel` on the engine's
        device (the refresh driver then runs stage 1 with the hybrid's
        frozen LNN leaves).
        Returns the version activated (default: current + 1)."""
        if version is None:
            version = self.model_version + 1
        self.params = params
        self.model_version = int(version)
        self.pool.set_model(params, self.model_version)
        self.refresher.set_model(_stage1_params(params), self.model_version)
        return self.model_version

    # ----------------------------------------------------------------- events
    def ingest(self, event: CheckoutEvent) -> ScoreRequest:
        """The ingest half of ``submit``: advance the virtual clock is NOT
        done here — callers poll first.  Extends the DDS, fires the refresh
        hook on window close, and returns the typed request ready for the
        pool (the facade's admission controller sits between this and
        ``pool.submit``)."""
        ing = self.ingester.ingest(event)
        if ing.closed_window is not None:
            self.refresher.on_windows_closed(ing.closed_window)
        return ScoreRequest(
            features=np.asarray(event.features, np.float32),
            entity_keys=ing.entity_keys,
            arrival=event.arrival,
            tag=event,
        )

    def submit(self, event: CheckoutEvent) -> list[ScoredResult]:
        """Ingest one event and return any requests whose flush completed by
        its arrival (deadline flushes for older queued requests fire first,
        then work stealing, then this event's own size trigger)."""
        out = self.pool.poll(event.arrival)
        req = self.ingest(event)
        out.extend(self.pool.submit(req, event.arrival))
        return out

    def flush(self, now: float | None = None) -> list[ScoredResult]:
        """Force-drain every worker queue (stream end).  Without an explicit
        ``now`` each residual batch is stamped at its own queue's deadline —
        it would have flushed then anyway, so recorded queue waits match
        the timer semantics instead of collapsing to zero."""
        self.refresher.drain()
        return self.pool.flush(now)

    # ------------------------------------------------------------------ replay
    def replay(self, events, warmup: bool = True) -> "ReplayReport":
        """Drive a whole event stream through ingest -> refresh -> score."""
        if warmup:
            self.warmup()
        results: list[ScoredResult] = []
        for ev in events:
            results.extend(self.submit(ev))
        results.extend(self.flush())
        self.refresher.drain()
        return ReplayReport(results=results, engine=self)

    # --------------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Release backend resources: joins outstanding refreshes, stops
        the async refresh thread, and stops the process backend's shard
        processes (the inline pool holds nothing else)."""
        self.refresher.close()
        self.pool.shutdown()


@dataclass
class ReplayReport:
    """Outcome of one full stream replay: the admitted per-request results
    plus the engine they ran on, with latency / score / staleness views."""

    results: list
    engine: StreamingEngine
    _lat: np.ndarray | None = field(default=None, repr=False)

    def latencies_s(self) -> np.ndarray:
        """Per-request latency: virtual queue wait + measured service time."""
        if self._lat is None:
            self._lat = np.asarray(
                [r.queued_s + r.service_s for r in self.results], np.float64
            )
        return self._lat

    def percentiles_ms(self) -> dict:
        """p50/p95/p99 + mean, all from the one cached latency pass —
        ``summary`` reads this dict instead of recomputing percentiles and
        the mean through separate paths."""
        lat = self.latencies_s() * 1e3
        if lat.size == 0:
            return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "mean": 0.0}
        p50, p95, p99 = np.percentile(lat, (50, 95, 99))
        return {"p50": float(p50), "p95": float(p95), "p99": float(p99),
                "mean": float(lat.mean())}

    def scores_by_order(self) -> dict:
        return {r.request.tag.order_id: r.score for r in self.results}

    def staleness_summary(self) -> dict:
        s = np.asarray([r.staleness for r in self.results])
        served = s[s >= 0]
        return {
            "mean": float(served.mean()) if served.size else 0.0,
            "max": int(served.max()) if served.size else 0,
            "stale_frac": float((served > 0).mean()) if served.size else 0.0,
        }

    def summary(self) -> dict:
        eng = self.engine
        # ONE latency pass: percentiles_ms() carries the mean too, so the
        # old second walk over latencies_s() for mean_latency_ms is gone
        pct = self.percentiles_ms()
        pool = eng.pool.stats
        service = float(np.mean([r.service_s for r in self.results])) \
            if self.results else 0.0
        return {
            "events": eng.ingester.num_events,
            "scored": len(self.results),
            "num_workers": eng.pool.num_workers,
            "flushes": pool["flushes"],
            "size_flushes": pool["size_flushes"],
            "deadline_flushes": pool["deadline_flushes"],
            "steals": pool["steals"],
            "stolen_requests": pool["stolen_requests"],
            "mean_batch": float(np.mean([r.batch_size for r in self.results]))
            if self.results else 0.0,
            "latency_ms": pct,
            "mean_service_ms": service * 1e3,
            "staleness": self.staleness_summary(),
            "refreshes": eng.refresher.stats["refreshes"],
            "entities_written": eng.refresher.stats["entities_written"],
            "store_size": len(eng.store),
            "store_stats": dict(eng.store.stats),
            "mean_latency_ms": pct["mean"],
            "workers": eng.pool.worker_summary(),
        }
