"""repro_torch.stream — real-time streaming ingestion + micro-batched
speed-layer serving engine (the closed Lambda loop), with a multi-worker
sharded speed layer (``repro_torch.stream.workers``) and crash-consistent
checkpoint/restore with a write-ahead log (``repro_torch.stream.checkpoint``,
driven through ``repro_torch.service.FraudService``), and a process backend
whose workers are spawned shard processes (``repro_torch.stream.procpool``).
Stage 1 and stage 2 run on the card by default."""
from repro_torch.stream.engine import EngineConfig, ReplayReport, StreamingEngine
from repro_torch.stream.events import CheckoutEvent, events_from_static, order_event_tuples
from repro_torch.stream.ingest import IngestResult, StreamIngester
from repro_torch.stream.microbatch import (
    DeferredScore,
    MicroBatcher,
    PendingFlush,
    ScoredResult,
    ScoreRequest,
)
from repro_torch.stream.procpool import ProcessWorkerPool, ProcStoreView, ShardServer
from repro_torch.stream.refresh import RefreshDriver
from repro_torch.stream.workers import (
    DepthAutoscaler,
    ShardRouter,
    SpeedLayerWorker,
    Stage2Scorer,
    WorkerPool,
)

__all__ = [
    "CheckoutEvent",
    "DeferredScore",
    "DepthAutoscaler",
    "EngineConfig",
    "IngestResult",
    "MicroBatcher",
    "PendingFlush",
    "ProcStoreView",
    "ProcessWorkerPool",
    "RefreshDriver",
    "ReplayReport",
    "ScoreRequest",
    "ScoredResult",
    "ShardRouter",
    "ShardServer",
    "SpeedLayerWorker",
    "Stage2Scorer",
    "StreamIngester",
    "StreamingEngine",
    "WorkerPool",
    "events_from_static",
    "order_event_tuples",
]
