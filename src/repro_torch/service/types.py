"""Typed serving-API datatypes — ``repro_torch.service.types``.

:class:`ScoreRequest` is what the speed layer scores,
:class:`ScoreResponse` what the service returns for it (the streaming path
calls it ``ScoredResult``) and :class:`ServiceStats` one snapshot of a
service's counters.  A dependency leaf (numpy only).
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields

import numpy as np


@dataclass
class ScoreRequest:
    """One checkout to score.

    ``features`` are the raw order features ([F] float32); ``entity_keys``
    the exact ``(entity, t_e)`` KV keys of its final-hop in-edges (empty =
    cold start).  ``arrival`` is the virtual arrival time a streaming
    scheduler queues on; batch-mode callers may leave it 0.  ``tag`` is a
    caller-opaque id; ``seq`` is a pool's submission-order reorder key.
    """

    features: np.ndarray          # [F]
    entity_keys: list             # [(entity, t_e)]
    arrival: float = 0.0          # virtual arrival time (s)
    tag: object = None            # caller-opaque id
    seq: int = -1                 # submission order (pool reorder key)

    @classmethod
    def from_legacy(cls, r: "ScoreRequest | dict") -> "ScoreRequest":
        """Accept the ``{'features': ..., 'entity_keys': ...}`` dict spelling."""
        if isinstance(r, ScoreRequest):
            return r
        return cls(features=np.asarray(r["features"], np.float32),
                   entity_keys=list(r["entity_keys"]),
                   arrival=float(r.get("arrival", 0.0)))


@dataclass
class ScoreResponse:
    """One scored (or shed) checkout.

    ``model_version`` is the parameter version whose stage-2 pack scored the
    flush (hot-swap observability); ``admitted=False`` marks a request an
    admission controller shed — its ``score`` is NaN and it never entered a
    micro-batch.
    """

    request: ScoreRequest
    score: float
    staleness: int = -1           # max snapshot-staleness over served slots
    queued_s: float = 0.0         # arrival -> flush trigger (virtual)
    service_s: float = 0.0        # batch compute wall time (shared)
    batch_size: int = 1           # real requests in the flush
    worker: int = 0               # speed-layer worker that scored the flush
    model_version: int = 0        # param version whose pack scored it
    admitted: bool = True         # False = shed by admission control


@dataclass
class ServiceStats:
    """One structured snapshot of a :class:`~repro_torch.service.FraudService`.

    Lifecycle state, admission accounting, model-registry state, per-version
    score counts, canary/shadow divergence state, micro-batch/flush
    counters, batch-layer refresh counters, and KV-store internals.
    ``to_dict``/``from_dict`` round-trip losslessly through JSON, so one
    snapshot renders every counter a dashboard reads.
    """

    mode: str = ""                          # "batch" | "streaming"
    state: str = ""                         # lifecycle state
    model_version: int = 0                  # active param version
    model_versions: tuple = ()              # every registered version
    model_swaps: int = 0                    # load_model calls after build
    requests: int = 0                       # offered to the service
    scored: int = 0                         # responses actually scored
    shed: int = 0                           # rejected by admission (policy=shed)
    blocked: int = 0                        # stalled by admission (policy=block)
    block_timeouts: int = 0                 # block stalls that timed out -> shed
    queue_depth: int = 0                    # queued right now (streaming)
    queue_depth_peak: int = 0               # high-water mark since build
    in_flight_peak: int = 0                 # busy-worker high-water mark
    flushes: int = 0
    refreshes: int = 0
    entities_written: int = 0
    model_stale_reads: int = 0              # KV hits stamped by an older model
    store_size: int = 0
    rollbacks: int = 0                      # rollback_model() calls since build
    last_good_version: int | None = None    # rollback target (None = no target)
    scores_by_version: dict = field(default_factory=dict)  # version -> scored
    shadow: dict = field(default_factory=dict)   # canary/shadow divergence state
    store_stats: dict = field(default_factory=dict)
    # one per-worker snapshot (WorkerPool.worker_summary rows: queue depth,
    # flushes, steals, restarts, liveness), read once per stats() call
    workers: list = field(default_factory=list)
    extra: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        """JSON-safe flatten.  ``scores_by_version`` keys become strings
        (JSON object keys always are); ``from_dict`` restores them to ints,
        so ``from_dict(json.loads(json.dumps(to_dict())))`` is lossless."""
        d = dict(self.__dict__)
        d["model_versions"] = list(self.model_versions)
        d["scores_by_version"] = {
            str(k): v for k, v in self.scores_by_version.items()
        }
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ServiceStats":
        """Inverse of :meth:`to_dict`.  Unknown keys are rejected — a
        drifted producer fails loudly."""
        names = {f.name for f in fields(cls)}
        unknown = sorted(set(d) - names)
        if unknown:
            raise ValueError(
                f"unknown key(s) {unknown} in ServiceStats dict — "
                f"valid keys: {sorted(names)}")
        d = dict(d)
        if "model_versions" in d:
            d["model_versions"] = tuple(d["model_versions"])
        if "scores_by_version" in d:
            d["scores_by_version"] = {
                int(k): v for k, v in d["scores_by_version"].items()
            }
        return cls(**d)
