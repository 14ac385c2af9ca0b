"""Typed serving-API request and response — ``repro_torch.service.types``.

:class:`ScoreRequest` is what the speed layer scores and
:class:`ScoreResponse` what the streaming engine returns for it (the
streaming path calls it ``ScoredResult``).  A dependency leaf (numpy only).
"""
from __future__ import annotations

from dataclasses import dataclass

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
