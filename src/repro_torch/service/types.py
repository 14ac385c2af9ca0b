"""Typed serving-API request — ``repro_torch.service.types``.

Only :class:`ScoreRequest` is ported so far: it is what the speed layer
scores.  A dependency leaf (numpy only).
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
