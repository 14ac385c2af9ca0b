"""``repro_torch.service`` — the one typed serving API.

* :class:`ServiceConfig` (+ its sections) — a single serializable config
  tree subsuming ``LNNConfig`` + ``EngineConfig`` + KV-store kwargs, with
  JSON round-trip and unknown-key rejection;
* :class:`ScoreRequest` / :class:`ScoreResponse` / :class:`ServiceStats` —
  the typed request/response vocabulary shared by every path;
* :class:`FraudService` — one facade with an explicit lifecycle
  (``build -> warmup -> serve -> drain -> close``), ``mode="batch"`` or
  ``mode="streaming"``, versioned model hot-swap, admission control,
  shadow scoring and crash-consistent checkpoint/restore.

Exports resolve lazily (PEP 562): ``repro_torch.service.types`` stays
importable from the ``stream``/``serve`` leaf modules without a cycle, and
importing just the config machinery doesn't drag the whole engine in.
"""
from __future__ import annotations

__all__ = [
    "AdmissionSection",
    "EngineSection",
    "FraudService",
    "LearnSection",
    "ModelSection",
    "RefreshSection",
    "ScoreRequest",
    "ScoreResponse",
    "ServiceConfig",
    "ServiceLifecycleError",
    "ServiceStats",
    "StoreSection",
    "build_service",
]

_HOMES = {
    "AdmissionSection": "repro_torch.service.config",
    "EngineSection": "repro_torch.service.config",
    "LearnSection": "repro_torch.service.config",
    "ModelSection": "repro_torch.service.config",
    "RefreshSection": "repro_torch.service.config",
    "ServiceConfig": "repro_torch.service.config",
    "StoreSection": "repro_torch.service.config",
    "ScoreRequest": "repro_torch.service.types",
    "ScoreResponse": "repro_torch.service.types",
    "ServiceStats": "repro_torch.service.types",
    "FraudService": "repro_torch.service.service",
    "ServiceLifecycleError": "repro_torch.service.service",
    "build_service": "repro_torch.service.service",
}


def __getattr__(name: str):
    home = _HOMES.get(name)
    if home is None:
        raise AttributeError(f"module 'repro_torch.service' has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(home), name)
    globals()[name] = value    # cache: next access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
