"""``repro_torch.gateway`` — the HTTP serving gateway over ``repro_torch.service``
(the reference's ``repro.gateway`` on the port: stdlib HTTP and JSON, copied).

The wire protocol the typed facade was missing: a dependency-free
(stdlib ``http.server`` + JSON) front-end exposing score/ingest/health/
stats endpoints, ``/metrics`` in the Prometheus text format, an admin
surface for model hot-swap + canary/shadow scoring, and real socket-level
backpressure (admission shed → ``429 Retry-After``, timed-out block
stall → ``503``).

* :class:`FraudGateway` — binds ``config.gateway.host:port`` over one
  built :class:`~repro_torch.service.FraudService`; context-manager lifecycle;
* :func:`serve_gateway` — one-liner boot (build + warmup + start);
* :class:`MetricsRegistry` / :class:`Counter` / :class:`Gauge` /
  :class:`Histogram` — the Prometheus-style telemetry primitives
  (``repro_torch.gateway.telemetry``) the gateway records into.

See ``docs/gateway.md`` for the endpoint table and curl examples.

Exports resolve lazily (PEP 562), matching ``repro_torch.service``: importing
the package does not start a server or build a kernel.
"""
from __future__ import annotations

__all__ = [
    "Counter",
    "FraudGateway",
    "Gauge",
    "GatewayError",
    "Histogram",
    "MetricsRegistry",
    "serve_gateway",
]

_HOMES = {
    "FraudGateway": "repro_torch.gateway.server",
    "GatewayError": "repro_torch.gateway.server",
    "serve_gateway": "repro_torch.gateway.server",
    "Counter": "repro_torch.gateway.telemetry",
    "Gauge": "repro_torch.gateway.telemetry",
    "Histogram": "repro_torch.gateway.telemetry",
    "MetricsRegistry": "repro_torch.gateway.telemetry",
}


def __getattr__(name: str):
    home = _HOMES.get(name)
    if home is None:
        raise AttributeError(f"module 'repro_torch.gateway' has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(home), name)
    globals()[name] = value    # cache: next access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
