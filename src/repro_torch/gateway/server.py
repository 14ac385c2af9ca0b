"""HTTP serving gateway over :class:`~repro_torch.service.FraudService` —
``repro_torch.gateway.server``, the reference's ``repro.gateway.server`` on
the port (stdlib HTTP and JSON, copied; the service it wraps runs on the
card by default).

The wire protocol the serving facade was missing: a dependency-free
(stdlib ``http.server`` + JSON) front-end exposing

===========================  ====================================================
``POST /v1/score``           score checkout events (streaming mode) or typed
                             requests (batch mode), single or batch bodies
``POST /v1/ingest``          ingest events into the DDS/batch layer WITHOUT
                             scoring (backfill, non-checkout entity activity)
``GET  /healthz``            lifecycle-aware liveness (503 once draining)
``GET  /v1/stats``           the full ``ServiceStats`` snapshot + gateway
                             telemetry, JSON
``GET  /metrics``            Prometheus text format, rendered from the SAME
                             ``ServiceStats`` snapshot as ``/v1/stats``
``POST /admin/model``        hot-swap the primary model version, register a
                             perturbed clone, or (re)configure the canary
``POST /admin/drain``        finish outstanding work, take the gateway out of
                             rotation (healthz goes 503)
``POST /admin/checkpoint``   write a durable checkpoint of the full streaming
                             state (requires ``gateway.checkpoint_dir``);
                             ``{"compact": true}`` also truncates the WAL
``POST /admin/train``        tick the continuous-learning loop (tap → rolling
                             fine-tune → shadow-gated promotion); requires an
                             attached :class:`~repro_torch.learn.ContinuousLearner`
``GET  /v1/learn/stats``     the learn-plane snapshot: tap cursor/pending,
                             trainer window state, promotion state machine
===========================  ====================================================

**Backpressure at the socket.**  Admission control stops being an
accounting fiction here: a shed request (``admission.policy="shed"``)
returns ``429 Too Many Requests`` with a ``Retry-After`` hint; a block
stall that exceeds ``admission.block_max_wait_s`` returns
``503 Service Unavailable``.  The caller — not a silent queue — absorbs
the overload.

**Canary/shadow scoring.**  ``POST /admin/model`` with ``role="canary"``
enables :meth:`FraudService.enable_shadow`: a sampled fraction of admitted
traffic is re-scored under the canary version *after* the HTTP response
bytes are flushed to the socket (off the response path), and the
|primary − shadow| divergence counters/alert surface in ``/metrics`` and
``/v1/stats``.

**Canary auto-rollback.**  With ``gateway.auto_rollback`` enabled, a
sticky shadow-divergence alert observed after shadow scoring triggers
:meth:`FraudService.rollback_model` — automatic ``activate_model`` back
to the last-good version (``repro_service_rollbacks_total`` counts it) —
instead of page-only alerting.  Only ``canary``-role shadows arm the
trigger; the learn plane's ``candidate``/``last_good`` shadows belong to
the promotion controller.  The controller's rollback path
(``repro_torch.learn.promote``) goes through the same service method, so the
counter and ``last_rollback`` record are shared.

Every touch of the wrapped ``FraudService`` happens under one gateway
RLock — the facade itself is single-threaded by design, the gateway is the
concurrency boundary, so the order of the CUDA work the handler threads
issue is the lock's order.  See ``docs/gateway.md`` for curl examples.
"""
from __future__ import annotations

import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from repro_torch.gateway.telemetry import MetricsRegistry
from repro_torch.service import FraudService, ServiceLifecycleError
from repro_torch.service.config import GatewaySection
from repro_torch.stream.events import CheckoutEvent

#: service lifecycle states /healthz reports ready for traffic
_HEALTHY_STATES = ("built", "ready", "serving")


# ----------------------------------------------------------- wire (de)coding
def event_from_json(d: dict) -> CheckoutEvent:
    """JSON body -> :class:`CheckoutEvent` (the ``/v1/score`` and
    ``/v1/ingest`` streaming-mode unit)."""
    if "features" not in d:
        raise ValueError("event needs a 'features' array")
    return CheckoutEvent(
        order_id=int(d.get("order_id", -1)),
        snapshot=int(d.get("snapshot", 0)),
        entities=tuple(int(e) for e in d.get("entities", ())),
        features=np.asarray(d["features"], np.float32),
        label=float(d.get("label", 0.0)),
        arrival=float(d.get("arrival", 0.0)),
    )


def request_from_json(d: dict) -> dict:
    """JSON body -> the batch-mode score-request dict
    (``FraudService.score`` re-types it via ``ScoreRequest.from_legacy``)."""
    if "features" not in d:
        raise ValueError("request needs a 'features' array")
    return {
        "features": np.asarray(d["features"], np.float32),
        "entity_keys": [(int(e), int(t)) for e, t in d.get("entity_keys", [])],
        "arrival": float(d.get("arrival", 0.0)),
    }


def response_to_json(r) -> dict:
    """``ScoreResponse`` -> JSON-safe dict.  Shed responses carry
    ``score=None`` (their in-process score is NaN, which JSON lacks);
    admitted scores serialize via Python's shortest-round-trip float repr,
    so the wire value parses back bit-identical to the in-process float."""
    tag = r.request.tag
    return {
        "order_id": getattr(tag, "order_id", None),
        "score": None if math.isnan(r.score) else float(r.score),
        "admitted": bool(r.admitted),
        "model_version": int(r.model_version),
        "staleness": int(r.staleness),
        "queued_s": float(r.queued_s),
        "service_s": float(r.service_s),
        "batch_size": int(r.batch_size),
        "worker": int(r.worker),
    }


# -------------------------------------------------- /metrics from ONE snapshot
#: ServiceStats.to_dict() scalar -> (metric name, TYPE); counters follow the
#: Prometheus ``_total`` convention, point-in-time values are gauges
_SERVICE_SCALARS = [
    ("model_version", "repro_service_model_version", "gauge"),
    ("model_swaps", "repro_service_model_swaps_total", "counter"),
    ("requests", "repro_service_requests_total", "counter"),
    ("scored", "repro_service_scored_total", "counter"),
    ("shed", "repro_service_shed_total", "counter"),
    ("blocked", "repro_service_blocked_total", "counter"),
    ("block_timeouts", "repro_service_block_timeouts_total", "counter"),
    ("queue_depth", "repro_service_queue_depth", "gauge"),
    ("queue_depth_peak", "repro_service_queue_depth_peak", "gauge"),
    ("in_flight_peak", "repro_service_in_flight_peak", "gauge"),
    ("flushes", "repro_service_flushes_total", "counter"),
    ("refreshes", "repro_service_refreshes_total", "counter"),
    ("entities_written", "repro_service_entities_written_total", "counter"),
    ("model_stale_reads", "repro_service_model_stale_reads_total", "counter"),
    ("store_size", "repro_service_store_size", "gauge"),
    ("rollbacks", "repro_service_rollbacks_total", "counter"),
    ("last_good_version", "repro_service_last_good_version", "gauge"),
]

_SHADOW_SCALARS = [
    ("version", "repro_shadow_model_version", "gauge"),
    ("fraction", "repro_shadow_fraction", "gauge"),
    ("threshold", "repro_shadow_divergence_threshold", "gauge"),
    ("sampled", "repro_shadow_sampled_total", "counter"),
    ("divergence_sum", "repro_shadow_divergence_sum", "counter"),
    ("divergence_max", "repro_shadow_divergence_max", "gauge"),
    ("last_divergence", "repro_shadow_last_divergence", "gauge"),
    ("alerts", "repro_shadow_alerts_total", "counter"),
    ("alert_active", "repro_shadow_alert_active", "gauge"),
]


def service_metric_lines(snap: dict) -> list[str]:
    """Render the service half of ``GET /metrics`` from a
    ``ServiceStats.to_dict()`` snapshot — the same object ``/v1/stats``
    returns, so the two surfaces can never disagree."""
    lines = [
        "# HELP repro_service_info service mode and lifecycle state",
        "# TYPE repro_service_info gauge",
        f'repro_service_info{{mode="{snap.get("mode", "")}",'
        f'state="{snap.get("state", "")}"}} 1',
    ]

    def emit(name: str, kind: str, value, labels: str = "") -> None:
        lines.append(f"# TYPE {name} {kind}")
        v = float(value)
        lines.append(f"{name}{labels} {int(v) if v.is_integer() else repr(v)}")

    for key, name, kind in _SERVICE_SCALARS:
        if snap.get(key) is not None:   # last_good_version is None-able
            emit(name, kind, snap[key])
    by_version = snap.get("scores_by_version") or {}
    if by_version:
        lines.append("# HELP repro_service_scores_total scored responses "
                     "per model version")
        lines.append("# TYPE repro_service_scores_total counter")
        for v, n in sorted(by_version.items(), key=lambda kv: int(kv[0])):
            lines.append(
                f'repro_service_scores_total{{model_version="{v}"}} {n}')
    shadow = snap.get("shadow") or {}
    for key, name, kind in _SHADOW_SCALARS:
        if key in shadow:
            emit(name, kind, shadow[key])
    for key, value in sorted((snap.get("store_stats") or {}).items()):
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            emit(f"repro_store_{key}_total", "counter", value)
    # per-worker families from the ONE tear-free ServiceStats.workers
    # snapshot (never a second racy pool read)
    workers = snap.get("workers") or []
    if workers:
        for name, kind, key in (
                ("repro_worker_queue_depth", "gauge", "queue_depth"),
                ("repro_worker_flushes_total", "counter", "flushes"),
                ("repro_worker_restarts_total", "counter", "restarts")):
            lines.append(f"# TYPE {name} {kind}")
            for w in workers:
                v = float(w.get(key, 0))
                lines.append(
                    f'{name}{{worker="{w.get("worker", 0)}"}} '
                    f"{int(v) if v.is_integer() else repr(v)}")
        lines.append("# TYPE repro_worker_steals_total counter")
        for w in workers:
            wid = w.get("worker", 0)
            for direction, key in (("in", "stolen_in"), ("out", "stolen_out")):
                lines.append(
                    f'repro_worker_steals_total{{worker="{wid}",'
                    f'direction="{direction}"}} {int(w.get(key, 0))}')
        lines.append("# TYPE repro_worker_alive gauge")
        for w in workers:
            lines.append(
                f'repro_worker_alive{{worker="{w.get("worker", 0)}"}} '
                f"{1 if w.get('alive', True) else 0}")
    return lines


#: learn-plane snapshot key paths -> metric name/TYPE (see learn_metric_lines)
_LEARN_SCALARS = [
    (("fires",), "repro_learn_fires_total", "counter"),
    (("tap", "examples"), "repro_learn_examples_total", "counter"),
    (("tap", "pending"), "repro_learn_label_pending", "gauge"),
    (("tap", "label_joins"), "repro_learn_label_joins_total", "counter"),
    (("tap", "cursor"), "repro_learn_tap_cursor", "gauge"),
    (("promotion", "submitted"), "repro_learn_candidates_total", "counter"),
    (("promotion", "promoted"), "repro_learn_promotions_total", "counter"),
    (("promotion", "rejected"), "repro_learn_rejections_total", "counter"),
    (("promotion", "rollbacks"), "repro_learn_rollbacks_total", "counter"),
]


def learn_metric_lines(stats: dict) -> list[str]:
    """Render the learn-plane half of ``GET /metrics`` from a
    :meth:`~repro_torch.learn.ContinuousLearner.stats` snapshot — the same
    object ``GET /v1/learn/stats`` returns."""
    lines = [
        "# HELP repro_learn_info promotion state machine phase",
        "# TYPE repro_learn_info gauge",
        f'repro_learn_info{{state="{stats.get("state", "")}"}} 1',
    ]
    for path, name, kind in _LEARN_SCALARS:
        node = stats
        for k in path:
            node = node.get(k) if isinstance(node, dict) else None
            if node is None:
                break
        if node is None:
            continue
        v = float(node)
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name} {int(v) if v.is_integer() else repr(v)}")
    return lines


class GatewayError(Exception):
    """A handler-level failure with an HTTP status (rendered as JSON)."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class FraudGateway:
    """The HTTP front-end over one :class:`FraudService`.

    ``start()`` binds ``config.gateway.host:port`` (port 0 = ephemeral; see
    :attr:`port`) and serves on a daemon thread pool (one thread per
    connection — ``ThreadingHTTPServer``); ``close()`` shuts the socket
    down and joins the serve thread.  Usable as a context manager.

    The service must already be ``build()``-ed; ``warmup()`` beforehand
    keeps each micro-batch bucket's first launch off the first request's
    latency.

    ``learner``: an optional :class:`~repro_torch.learn.ContinuousLearner`
    bound to the same service — enables ``POST /admin/train`` and
    ``GET /v1/learn/stats`` (``serve_gateway`` attaches one when
    ``config.learn.enabled``).
    """

    def __init__(self, service: FraudService, config: GatewaySection | None = None,
                 learner=None):
        self.service = service
        self.learner = learner
        self.config = config or service.config.gateway
        self.lock = threading.RLock()
        self.draining = False
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        m = self.metrics = MetricsRegistry()
        self.http_requests = m.counter(
            "gateway_http_requests_total",
            "HTTP requests by endpoint and status code",
            labelnames=("endpoint", "code"))
        self.http_seconds = m.histogram(
            "gateway_http_request_seconds",
            "wall time spent in the handler, per endpoint",
            buckets=self.config.latency_buckets, labelnames=("endpoint",))
        self.scores_total = m.counter(
            "gateway_scores_total",
            "scored responses delivered over the wire, per model version",
            labelnames=("model_version",))
        self.score_seconds = m.histogram(
            "gateway_score_latency_seconds",
            "per-response score latency (queue wait + service time)",
            buckets=self.config.latency_buckets)

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "FraudGateway":
        if self._httpd is not None:
            raise RuntimeError("gateway already started")
        if self.service.state not in _HEALTHY_STATES:
            raise RuntimeError(
                f"gateway needs a built service (state is "
                f"{self.service.state!r}); call build()/warmup() first")
        self._httpd = ThreadingHTTPServer(
            (self.config.host, self.config.port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.gateway = self
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.05},
            name="fraud-gateway", daemon=True)
        self._thread.start()
        return self

    @property
    def port(self) -> int:
        """The bound port (the kernel's pick when configured port was 0)."""
        if self._httpd is None:
            raise RuntimeError("gateway not started")
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.config.host}:{self.port}"

    def close(self) -> None:
        """Stop accepting connections and join the serve thread
        (idempotent).  The wrapped service is left open — callers own its
        lifecycle."""
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._httpd, self._thread = None, None

    def __enter__(self) -> "FraudGateway":
        return self.start() if self._httpd is None else self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- endpoints
    # each handle_* returns (status, payload, headers, shadow_batch); the
    # HTTP layer writes the response FIRST, then feeds shadow_batch to the
    # canary scorer — shadow work never sits on the response path
    def handle_score(self, body: dict):
        if self.draining:
            raise GatewayError(503, "gateway is draining")
        svc = self.service
        if svc.mode == "streaming":
            items, single = self._body_items(body, "event", "events")
            events = [event_from_json(d) for d in items]
            with self.lock:
                results: list = []
                for ev in events:
                    results.extend(svc.submit(ev))
                pending = len(svc.engine.pool)
        else:
            items, single = self._body_items(body, "request", "requests")
            reqs = [request_from_json(d) for d in items]
            with self.lock:
                results = svc.score(reqs)
                pending = 0
        scored = [r for r in results if r.admitted]
        shed = [r for r in results if not r.admitted]
        for r in scored:
            self.scores_total.inc(model_version=r.model_version)
            self.score_seconds.observe(r.queued_s + r.service_s)
        status, headers = 200, {}
        if shed:
            # admission rejections map to socket-level backpressure: shed
            # policy -> 429 (come back later), a timed-out block stall ->
            # 503 (the service is saturated, not just this caller)
            status = 429 if svc.config.admission.policy == "shed" else 503
            headers["Retry-After"] = f"{self.config.retry_after_s:.3f}"
        payload = {
            "results": [response_to_json(r) for r in results],
            "scored": len(scored), "shed": len(shed), "pending": pending,
            "model_version": svc.model_version,
        }
        if single and not results:
            payload["note"] = "queued; results ride a later response or drain"
        return status, payload, headers, scored

    def handle_ingest(self, body: dict):
        if self.draining:
            raise GatewayError(503, "gateway is draining")
        svc = self.service
        if svc.mode != "streaming":
            raise GatewayError(
                400, "ingest without scoring requires mode='streaming'")
        items, _ = self._body_items(body, "event", "events")
        events = [event_from_json(d) for d in items]
        with self.lock:
            for ev in events:
                svc.ingest(ev)
            refreshes = svc.engine.refresher.stats["refreshes"]
        return 200, {"ingested": len(events), "refreshes": refreshes}, {}, None

    def handle_health(self):
        with self.lock:
            state = self.service.state
            version = self.service.model_version
            dead = 0
            eng = self.service.engine
            if self.service.mode == "streaming" and eng is not None:
                # process backend: a dead shard owner means requests routed
                # to it would stall until its heartbeat restart — report
                # not-ready rather than serve into the gap (inline workers
                # are in-process and always "alive")
                dead = sum(1 for row in eng.pool.worker_summary()
                           if not row.get("alive", True))
        ok = (not self.draining) and state in _HEALTHY_STATES and dead == 0
        payload = {"status": "ok" if ok else "unavailable", "state": state,
                   "draining": self.draining, "model_version": version,
                   "dead_workers": dead}
        return (200 if ok else 503), payload, {}, None

    def handle_stats(self):
        with self.lock:
            snap = self.service.stats().to_dict()
        gw = {"draining": self.draining, "metrics": self.metrics.snapshot()}
        return 200, {"service": snap, "gateway": gw}, {}, None

    def handle_metrics(self):
        with self.lock:
            snap = self.service.stats().to_dict()
            learn = self.learner.stats() if self.learner is not None else None
        lines = service_metric_lines(snap)
        if learn is not None:
            lines += learn_metric_lines(learn)
        text = "\n".join(lines) + "\n" + self.metrics.render()
        return 200, text, {"Content-Type": "text/plain; version=0.0.4"}, None

    def handle_learn_stats(self):
        if self.learner is None:
            raise GatewayError(409, "no continuous learner attached — boot "
                                    "with config.learn.enabled=true")
        with self.lock:
            return 200, self.learner.stats(), {}, None

    def handle_admin_train(self, body: dict):
        """One learn tick on demand: poll the WAL tap, fine-tune if the
        rolling window advanced (``{"force": true}`` fires regardless),
        and step the promotion state machine."""
        if self.learner is None:
            raise GatewayError(409, "no continuous learner attached — boot "
                                    "with config.learn.enabled=true")
        if not isinstance(body, dict):
            raise GatewayError(400, "body must be a JSON object")
        force = bool(body.get("force", False))
        now = body.get("now")
        with self.lock:
            out = self.learner.step(
                now=None if now is None else float(now), force=force)
            out["state"] = self.learner.controller.state
            out["model_version"] = self.service.model_version
        return 200, out, {}, None

    def handle_admin_model(self, body: dict):
        svc, role = self.service, body.get("role", "primary")
        if role not in ("primary", "canary"):
            raise GatewayError(400, f"unknown role {role!r} "
                                    "(expected 'primary' or 'canary')")
        with self.lock:
            try:
                version = body.get("version")
                if "from_version" in body:
                    version = svc.register_perturbed(
                        int(body["from_version"]),
                        float(body.get("perturb_scale", 0.0)),
                        seed=int(body.get("seed", 0)),
                        version=version)
                if role == "primary":
                    if version is None:
                        raise GatewayError(
                            400, "role='primary' needs 'version' (or "
                                 "'from_version' to register one)")
                    active = svc.activate_model(int(version))
                    payload = {"role": "primary", "model_version": active,
                               "model_versions": list(svc.model_versions())}
                elif version is None:
                    svc.disable_shadow()
                    payload = {"role": "canary", "enabled": False}
                else:
                    snap = svc.enable_shadow(
                        int(version),
                        fraction=body.get("fraction"),
                        threshold=body.get("threshold"))
                    payload = {"role": "canary", "enabled": True,
                               "shadow": snap}
            except KeyError as exc:
                raise GatewayError(400, str(exc.args[0])) from exc
        return 200, payload, {}, None

    def handle_admin_checkpoint(self, body: dict):
        if not isinstance(body, dict):
            raise GatewayError(400, "body must be a JSON object")
        compact = bool(body.get("compact", False))
        with self.lock:
            try:
                path = self.service.checkpoint(compact=compact)
            except ServiceLifecycleError as exc:
                # no WAL / wrong lifecycle state: a client error, not a 500
                raise GatewayError(409, str(exc)) from exc
            applied = self.service.applied_seq
        return 200, {"checkpoint": path, "applied_seq": applied,
                     "compacted": compact}, {}, None

    def handle_admin_drain(self):
        with self.lock:
            results = self.service.drain()
            self.draining = True
            state = self.service.state
        for r in results:
            self.scores_total.inc(model_version=r.model_version)
            self.score_seconds.observe(r.queued_s + r.service_s)
        return 200, {
            "drained": len(results), "state": state,
            "results": [response_to_json(r) for r in results],
        }, {}, results

    def shadow_after(self, responses: list) -> None:
        """Feed delivered responses to the canary — called by the HTTP
        layer strictly after the response bytes hit the socket.

        With ``gateway.auto_rollback`` enabled, a sticky divergence alert
        raised by this batch triggers the shared rollback path
        (:meth:`FraudService.rollback_model`) when a last-good version
        exists — the swap is immediate, not page-and-wait.  Only
        ``canary``-role shadows arm this: a ``candidate`` shadow is a
        fine-tune that is *expected* to diverge (that's the promotion
        signal), and ``last_good`` watches belong to the
        :class:`~repro_torch.learn.PromotionController`'s own rollback logic."""
        if not responses:
            return
        with self.lock:
            self.service.shadow_observe(responses)
            sh = self.service.shadow_stats()
            if (self.config.auto_rollback
                    and sh.get("role") == "canary"
                    and sh.get("alert_active")
                    and self.service.last_good_version is not None):
                self.service.rollback_model(
                    "gateway auto-rollback: shadow divergence alert")

    @staticmethod
    def _body_items(body: dict, one: str, many: str):
        """Accept ``{one: {...}}`` or ``{many: [...]}`` -> (items, single)."""
        if not isinstance(body, dict):
            raise GatewayError(400, "body must be a JSON object")
        if one in body:
            return [body[one]], True
        if many in body:
            items = body[many]
            if not isinstance(items, list):
                raise GatewayError(400, f"'{many}' must be a list")
            return items, False
        raise GatewayError(400, f"body needs '{one}' or '{many}'")


class _Handler(BaseHTTPRequestHandler):
    """HTTP plumbing only — routing, body limits, JSON framing.  All
    semantics live on :class:`FraudGateway`."""

    protocol_version = "HTTP/1.1"   # keep-alive: bench clients reuse sockets
    # a reply goes out in two writes (headers, then body): with Nagle on, a
    # keep-alive client's delayed ACK holds the second for ~40 ms
    disable_nagle_algorithm = True
    _GET = {"/healthz": "handle_health", "/v1/stats": "handle_stats",
            "/v1/learn/stats": "handle_learn_stats",
            "/metrics": "handle_metrics"}
    _POST = {"/v1/score": "handle_score", "/v1/ingest": "handle_ingest",
             "/admin/model": "handle_admin_model",
             "/admin/drain": "handle_admin_drain",
             "/admin/checkpoint": "handle_admin_checkpoint",
             "/admin/train": "handle_admin_train"}

    @property
    def gateway(self) -> FraudGateway:
        return self.server.gateway

    def log_message(self, *args) -> None:   # quiet: telemetry, not stderr
        pass

    def _endpoint(self, table: dict) -> str | None:
        path = self.path.split("?", 1)[0]
        return path if path in table else None

    def do_GET(self) -> None:
        self._dispatch(self._GET, needs_body=False)

    def do_POST(self) -> None:
        self._dispatch(self._POST, needs_body=True)

    def _dispatch(self, table: dict, needs_body: bool) -> None:
        t0 = time.perf_counter()
        endpoint = self._endpoint(table)
        if endpoint is None:
            self._reply("(404)", 404, {"error": f"no such endpoint {self.path!r}"},
                        {}, t0)
            return
        gw, shadow_batch = self.gateway, None
        try:
            if needs_body:
                body = self._read_json()
                args = () if endpoint.startswith("/admin/drain") else (body,)
            else:
                args = ()
            handler = getattr(gw, table[endpoint])
            status, payload, headers, shadow_batch = handler(*args)
        except GatewayError as exc:
            status, payload, headers = exc.status, {"error": str(exc)}, {}
        except (ValueError, TypeError) as exc:
            status, payload, headers = 400, {"error": str(exc)}, {}
        except Exception as exc:   # noqa: BLE001 — the server must not die
            status, payload, headers = 500, {
                "error": f"{type(exc).__name__}: {exc}"}, {}
        self._reply(endpoint, status, payload, headers, t0)
        # canary work happens AFTER the response is on the wire
        if shadow_batch:
            gw.shadow_after(shadow_batch)

    def _read_json(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        if length > self.gateway.config.max_body_bytes:
            raise GatewayError(
                413, f"body of {length} bytes exceeds max_body_bytes="
                     f"{self.gateway.config.max_body_bytes}")
        raw = self.rfile.read(length) if length else b""
        if not raw:
            return {}
        try:
            return json.loads(raw)
        except json.JSONDecodeError as exc:
            raise GatewayError(400, f"invalid JSON body: {exc}") from exc

    def _reply(self, endpoint: str, status: int, payload, headers: dict,
               t0: float) -> None:
        if isinstance(payload, str):
            data = payload.encode()
            ctype = headers.pop("Content-Type", "text/plain")
        else:
            data = json.dumps(payload).encode()
            ctype = headers.pop("Content-Type", "application/json")
        try:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            for k, v in headers.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass   # client went away; telemetry still records the attempt
        gw = self.gateway
        gw.http_requests.inc(endpoint=endpoint, code=str(status))
        gw.http_seconds.observe(time.perf_counter() - t0, endpoint=endpoint)


def serve_gateway(config, params, *, warmup: bool = True,
                  device=None) -> FraudGateway:
    """One-liner boot: build a :class:`FraudService` from ``config`` +
    ``params`` on ``device`` (default: CUDA, raising without it; ``"cpu"``
    takes the kernels' plain versions), optionally warm it up, and start
    the HTTP gateway on ``config.gateway``.  Returns the started gateway
    (``gateway.service`` reaches the facade; close with
    ``gateway.close()``).

    With ``gateway.checkpoint_dir`` set the boot is crash-consistent: if
    the directory already holds durable state (a ``service.json`` written
    by a previous ``enable_wal``), the service is *restored* from its
    latest checkpoint + WAL suffix instead of built fresh — ``params`` is
    ignored on that path because the restored model registry is
    authoritative.  A fresh directory gets a fresh build with the
    write-ahead log enabled under it.
    """
    import os

    from repro_torch.service import build_service
    from repro_torch.service.config import ServiceConfig
    from repro_torch.utils.device import resolve_device

    device = resolve_device(device)
    if isinstance(config, dict):
        config = ServiceConfig.from_dict(config)
    root = config.gateway.checkpoint_dir
    if root and os.path.exists(os.path.join(root, "service.json")):
        svc = FraudService.restore(root, device=device)
        if warmup and svc.state in ("built", "ready"):
            svc.warmup()
    else:
        svc = build_service(config, params, warmup=warmup, device=device)
        if root:
            svc.enable_wal(root)
    gw = config.gateway
    if svc.wal is not None and (gw.checkpoint_every_s is not None
                                or gw.checkpoint_every_windows is not None):
        # scheduled checkpointing is process-local cadence state — re-armed
        # on every boot, including restores
        svc.enable_auto_checkpoint(
            every_s=gw.checkpoint_every_s,
            every_windows=gw.checkpoint_every_windows,
            keep_last=gw.checkpoint_keep_last)
    learner = None
    if config.learn.enabled:
        if svc.wal is None:
            raise ValueError(
                "learn.enabled=true requires gateway.checkpoint_dir — the "
                "continuous learner taps the write-ahead log")
        from repro_torch.learn import ContinuousLearner

        learner = ContinuousLearner(svc)
    return FraudGateway(svc, learner=learner).start()


__all__ = ["FraudGateway", "GatewayError", "learn_metric_lines",
           "serve_gateway", "event_from_json", "request_from_json",
           "response_to_json", "service_metric_lines"]
