"""The port's HTTP gateway (``repro_torch.gateway``) on the CPU.

* Telemetry: the same operations on the port's and the reference's
  ``MetricsRegistry`` render byte-equal text and equal snapshots.
* Every case of the reference's ``tests/test_gateway.py`` against the port:
  wire parity with in-process scoring at one and four workers across a hot
  swap, batch mode over the wire, 429 with ``Retry-After``, 503, the canary
  alert and its silence for an identical clone, concurrent hot swaps under
  load, drain, ingest, ``/metrics`` and ``/v1/stats`` from one snapshot,
  the error paths, ``serve_gateway``, NaN as ``null``.
* The gateway's learn endpoints (``/admin/train``, ``/v1/learn/stats``),
  their 409 without a learner, and auto-rollback armed by canaries only
  (the reference's ``tests/test_learn.py`` cases).
* The same bodies sent to a port gateway and a reference gateway built from
  the same weights: scores within 1e-5, every other field of every answer
  equal (host timings aside).
* ``/admin/checkpoint`` and a crash-consistent boot
  (``tests/test_checkpoint.py::test_gateway_checkpoint_route_and_boot``'s
  counterpart), the rebooted gateway resuming bit for bit.
"""
import dataclasses
import json
import math
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import repro.core as R
import repro.data as RD
import repro.gateway as RG
import repro.service as RSV
from repro_torch.core import LNNConfig, PaddedGraph, lnn_init
from repro_torch.gateway import FraudGateway, GatewayError, MetricsRegistry, serve_gateway
from repro_torch.gateway.server import event_from_json, response_to_json
from repro_torch.params import from_numpy
from repro_torch.service import FraudService, ModelSection, ServiceConfig, ServiceStats
from repro_torch.stream.checkpoint import latest_checkpoint

SCORE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: many small products, and under several test
    workers torch's default of a thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(ref_cfg):
    return LNNConfig(**{f.name: getattr(ref_cfg, f.name)
                        for f in dataclasses.fields(LNNConfig)})


def _to_port(params):
    return from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")


@pytest.fixture(scope="module")
def gateway_world():
    """The reference's stream and weights at the reference test's size, and
    the port's copies (the port's own generator gives the same events)."""
    events, g, _ = RD.generate_event_stream(
        RD.SynthConfig(num_users=60, num_rings=3, feature_noise=0.8, seed=7), rate_per_s=500.0)
    ref_cfg = R.LNNConfig(num_gnn_layers=2, hidden_dim=16, feat_dim=g.order_features.shape[1])
    ref_params = R.lnn_init(jax.random.PRNGKey(0), ref_cfg)
    cfg = _port_cfg(ref_cfg)
    sc = ServiceConfig(model=ModelSection.from_lnn_config(cfg)).replace(
        engine={"max_batch": 8})
    return events, cfg, _to_port(ref_params), sc, ref_cfg, ref_params


class Client:
    """Tiny JSON-over-HTTP helper; never raises on HTTP error status."""

    def __init__(self, url: str):
        self.url = url

    def _do(self, req):
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, dict(r.headers), r.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read()

    def get(self, path: str):
        status, headers, raw = self._do(self.url + path)
        return status, headers, json.loads(raw)

    def get_text(self, path: str):
        status, _, raw = self._do(self.url + path)
        return status, raw.decode()

    def post(self, path: str, body, raw: bytes | None = None):
        data = raw if raw is not None else json.dumps(body).encode()
        req = urllib.request.Request(self.url + path, data=data,
                                     headers={"Content-Type": "application/json"})
        status, headers, out = self._do(req)
        return status, headers, json.loads(out)


def _ev_json(ev, **extra) -> dict:
    return {"order_id": ev.order_id, "snapshot": ev.snapshot,
            "entities": list(ev.entities), "features": ev.features.tolist(),
            "arrival": ev.arrival, **extra}


def _boot(sc, params, **overrides):
    svc = FraudService(sc.replace(**overrides) if overrides else sc, params=params,
                       device="cpu").build()
    gw = FraudGateway(svc).start()
    return gw, Client(gw.url)


# ------------------------------------------------------------------ telemetry
def _telemetry_ops(m):
    c = m.counter("reqs_total", "requests", labelnames=("code",))
    g = m.gauge("depth", "queue depth")
    h = m.histogram("lat_seconds", "latency", buckets=(0.01, 0.1, 1.0))
    lh = m.histogram("ep_seconds", "per endpoint", buckets=(0.001, 0.0025, 0.25),
                     labelnames=("endpoint",))
    odd = m.counter("odd_total", "odd labels", labelnames=("path",))
    m.gauge("never_touched", "no samples, no family lines")
    c.inc(code="200")
    c.inc(2, code="429")
    c.inc(0.5, code="503")
    g.set(7)
    g.inc(-2.25)
    for v in (0.005, 0.05, 0.5, 5.0, 0.1, 1e-9, 0.30000000000000004):
        h.observe(v)
    for ep, v in (("/v1/score", 0.0012), ("/metrics", 0.3), ("/v1/score", 0.002)):
        lh.observe(v, endpoint=ep)
    odd.inc(path='a"b\\c\nd')
    odd.inc(3, path="plain")
    return m


def test_telemetry_is_byte_equal_to_the_reference():
    port = _telemetry_ops(MetricsRegistry())
    ref = _telemetry_ops(RG.MetricsRegistry())
    assert port.render() == ref.render()
    assert port.snapshot() == ref.snapshot()
    assert json.dumps(port.snapshot()) == json.dumps(ref.snapshot())


def test_telemetry_counter_gauge_histogram():
    m = MetricsRegistry()
    c = m.counter("reqs_total", "requests", labelnames=("code",))
    g = m.gauge("depth", "queue depth")
    h = m.histogram("lat_seconds", "latency", buckets=(0.01, 0.1, 1.0))
    c.inc(code="200")
    c.inc(2, code="429")
    g.set(7)
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v)
    assert c.value(code="429") == 2
    with pytest.raises(ValueError, match="only go up"):
        c.inc(-1, code="200")
    with pytest.raises(ValueError, match="expected labels"):
        c.inc(status="200")
    text = m.render()
    assert 'reqs_total{code="429"} 2' in text
    assert "# TYPE lat_seconds histogram" in text
    assert 'lat_seconds_bucket{le="0.01"} 1' in text
    assert 'lat_seconds_bucket{le="1"} 3' in text
    assert 'lat_seconds_bucket{le="+Inf"} 4' in text
    assert "lat_seconds_count 4" in text
    snap = m.snapshot()
    assert snap["reqs_total"] == {"200": 1, "429": 2}
    assert snap["lat_seconds"][""]["count"] == 4
    with pytest.raises(ValueError, match="already registered"):
        m.counter("reqs_total", "dup")
    with pytest.raises(ValueError, match="strictly increasing"):
        m.histogram("bad_seconds", "bad", buckets=(1.0, 0.5))


def test_telemetry_label_escaping():
    m = MetricsRegistry()
    c = m.counter("odd_total", "odd labels", labelnames=("path",))
    c.inc(path='a"b\\c\nd')
    assert r'odd_total{path="a\"b\\c\nd"} 1' in m.render()


def test_telemetry_histogram_never_tears_under_threads():
    """Eight threads observe while a scraper renders: every scrape sees
    ``_count`` equal to the ``+Inf`` bucket, and nothing is lost."""
    import sys

    m = MetricsRegistry()
    h = m.histogram("lat_seconds", "latency", buckets=(0.01, 0.1))
    torn, stop = [], threading.Event()

    def scrape():
        while not stop.is_set():
            lines = dict(ln.rsplit(" ", 1) for ln in m.render().splitlines()
                         if ln and not ln.startswith("#"))
            if lines and lines['lat_seconds_bucket{le="+Inf"}'] != lines["lat_seconds_count"]:
                torn.append(lines)

    def pump():
        for i in range(2000):
            h.observe(0.05 * (i % 3))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=pump) for _ in range(8)]
        scraper = threading.Thread(target=scrape)
        scraper.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        stop.set()
        scraper.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads + [scraper])
    assert not torn and h.count() == 8 * 2000


# ------------------------------------------------------------------ wire codec
def test_wire_codecs():
    ev = event_from_json({"order_id": 3, "snapshot": 2, "entities": [5, 6],
                          "features": [0.1, 0.2], "label": 1, "arrival": 0.5})
    assert (ev.order_id, ev.snapshot, ev.entities, ev.label, ev.arrival) == (3, 2, (5, 6), 1.0,
                                                                          0.5)
    assert ev.features.dtype == np.float32
    ev = event_from_json({"features": [0.0]})
    assert (ev.order_id, ev.snapshot, ev.entities, ev.label) == (-1, 0, (), 0.0)
    with pytest.raises(ValueError, match="features"):
        event_from_json({"entities": [1]})
    assert GatewayError(418, "teapot").status == 418


# ------------------------------------------------------- wire parity (tentpole)
@pytest.mark.parametrize("num_workers", [1, 4])
def test_wire_parity_with_in_process_scoring(gateway_world, num_workers):
    """POST /v1/score over a real socket gives in-process FraudService's
    scores bit for bit on the same stream, across a mid-stream hot swap to
    an identical-weights clone (version bump visible, score bits kept)."""
    events, cfg, params, sc = gateway_world[:4]
    sc = sc.replace(engine={"max_batch": 8, "num_workers": num_workers})
    ref = FraudService(sc, params=params, device="cpu").build().warmup()
    half = len(events) // 2
    ref_out = []
    for ev in events[:half]:
        ref_out.extend(ref.submit(ev))
    ref.activate_model(ref.register_perturbed(0, 0.0, version=1))
    for ev in events[half:]:
        ref_out.extend(ref.submit(ev))
    ref_out.extend(ref.drain())
    ref_scores = {r.request.tag.order_id: (r.score, r.model_version) for r in ref_out}

    svc = FraudService(sc, params=params, device="cpu").build().warmup()
    with FraudGateway(svc) as gw:
        cl = Client(gw.url)
        wire: dict[int, tuple] = {}

        def collect(body):
            for r in body["results"]:
                wire[r["order_id"]] = (r["score"], r["model_version"])

        for ev in events[:half]:
            status, _, body = cl.post("/v1/score", {"event": _ev_json(ev)})
            assert status == 200
            collect(body)
        status, _, body = cl.post("/admin/model", {"role": "primary", "from_version": 0,
                                                   "perturb_scale": 0.0, "version": 1})
        assert status == 200 and body["model_version"] == 1
        rest = events[half:]
        for i in range(0, len(rest), 5):         # batched bodies for the second half
            status, _, body = cl.post("/v1/score",
                                      {"events": [_ev_json(ev) for ev in rest[i:i + 5]]})
            assert status == 200
            collect(body)
        status, _, body = cl.post("/admin/drain", {})
        assert status == 200
        collect(body)
    assert set(wire) == set(ref_scores)
    for oid, (score, version) in ref_scores.items():
        assert wire[oid] == (score, version), oid
    assert {v for _, v in wire.values()} == {0, 1}


def test_batch_mode_over_the_wire(small_communities):
    from repro_torch.serve import history_requests

    batches = [dataclasses.replace(b, graph=PaddedGraph(*b.graph)) for b in small_communities]
    cfg = LNNConfig(num_gnn_layers=2, hidden_dim=16, feat_dim=batches[0].graph.features.shape[1])
    params = lnn_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    sc = ServiceConfig(mode="batch", model=ModelSection.from_lnn_config(cfg))
    ref = FraudService(sc, params=params, device="cpu").build()
    ref.refresh(batches)
    requests = history_requests(batches)[:12]
    ref_scores = [r.score for r in ref.score(requests)]

    svc = FraudService(sc, params=params, store=ref.store, device="cpu").build()
    with FraudGateway(svc) as gw:
        cl = Client(gw.url)
        req_json = [{"features": r.features.tolist(),
                     "entity_keys": [list(k) for k in r.entity_keys]} for r in requests]
        status, _, body = cl.post("/v1/score", {"requests": req_json})
        assert status == 200 and body["scored"] == len(requests)
        assert [r["score"] for r in body["results"]] == ref_scores
        status, _, body = cl.post("/v1/score", {"request": req_json[0]})
        assert status == 200 and body["results"][0]["score"] == ref_scores[0]


# -------------------------------------------------------- socket backpressure
def test_shed_admission_maps_to_429_with_retry_after(gateway_world):
    events, cfg, params, sc = gateway_world[:4]
    gw, cl = _boot(sc, params, engine={"max_batch": 64, "max_wait_s": 1e9},
                   admission={"max_queue_depth": 1, "policy": "shed"},
                   gateway={"retry_after_s": 0.25})
    with gw:
        status, _, body = cl.post("/v1/score", {"event": _ev_json(events[0])})
        assert status == 200
        for ev in events[1:3]:
            status, headers, body = cl.post("/v1/score", {"event": _ev_json(ev)})
            assert status == 429
            assert headers["Retry-After"] == "0.250"
            shed = [r for r in body["results"] if not r["admitted"]]
            assert len(shed) == 1 and shed[0]["score"] is None
        st = gw.service.stats()
        assert st.shed == 2 and st.block_timeouts == 0


def test_block_timeout_maps_to_503(gateway_world):
    events, cfg, params, sc = gateway_world[:4]
    gw, cl = _boot(sc, params, engine={"max_batch": 64, "max_wait_s": 1e9},
                   admission={"max_queue_depth": 1, "policy": "block",
                              "block_max_wait_s": 0.0})
    with gw:
        status, _, _ = cl.post("/v1/score", {"event": _ev_json(events[0])})
        assert status == 200
        status, _, body = cl.post("/v1/score", {"event": _ev_json(events[1])})
        assert status == 503
        assert [r["admitted"] for r in body["results"]] == [False]
        st = gw.service.stats()
        assert st.block_timeouts == 1 and st.shed == 1


# ------------------------------------------------------------ canary / shadow
def test_perturbed_canary_trips_divergence_alert(gateway_world):
    events, cfg, params, sc = gateway_world[:4]
    gw, cl = _boot(sc, params)
    with gw:
        status, _, body = cl.post("/admin/model", {
            "role": "canary", "from_version": 0, "perturb_scale": 2.0, "version": 9,
            "fraction": 1.0, "threshold": 0.05})
        assert status == 200 and body["enabled"]
        for ev in events[:40]:
            cl.post("/v1/score", {"event": _ev_json(ev)})
        cl.post("/admin/drain", {})
        _, _, stats = cl.get("/v1/stats")
        sh = stats["service"]["shadow"]
        assert sh["version"] == 9 and sh["sampled"] > 0
        assert sh["alerts"] > 0 and sh["alert_active"] is True
        assert sh["divergence_max"] > 0.05
        _, text = cl.get_text("/metrics")
        lines = text.splitlines()
        assert "repro_shadow_alert_active 1" in lines
        assert f"repro_shadow_alerts_total {sh['alerts']}" in lines


def test_identical_weights_canary_never_alerts(gateway_world):
    events, cfg, params, sc = gateway_world[:4]
    gw, cl = _boot(sc, params)
    with gw:
        status, _, body = cl.post("/admin/model", {
            "role": "canary", "from_version": 0, "perturb_scale": 0.0, "version": 5,
            "fraction": 1.0, "threshold": 1e-12})
        assert status == 200
        for ev in events[:60]:
            cl.post("/v1/score", {"event": _ev_json(ev)})
        cl.post("/admin/drain", {})
        sh = gw.service.shadow_stats()
        assert sh["sampled"] > 0
        assert sh["divergence_max"] == 0.0 and sh["alerts"] == 0
        status, _, body = cl.post("/admin/model", {"role": "canary"})
        assert status == 200 and body["enabled"] is False
        assert gw.service.shadow_stats() == {}


# --------------------------------------------- concurrent hot-swap under load
def test_concurrent_hot_swap_under_load(gateway_world):
    """Request threads hammer /v1/score while an admin thread flips the
    primary between two identical-weight versions with an identical-weights
    canary on at fraction 1.0: every response carries a registered version,
    the shadow counters never tear (divergence stays exactly 0.0), and the
    per-version counts sum to the scored total."""
    events, cfg, params, sc = gateway_world[:4]
    gw, cl = _boot(sc, params, engine={"max_batch": 4})
    with gw:
        cl.post("/admin/model", {"role": "primary", "from_version": 0, "perturb_scale": 0.0,
                                 "version": 1})
        cl.post("/admin/model", {"role": "canary", "from_version": 0, "perturb_scale": 0.0,
                                 "version": 5, "fraction": 1.0, "threshold": 1e-12})
        n_threads, per_thread = 4, 25
        seen_versions: set[int] = set()
        errors: list = []

        def pump(tid: int):
            mine = Client(gw.url)
            for ev in events[tid * per_thread:(tid + 1) * per_thread]:
                status, _, body = mine.post("/v1/score",
                                            {"event": _ev_json(ev, snapshot=0)})
                if status != 200:
                    errors.append((tid, status, body))
                    return
                for r in body["results"]:
                    seen_versions.add(r["model_version"])

        def flip():
            admin = Client(gw.url)
            for i in range(10):
                status, _, body = admin.post("/admin/model", {"role": "primary",
                                                              "version": i % 2})
                if status != 200:
                    errors.append(("admin", status, body))
                    return

        threads = [threading.Thread(target=pump, args=(t,)) for t in range(n_threads)]
        threads.append(threading.Thread(target=flip))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        status, _, body = cl.post("/admin/drain", {})
        assert status == 200
        for r in body["results"]:
            seen_versions.add(r["model_version"])
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            st = gw.service.stats()
            if st.shadow.get("sampled") == st.scored:
                break
            time.sleep(0.01)
        assert seen_versions <= {0, 1}
        assert st.requests == n_threads * per_thread
        assert st.scored == st.requests
        assert sum(st.scores_by_version.values()) == st.scored
        assert st.shadow["sampled"] == st.scored
        assert st.shadow["divergence_max"] == 0.0 and st.shadow["alerts"] == 0


# ------------------------------------------------- lifecycle + plumbing + ops
def test_healthz_drain_lifecycle(gateway_world):
    events, cfg, params, sc = gateway_world[:4]
    gw, cl = _boot(sc, params)
    with gw:
        status, _, body = cl.get("/healthz")
        assert status == 200 and body["status"] == "ok" and body["dead_workers"] == 0
        cl.post("/v1/score", {"event": _ev_json(events[0])})
        status, _, body = cl.post("/admin/drain", {})
        assert status == 200 and body["state"] == "drained"
        status, _, body = cl.get("/healthz")
        assert status == 503 and body["draining"] is True
        status, _, body = cl.post("/v1/score", {"event": _ev_json(events[1])})
        assert status == 503
        status, _, body = cl.post("/v1/ingest", {"event": _ev_json(events[1])})
        assert status == 503


def test_ingest_endpoint_feeds_batch_layer_only(gateway_world):
    events, cfg, params, sc = gateway_world[:4]
    gw, cl = _boot(sc, params)
    with gw:
        status, _, body = cl.post("/v1/ingest", {"events": [_ev_json(ev) for ev in events[:20]]})
        assert status == 200 and body["ingested"] == 20
        st = gw.service.stats()
        assert st.requests == 0 and st.scored == 0
        assert st.refreshes >= 1 or gw.service.engine.ingester.dirty_count > 0


def test_stats_and_metrics_render_from_one_snapshot(gateway_world):
    events, cfg, params, sc = gateway_world[:4]
    gw, cl = _boot(sc, params)
    with gw:
        for ev in events[:30]:
            cl.post("/v1/score", {"event": _ev_json(ev)})
        cl.post("/admin/drain", {})
        _, _, stats = cl.get("/v1/stats")
        svc_stats = stats["service"]
        _, text = cl.get_text("/metrics")
        lines = text.splitlines()
        assert f"repro_service_requests_total {svc_stats['requests']}" in lines
        assert f"repro_service_scored_total {svc_stats['scored']}" in lines
        assert f"repro_service_store_size {svc_stats['store_size']}" in lines
        for v, n in svc_stats["scores_by_version"].items():
            assert f'repro_service_scores_total{{model_version="{v}"}} {n}' in lines
        assert any(ln.startswith("gateway_http_requests_total{") for ln in lines)
        assert 'endpoint="/v1/score"' in text
        gw_block = stats["gateway"]["metrics"]
        assert sum(n for k, n in gw_block["gateway_http_requests_total"].items()
                   if k.startswith("/v1/score")) == 30
        st = ServiceStats.from_dict(svc_stats)
        assert st.to_dict() == svc_stats


def test_http_error_paths(gateway_world):
    events, cfg, params, sc = gateway_world[:4]
    gw, cl = _boot(sc, params, gateway={"max_body_bytes": 2048})
    with gw:
        status, _, body = cl.get("/nope")
        assert status == 404
        status, _, body = cl.post("/v1/score", None, raw=b"{not json")
        assert status == 400 and "invalid JSON" in body["error"]
        status, _, body = cl.post("/v1/score", {"wrong": 1})
        assert status == 400 and "'event' or 'events'" in body["error"]
        status, _, body = cl.post("/v1/score", {"events": {"not": "a list"}})
        assert status == 400 and "must be a list" in body["error"]
        status, _, body = cl.post("/v1/score", {"event": {"entities": []}})
        assert status == 400 and "features" in body["error"]
        status, _, body = cl.post("/v1/score", {"event": {"features": [0.0] * 4096}})
        assert status == 413
        status, _, body = cl.post("/admin/model", {"role": "shadowy"})
        assert status == 400
        status, _, body = cl.post("/admin/model", {"role": "primary"})
        assert status == 400 and "needs 'version'" in body["error"]
        status, _, body = cl.post("/admin/model", {"role": "primary", "version": 77})
        assert status == 400 and "not registered" in body["error"]
        status, _, body = cl.post("/admin/checkpoint", [])
        assert status == 400
        bc = ServiceConfig(mode="batch", model=ModelSection.from_lnn_config(cfg))
        bsvc = FraudService(bc, params=params, device="cpu").build()
        with FraudGateway(bsvc) as bgw:
            status, _, body = Client(bgw.url).post("/v1/ingest",
                                                   {"event": _ev_json(events[0])})
            assert status == 400 and "streaming" in body["error"]


def test_serve_gateway_one_liner(gateway_world):
    events, cfg, params, sc = gateway_world[:4]
    gw = serve_gateway(sc, params, warmup=False, device="cpu")
    try:
        assert gw.port > 0 and gw.service.device.type == "cpu"
        cl = Client(gw.url)
        status, _, body = cl.post("/v1/score", {"event": _ev_json(events[0])})
        assert status == 200
        status, _, body = cl.get("/healthz")
        assert status == 200
    finally:
        gw.close()
        gw.close()
    with pytest.raises(RuntimeError, match="not started"):
        gw.port   # noqa: B018 — the property raise IS the assertion
    with pytest.raises(ValueError, match="requires gateway.checkpoint_dir"):
        serve_gateway(sc.replace(learn={"enabled": True}), params, warmup=False, device="cpu")


def test_keep_alive_replies_do_not_wait_for_a_delayed_ack(gateway_world):
    """A reply's headers and body go out in two writes; with Nagle's
    algorithm on, a keep-alive client's delayed ACK (~40 ms on Linux) holds
    the second.  Twenty requests on one connection answer in a few ms."""
    import http.client

    params, sc = gateway_world[2], gateway_world[3]
    gw, _ = _boot(sc, params)
    with gw:
        conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=30)
        took = []
        for _ in range(20):
            t0 = time.perf_counter()
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            assert resp.status == 200 and json.loads(resp.read())["status"] == "ok"
            took.append(time.perf_counter() - t0)
        conn.close()
    assert float(np.median(took)) < 0.02, took


def test_gateway_requires_built_service(gateway_world):
    params, sc = gateway_world[2], gateway_world[3]
    svc = FraudService(sc, params=params, device="cpu")
    with pytest.raises(RuntimeError, match="built service"):
        FraudGateway(svc).start()
    built = FraudService(sc, params=params, device="cpu").build()
    gw = FraudGateway(built).start()
    try:
        with pytest.raises(RuntimeError, match="already started"):
            gw.start()
    finally:
        gw.close()


def test_score_response_nan_is_null_on_the_wire(gateway_world):
    events, cfg, params, sc = gateway_world[:4]
    gw, cl = _boot(sc, params, engine={"max_batch": 64, "max_wait_s": 1e9},
                   admission={"max_queue_depth": 1, "policy": "shed"})
    with gw:
        cl.post("/v1/score", {"event": _ev_json(events[0])})
        status, _, body = cl.post("/v1/score", {"event": _ev_json(events[1])})
        raw = json.dumps(body)
        parsed = json.loads(raw, parse_constant=lambda c: pytest.fail(
            f"non-strict JSON constant {c} on the wire"))
        assert parsed["results"][0]["score"] is None
        assert "NaN" not in raw and not any(
            isinstance(r["score"], float) and math.isnan(r["score"])
            for r in parsed["results"])
        shed = gw.service.submit(event_from_json(_ev_json(events[2])))
        assert shed and math.isnan(shed[0].score) and response_to_json(shed[0])["score"] is None


# -------------------------------------------------- the learn plane's endpoints
def _learn_sc(cfg, root, **learn):
    return ServiceConfig(mode="streaming", model=ModelSection.from_lnn_config(cfg)).replace(
        engine={"num_workers": 1, "max_batch": 4}, gateway={"checkpoint_dir": str(root)},
        learn={"enabled": True, "min_window": 4, "stride": 4, "steps": 1, "min_eval": 2,
               "min_eval_pos": 1, "eval_max": 8, **learn})


def test_gateway_learn_endpoints(gateway_world, tmp_path):
    events, cfg, params = gateway_world[:3]
    gw = serve_gateway(_learn_sc(cfg, tmp_path / "wal"), params, device="cpu")
    try:
        assert gw.learner is not None and gw.learner.trainer.device.type == "cpu"
        for ev in events[:6]:
            Client(gw.url).post("/v1/score", {"event": _ev_json(ev, label=float(ev.label))})
        cl = Client(gw.url)
        code, _, out = cl.post("/admin/train", {"force": True})
        assert code == 200
        assert out["trained"] is not None and out["examples"] >= 1
        assert out["state"] == "shadowing" and out["model_version"] == 0
        code, _, stats = cl.get("/v1/learn/stats")
        assert code == 200 and stats["state"] == "shadowing"
        assert stats["trainer"]["fires"] == 1 and stats["fires"] == 1
        _code, metrics = cl.get_text("/metrics")
        assert 'repro_learn_info{state="shadowing"} 1' in metrics
        assert "repro_learn_fires_total 1" in metrics
        assert "repro_service_rollbacks_total 0" in metrics
        code, _, out = cl.post("/admin/train", [])
        assert code == 400
    finally:
        gw.close()
        gw.learner.close()
        gw.service.close()


def test_gateway_learn_endpoints_409_without_learner(gateway_world):
    params, sc = gateway_world[2], gateway_world[3]
    gw = FraudGateway(FraudService(sc, params=params, device="cpu").build()).start()
    try:
        cl = Client(gw.url)
        code, _, out = cl.post("/admin/train", {})
        assert code == 409 and "learn.enabled" in out["error"]
        code, _, _ = cl.get("/v1/learn/stats")
        assert code == 409
    finally:
        gw.close()


@pytest.mark.parametrize("role", ["candidate", "canary"])
def test_gateway_auto_rollback_is_armed_by_canaries_only(gateway_world, role):
    """gateway.auto_rollback fires for a 'canary' shadow's alert (rolling
    back to last-good) and never for a learn 'candidate', which is expected
    to diverge."""
    events, cfg, params = gateway_world[:3]
    sc = ServiceConfig(mode="streaming", model=ModelSection.from_lnn_config(cfg)).replace(
        engine={"num_workers": 1, "max_batch": 4}, gateway={"auto_rollback": True})
    svc = FraudService(sc, params=params, device="cpu").build()
    if role == "candidate":
        v1 = svc.register_perturbed(0, scale=0.0, version=1)
        svc.activate_model(v1)
        shadow = svc.register_perturbed(v1, scale=5.0)
        svc.enable_shadow(shadow, fraction=1.0, threshold=1e-6, collect_eval=8,
                          role="candidate")
    else:
        v1 = svc.register_perturbed(0, scale=5.0)
        svc.activate_model(v1)
        svc.enable_shadow(0, fraction=1.0, threshold=1e-6)
    gw = FraudGateway(svc, config=sc.gateway).start()
    try:
        cl = Client(gw.url)
        for ev in events[:8]:
            cl.post("/v1/score", {"event": _ev_json(ev, order_id=50_000 + ev.order_id)})
        cl.post("/admin/drain", {})
        deadline = time.monotonic() + 10.0      # shadow work follows the response
        while time.monotonic() < deadline and role == "canary" and svc.model_version == v1:
            time.sleep(0.01)
        if role == "candidate":
            assert svc.shadow_stats().get("alert_active") is True
            assert svc.stats().rollbacks == 0 and svc.model_version == v1
        else:
            assert svc.model_version == 0 and svc.stats().rollbacks == 1
            assert "auto-rollback" in svc.last_rollback["reason"]
            _code, metrics = cl.get_text("/metrics")
            assert "repro_service_rollbacks_total 1" in metrics
    finally:
        gw.close()


# ----------------------------------------- port gateway == reference gateway
_TIMINGS = ("queued_s", "service_s")


def _session(cl, events):
    """One fixed sequence of bodies; every answer, in order."""
    out = []
    out.append(cl.get("/healthz")[::2])
    out.append(cl.post("/admin/model", {"role": "canary", "from_version": 0,
                                        "perturb_scale": 0.5, "version": 3, "fraction": 0.5,
                                        "threshold": 0.2})[::2])
    for ev in events[:40]:
        out.append(cl.post("/v1/score", {"event": _ev_json(ev)})[::2])
    out.append(cl.post("/v1/ingest", {"events": [_ev_json(ev) for ev in events[40:50]]})[::2])
    # 16 events at fraction 0.5 sample at most max_batch (8) for the shadow:
    # the reference's shadow scorer raises past that (ROADMAP.md, section 3)
    out.append(cl.post("/v1/score", {"events": [_ev_json(ev) for ev in events[50:66]]})[::2])
    out.append(cl.post("/admin/model", {"role": "primary", "from_version": 0,
                                        "perturb_scale": 0.0, "version": 1})[::2])
    for ev in events[66:90]:
        out.append(cl.post("/v1/score", {"event": _ev_json(ev)})[::2])
    out.append(cl.post("/v1/score", {"oops": 1})[::2])
    out.append(cl.post("/admin/drain", {})[::2])
    out.append(cl.get("/healthz")[::2])
    return out


def _split_scores(node, scores: list):
    """``node`` with every ``score`` (and shadow divergence) pulled out into
    ``scores`` and every host timing dropped."""
    if isinstance(node, dict):
        kept = {}
        for k, v in node.items():
            if k in _TIMINGS:
                continue
            if k in ("score", "divergence_sum", "divergence_max", "last_divergence") \
                    and isinstance(v, float):
                scores.append(v)
                continue
            kept[k] = _split_scores(v, scores)
        return kept
    if isinstance(node, (list, tuple)):
        return [_split_scores(v, scores) for v in node]
    return node


def test_port_gateway_answers_as_the_reference_gateway(gateway_world):
    """The same bodies to a port gateway and a reference gateway built from
    the same weights (a perturbed canary, ingest, a single and a batched
    score body, a hot swap, an error, a drain): every status and every
    field of every answer equal, scores and shadow divergences within
    1e-5, host timings aside; ``/v1/stats`` equal the same way, and
    ``/metrics`` the same series in the same order."""
    events, cfg, params, sc, ref_cfg, ref_params = gateway_world
    ref_sc = RSV.ServiceConfig(model=RSV.ModelSection.from_lnn_config(ref_cfg)).replace(
        engine={"max_batch": 8})
    answers, texts = {}, {}
    for pkg in ("port", "ref"):
        if pkg == "port":
            gw = FraudGateway(FraudService(sc, params=params, device="cpu").build()).start()
        else:
            gw = RG.FraudGateway(RSV.FraudService(ref_sc, params=ref_params).build()).start()
        try:
            cl = Client(gw.url)
            out = _session(cl, events)
            time.sleep(0.2)                      # shadow work follows the last response
            out.append(cl.get("/v1/stats")[::2])
            answers[pkg] = out
            texts[pkg] = cl.get_text("/metrics")[1]
        finally:
            gw.close()
    port_scores, ref_scores = [], []
    port = _split_scores(answers["port"], port_scores)
    ref = _split_scores(answers["ref"], ref_scores)
    # the gateway's own telemetry holds host timings: compare its families
    port_gw, ref_gw = port[-1][1].pop("gateway"), ref[-1][1].pop("gateway")
    for snap in (port[-1][1]["service"], ref[-1][1]["service"]):
        snap["extra"].pop("replay", None)
    assert port == ref
    assert port_gw["metrics"].keys() == ref_gw["metrics"].keys()
    assert port_gw["metrics"]["gateway_http_requests_total"] == \
        ref_gw["metrics"]["gateway_http_requests_total"]
    assert len(port_scores) == len(ref_scores) > 80
    np.testing.assert_allclose(port_scores, ref_scores, rtol=0, atol=SCORE_TOL)

    def series(text):
        return [ln.rsplit(" ", 1)[0] for ln in text.splitlines()]

    assert series(texts["port"]) == series(texts["ref"])


# --------------------------------------------- /admin/checkpoint + crash boot
def test_gateway_checkpoint_route_and_boot(gateway_world, tmp_path):
    """A checkpoint over the wire, then a fresh ``serve_gateway`` on the
    same directory restores instead of building, and scores the next
    events as the uninterrupted gateway does, bit for bit; without a
    directory the route answers 409."""
    events, cfg, params = gateway_world[:3]
    root = str(tmp_path / "gw")
    sc = ServiceConfig(mode="streaming", model=ModelSection.from_lnn_config(cfg)).replace(
        engine={"num_workers": 1, "max_batch": 4}, gateway={"checkpoint_dir": root})

    def scores(cl, evs):
        got = {}
        for ev in evs:
            status, _, body = cl.post("/v1/score", {"event": _ev_json(ev, label=ev.label)})
            assert status == 200
            got.update({r["order_id"]: r["score"] for r in body["results"]})
        return got

    whole = FraudGateway(FraudService(sc.replace(gateway={"checkpoint_dir": None}),
                                      params=params, device="cpu").build()).start()
    try:
        want = scores(Client(whole.url), events[:40])
        want.update({r["order_id"]: r["score"]
                     for r in Client(whole.url).post("/admin/drain", {})[2]["results"]})
    finally:
        whole.close()

    gw = serve_gateway(sc, params, warmup=False, device="cpu")
    try:
        assert gw.service.applied_seq == 0
        first = scores(Client(gw.url), events[:20])
        status, _, payload = Client(gw.url).post("/admin/checkpoint", {"compact": True})
        assert status == 200 and payload["compacted"]
        assert payload["applied_seq"] == 20
        assert latest_checkpoint(root) == payload["checkpoint"]
    finally:
        gw.close()   # the service object is abandoned: the simulated crash

    gw2 = serve_gateway(sc, None, warmup=False, device="cpu")
    try:
        svc = gw2.service
        assert svc.last_recovery is not None and svc.engine.ingester.num_events == 20
        cl = Client(gw2.url)
        later = scores(cl, events[20:40])
        later.update({r["order_id"]: r["score"] for r in cl.post("/admin/drain", {})[2]["results"]})
    finally:
        gw2.close()
    assert {**first, **later} == want

    plain = serve_gateway(sc.replace(gateway={"checkpoint_dir": None}), params, warmup=False,
                          device="cpu")
    try:
        status, _, payload = Client(plain.url).post("/admin/checkpoint", {})
        assert status == 409 and "enable_wal" in payload["error"]
    finally:
        plain.close()
