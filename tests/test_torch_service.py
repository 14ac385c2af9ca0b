"""The port's serving facade (``repro_torch.service``) on the CPU: its
``ServiceConfig`` artifact is the reference's (the same JSON text, loadable
either way); ``FraudService`` keeps the reference's lifecycle, mode guards,
hot swap, admission and shadow rules; it scores bit for bit as the port's
own ``BatchLayer``/``SpeedLayer`` and ``StreamingEngine``; and, run beside
the reference's ``FraudService`` on the same events and weights, it gives
its scores within 1e-5 and its KV store within 2e-5 (f32 on both sides,
summed in another order), with the same flush, staleness and admission
counts."""
import dataclasses
import json
import math
import warnings

import jax
import numpy as np
import pytest
import torch

import repro.core as R
import repro.data as RD
import repro.service as RSV
import repro_torch.service as PSV
from repro_torch.core import LNNConfig, PaddedGraph, lnn_init
from repro_torch.data import SynthConfig, generate_event_stream
from repro_torch.params import from_numpy
from repro_torch.serve import BatchLayer, KVStore, SpeedLayer, history_requests
from repro_torch.service import (FraudService, ModelSection, ScoreRequest, ServiceConfig,
                                 ServiceLifecycleError, ServiceStats, build_service)
from repro_torch.stream import StreamingEngine

GNN_TYPES = ["gcn", "gat", "sage"]
WORLD = dict(num_users=40, num_rings=2, feature_noise=0.8, seed=7)
RATE = 500.0
N_EVENTS = 90
SCORE_TOL = 1e-5     # scores, f32 on both sides
STORE_TOL = 2e-5     # stage-1 embeddings in the KV store


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


def _store_contents(store) -> dict:
    """key -> (value, model version) of every entry of every shard."""
    return {k: (e.value, e.model_version) for shard in store._shards for k, e in shard.items()}


def _engine(params, cfg, ecfg):
    with warnings.catch_warnings():      # direct construction is deprecated
        warnings.simplefilter("ignore", DeprecationWarning)
        return StreamingEngine(params, cfg, ecfg, device="cpu")


@pytest.fixture(scope="module")
def world():
    """The stream (the reference's and the port's, from one seed), one
    reference parameter set and the port's copy of it."""
    ref_events, g, _ = RD.generate_event_stream(RD.SynthConfig(**WORLD), rate_per_s=RATE)
    events, _, _ = generate_event_stream(SynthConfig(**WORLD), rate_per_s=RATE)
    ref_cfg = R.LNNConfig(num_gnn_layers=2, hidden_dim=16, mlp_dims=(16,),
                          feat_dim=g.order_features.shape[1])
    params = R.lnn_init(jax.random.PRNGKey(0), ref_cfg)
    cfg = _port_cfg(ref_cfg)
    sc = ServiceConfig(model=ModelSection.from_lnn_config(cfg)).replace(
        engine={"max_batch": 8})
    return dict(ref_events=ref_events[:N_EVENTS], events=events[:N_EVENTS], ref_cfg=ref_cfg,
                ref_params=params, cfg=cfg, params=_to_port(params), sc=sc)


# ------------------------------------------------------------ ServiceConfig
def _configs(mod):
    """The same three configs built through ``mod``'s (either package's)
    ServiceConfig."""
    return [
        mod.ServiceConfig(),
        mod.ServiceConfig(
            mode="streaming",
            model=mod.ModelSection(gnn_type="gat", hidden_dim=32, mlp_dims=(16, 8),
                                   feat_dim=12),
        ).replace(
            engine={"num_workers": 4, "steal_threshold": 10, "max_history": None},
            store={"capacity": 1000, "ttl_seconds": 5.0},
            refresh={"refresh_every": 3, "async_refresh": True},
            admission={"max_queue_depth": 32, "policy": "block", "block_max_wait_s": 0.25},
        ),
        mod.ServiceConfig(mode="batch").replace(
            model={"entity_types": ["buyer", "merchant"], "use_pallas": True},
            workers={"backend": "process", "ring_bytes": 8192},
            gateway={"port": 8080, "checkpoint_dir": "/var/ckpt", "latency_buckets": [0.5, 1]},
            learn={"enabled": True, "head": "hybrid", "min_window": 8, "stride": 8},
        ),
    ]


@pytest.mark.parametrize("case", [0, 1, 2])
def test_config_json_is_the_reference_artifact(case, tmp_path):
    ref, sc = _configs(RSV)[case], _configs(PSV)[case]
    assert sc.to_json() == ref.to_json()
    assert ServiceConfig.from_json(ref.to_json()) == sc
    assert RSV.ServiceConfig.from_json(sc.to_json()) == ref
    path = str(tmp_path / "svc.json")
    sc.save(path)
    loaded = ServiceConfig.load(path)
    assert loaded == sc and isinstance(loaded.model.mlp_dims, tuple)
    lnn = loaded.to_lnn_config()
    assert isinstance(lnn, LNNConfig) and lnn.gnn_type == ref.model.gnn_type
    ecfg, ref_ecfg = loaded.to_engine_config(), ref.to_engine_config()
    assert dataclasses.asdict(ecfg) == dataclasses.asdict(ref_ecfg)


@pytest.mark.parametrize("bad, match", [
    ({"modle": "batch"}, "unknown key"),
    ({"engine": {"max_batchh": 4}}, r"ServiceConfig\.engine"),
    ({"admission": {"policy": "shed", "shed": 1}}, r"ServiceConfig\.admission"),
    ({"mode": "realtime"}, "mode"),
    ({"admission": {"policy": "drop"}}, "policy"),
    ({"engine": {"num_workers": 0}}, "num_workers"),
    ({"admission": {"policy": "block", "block_max_wait_s": -1.0}}, "block_max_wait_s"),
    ({"workers": {"backend": "thread"}}, "backend"),
    ({"learn": {"head": "tree"}}, "learn.head"),
    ({"gateway": {"port": 70000}}, "gateway.port"),
])
def test_config_validation_and_unknown_keys(bad, match):
    with pytest.raises(ValueError, match=match):
        ServiceConfig.from_dict(bad)
    with pytest.raises(ValueError, match=match):
        RSV.ServiceConfig.from_dict(bad)      # the reference refuses it alike


def test_config_replace_rejects_unknown_section_keys():
    with pytest.raises(ValueError, match="unknown key"):
        ServiceConfig().replace(engine={"nope": 1})
    with pytest.raises(TypeError, match="expected a dict"):
        ServiceConfig.from_dict([])


# ---------------------------------------------------------------- lifecycle
def test_lifecycle_is_enforced(world):
    events, params, sc = world["events"], world["params"], world["sc"]
    svc = FraudService(sc, params=params, device="cpu")
    assert svc.state == "created"
    with pytest.raises(ServiceLifecycleError, match="submit"):
        svc.submit(events[0])
    with pytest.raises(ServiceLifecycleError, match="warmup"):
        svc.warmup()
    svc.build()
    assert svc.state == "built"
    with pytest.raises(ServiceLifecycleError, match="build"):
        svc.build()
    svc.warmup()
    assert svc.state == "ready"
    out = svc.submit(events[0])
    assert svc.state == "serving"
    out += svc.drain()
    assert svc.state == "drained" and len(out) == 1
    svc.close()
    assert svc.state == "closed"
    svc.close()          # idempotent
    for op in (svc.drain, svc.warmup, lambda: svc.submit(events[0])):
        with pytest.raises(ServiceLifecycleError):
            op()
    with pytest.raises(ServiceLifecycleError, match="load_model"):
        svc.load_model(params)


def test_build_requires_a_model_and_refuses_the_process_backend(world):
    params, sc = world["params"], world["sc"]
    svc = FraudService(sc, device="cpu")
    with pytest.raises(ServiceLifecycleError, match="load_model"):
        svc.build()
    svc.load_model(params)
    assert svc.build().state == "built"
    # the process backend builds: its workers are shard processes, on the
    # CPU as the service is, and it scores the inline backend's bits
    events = world["events"][:30]
    want = {r.request.tag.order_id: r.score for r in svc.replay(events).results}
    with FraudService(sc.replace(workers={"backend": "process"}), params=params,
                      device="cpu") as proc:
        assert proc.state == "built"             # the context manager built it
        assert type(proc.engine.pool).__name__ == "ProcessWorkerPool"
        assert proc.replay(events).scores_by_order() == want


def test_mode_guards(world, small_communities):
    events, params, sc = world["events"], world["params"], world["sc"]
    streaming = build_service(sc, params, device="cpu")
    with pytest.raises(ServiceLifecycleError, match="mode='batch'"):
        streaming.refresh(small_communities)
    with pytest.raises(ServiceLifecycleError, match="mode='batch'"):
        streaming.score([])
    batch = build_service(sc.replace(mode="batch"), params, device="cpu")
    with pytest.raises(ServiceLifecycleError, match="mode='streaming'"):
        batch.submit(events[0])
    with pytest.raises(ServiceLifecycleError, match="mode='streaming'"):
        batch.enable_wal("unused")


def test_from_artifact_and_context_manager(world, tmp_path):
    events, params, sc = world["events"], world["params"], world["sc"]
    path = str(tmp_path / "service.json")
    sc.save(path)
    with FraudService.from_artifact(path, params=params, device="cpu") as svc:
        svc.submit(events[0])
        svc.drain()
        assert svc.stats().scored == 1
    assert svc.state == "closed"


# ----------------------------------------------- bit for bit: the port's layers
def _port_batches(batches):
    return [dataclasses.replace(b, graph=PaddedGraph(*b.graph)) for b in batches]


def test_batch_mode_bit_identical_to_layers(small_communities):
    """FraudService(mode='batch') scores == SpeedLayer.score over the store a
    BatchLayer refreshed, bit for bit, at any request count per call."""
    batches = _port_batches(small_communities)
    cfg = LNNConfig(num_gnn_layers=2, hidden_dim=16,
                    feat_dim=batches[0].graph.features.shape[1])
    params = lnn_init(torch.Generator().manual_seed(2), cfg, device="cpu")
    store = KVStore(cfg.hidden_dim)
    BatchLayer(params, cfg, store, device="cpu").refresh(batches)
    requests = history_requests(batches)
    ref = SpeedLayer(params, cfg, store, k_max=8, device="cpu").score(requests)

    sc = ServiceConfig(mode="batch", model=ModelSection.from_lnn_config(cfg))
    svc = FraudService(sc, params=params, device="cpu").build().warmup()
    svc.refresh(batches)
    c, c_ref = _store_contents(svc.store), _store_contents(store)
    assert c.keys() == c_ref.keys()
    assert all(np.array_equal(c[k][0], c_ref[k][0]) and c[k][1] == c_ref[k][1] for k in c)
    out = svc.score(requests)
    np.testing.assert_array_equal(np.asarray([r.score for r in out]), ref)
    assert all(r.admitted and r.model_version == 0 for r in out)
    # the reference's failing claim holds here: 4 requests == ref[:4]
    legacy = [{"features": r.features, "entity_keys": r.entity_keys} for r in requests[:4]]
    np.testing.assert_array_equal(np.asarray([r.score for r in svc.score(legacy)]), ref[:4])
    before = svc.stats().requests
    assert svc.score_equivalence_check(batches) < 1e-4
    assert svc.stats().requests == before


@pytest.mark.parametrize("num_workers", [1, 4])
def test_streaming_mode_bit_identical_to_engine(world, num_workers):
    events, cfg, params, sc = world["events"], world["cfg"], world["params"], world["sc"]
    sc = sc.replace(engine={"num_workers": num_workers})
    ref = _engine(params, cfg, sc.to_engine_config())
    ref_rep = ref.replay(events)
    svc = FraudService(sc, params=params, device="cpu").build()
    rep = svc.replay(events)
    assert rep.scores_by_order() == ref_rep.scores_by_order()
    c, c_ref = _store_contents(svc.store), _store_contents(ref.store)
    assert c.keys() == c_ref.keys()
    assert all(np.array_equal(c[k][0], c_ref[k][0]) and c[k][1] == c_ref[k][1] for k in c)
    st = svc.stats()
    assert st.requests == st.scored == len(events) and st.shed == st.blocked == 0
    assert st.flushes == ref_rep.summary()["flushes"]
    if num_workers == 4:
        assert sum(w["requests"] > 0 for w in st.workers) >= 2


# --------------------------------------------- against the reference's facade
def _ref_facade(world, ref_params, ref_cfg, engine_kw=None, admission=None):
    sc = RSV.ServiceConfig(model=RSV.ModelSection.from_lnn_config(ref_cfg)).replace(
        engine={"max_batch": 8, **(engine_kw or {})}, admission=admission or {})
    return RSV.FraudService(sc, params=ref_params).build(), sc


@pytest.mark.parametrize("gnn", GNN_TYPES)
def test_facade_matches_reference_facade(world, gnn):
    ref_cfg = dataclasses.replace(world["ref_cfg"], gnn_type=gnn)
    ref_params = R.lnn_init(jax.random.PRNGKey(1), ref_cfg)
    ref_svc, ref_sc = _ref_facade(world, ref_params, ref_cfg)
    ref_rep = ref_svc.replay(world["ref_events"])
    svc = FraudService(ServiceConfig.from_json(ref_sc.to_json()), params=_to_port(ref_params),
                       device="cpu").build()
    rep = svc.replay(world["events"])
    s, s_ref = rep.scores_by_order(), ref_rep.scores_by_order()
    assert s.keys() == s_ref.keys()
    orders = sorted(s)
    np.testing.assert_allclose([s[o] for o in orders], [s_ref[o] for o in orders],
                               atol=SCORE_TOL, rtol=SCORE_TOL)
    c, c_ref = _store_contents(svc.store), _store_contents(ref_svc.store)
    assert c.keys() == c_ref.keys()
    keys = sorted(c)
    np.testing.assert_allclose(np.stack([c[k][0] for k in keys]),
                               np.stack([c_ref[k][0] for k in keys]),
                               atol=STORE_TOL, rtol=STORE_TOL)
    st, ref_st = svc.stats(), ref_svc.stats()
    for f in ("requests", "scored", "flushes", "refreshes", "entities_written",
              "store_size", "model_stale_reads", "queue_depth_peak"):
        assert getattr(st, f) == getattr(ref_st, f), f
    assert rep.staleness_summary() == ref_rep.staleness_summary()
    assert rep.summary()["flushes"] == ref_rep.summary()["flushes"]


@pytest.mark.parametrize("policy", ["shed", "block"])
def test_streaming_admission_counts_equal_reference(world, policy):
    kw = {"num_workers": 2, "service_model_s": 0.05}
    adm = {"max_queue_depth": 6, "policy": policy}
    ref_svc, ref_sc = _ref_facade(world, world["ref_params"], world["ref_cfg"], kw, adm)
    ref_rep = ref_svc.replay(world["ref_events"])
    svc = FraudService(ServiceConfig.from_json(ref_sc.to_json()), params=world["params"],
                       device="cpu").build()
    rep = svc.replay(world["events"])
    st, ref_st = svc.stats(), ref_svc.stats()
    for f in ("requests", "scored", "shed", "blocked", "block_timeouts", "queue_depth_peak",
              "in_flight_peak", "flushes"):
        assert getattr(st, f) == getattr(ref_st, f), f
    assert (st.shed > 0) == (policy == "shed") and (st.blocked > 0) == (policy == "block")
    assert st.queue_depth_peak <= 6
    assert rep.scores_by_order().keys() == ref_rep.scores_by_order().keys()
    assert st.extra["pool"]["forced_flushes"] == ref_st.extra["pool"]["forced_flushes"]


def test_batch_admission_counts_equal_reference(world, small_communities):
    ref_cfg = dataclasses.replace(world["ref_cfg"],
                                  feat_dim=small_communities[0].graph.features.shape[1])
    ref_params = R.lnn_init(jax.random.PRNGKey(0), ref_cfg)
    from repro.serve import history_requests as ref_history_requests

    ref_requests = ref_history_requests(small_communities)[:30]
    batches = _port_batches(small_communities)
    requests = history_requests(batches)[:30]
    base = RSV.ServiceConfig(mode="batch", model=RSV.ModelSection.from_lnn_config(ref_cfg))
    for adm, shed, blocked in (({"max_queue_depth": 10, "policy": "shed"}, 20, 0),
                               ({"max_queue_depth": 16, "policy": "block"}, 0, 14)):
        ref_sc = base.replace(admission=adm)
        ref_svc = RSV.FraudService(ref_sc, params=ref_params).build()
        ref_svc.refresh(small_communities)
        ref_out = ref_svc.score(ref_requests)
        svc = FraudService(ServiceConfig.from_json(ref_sc.to_json()),
                           params=_to_port(ref_params), device="cpu").build()
        svc.refresh(batches)
        out = svc.score(requests)
        assert [r.admitted for r in out] == [r.admitted for r in ref_out]
        st, ref_st = svc.stats(), ref_svc.stats()
        assert (st.shed, st.blocked) == (ref_st.shed, ref_st.blocked) == (shed, blocked)
        got = np.asarray([r.score for r in out if r.admitted])
        want = np.asarray([r.score for r in ref_out if r.admitted])
        np.testing.assert_allclose(got, want, atol=SCORE_TOL, rtol=SCORE_TOL)
        assert all(math.isnan(r.score) for r in out if not r.admitted)


def test_block_admission_bounded_wait(world):
    """A zero budget times the stall out and sheds; a generous one admits
    everything (the reference's regression test, on the port)."""
    events, params, sc = world["events"], world["params"], world["sc"]
    svc = build_service(sc.replace(engine={"max_batch": 64, "max_wait_s": 1e9},
                                   admission={"max_queue_depth": 1, "policy": "block",
                                              "block_max_wait_s": 0.0}), params, device="cpu")
    out = [r for ev in events[:3] for r in svc.submit(ev)]
    shed = [r for r in out if not r.admitted]
    assert len(shed) == 2 and all(math.isnan(r.score) for r in shed)
    assert all(isinstance(r.request, ScoreRequest) for r in shed)
    st = svc.stats()
    assert (st.block_timeouts, st.shed, st.blocked) == (2, 2, 2) and st.queue_depth_peak <= 1
    pool = build_service(sc.replace(engine={"max_batch": 64, "max_wait_s": 1e9}), params,
                         device="cpu")
    for ev in events[:4]:
        pool.submit(ev)
    pool = pool.engine.pool
    ticks = iter([0.0, 100.0])
    drained, admitted = pool.drain_to_depth(1, events[3].arrival, budget_s=5.0,
                                            clock=lambda: next(ticks))
    assert not admitted and drained == [] and len(pool) == 4
    drained, admitted = pool.drain_to_depth(1, events[3].arrival, budget_s=None)
    assert admitted and len(drained) == 4 and len(pool) == 0
    assert pool.busy_workers(events[3].arrival) == 0


# ----------------------------------------------------------------- hot swap
def test_hot_swap_to_a_clone_is_bit_identical(world):
    events, cfg, params, sc = world["events"], world["cfg"], world["params"], world["sc"]
    s_ref = _engine(params, cfg, sc.to_engine_config()).replay(events).scores_by_order()
    svc = FraudService(sc, params=params, device="cpu").build()
    clone = svc.register_perturbed(0, 0.0)
    svc.warmup()
    out, half = [], len(events) // 2
    for ev in events[:half]:
        out.extend(svc.submit(ev))
    assert svc.activate_model(clone) == 1
    for ev in events[half:]:
        out.extend(svc.submit(ev))
    out.extend(svc.drain())
    scores = {r.request.tag.order_id: r.score for r in out}
    assert scores == s_ref
    versions = [r.model_version for r in out]
    assert set(versions) == {0, 1} and versions == sorted(versions)
    st = svc.stats()
    assert st.model_versions == (0, 1) and st.model_swaps == 1 and st.model_stale_reads > 0
    assert st.last_good_version == 0
    assert svc.rollback_model("test") == 0 and svc.stats().rollbacks == 1
    with pytest.raises(ServiceLifecycleError, match="last-good"):
        svc.rollback_model()


def test_hot_swap_new_flushes_score_on_new_params(world):
    events, cfg, params, sc = world["events"], world["cfg"], world["params"], world["sc"]
    params2 = lnn_init(torch.Generator().manual_seed(99), cfg, device="cpu")
    s_old = _engine(params, cfg, sc.to_engine_config()).replay(events).scores_by_order()
    svc = FraudService(sc, params=params, device="cpu").build()
    out = []
    for ev in events[:40]:
        out.extend(svc.submit(ev))
    svc.load_model(params2, version=7)
    for ev in events[40:]:
        out.extend(svc.submit(ev))
    out.extend(svc.drain())
    new = [r for r in out if r.model_version == 7]
    assert new and max(abs(r.score - s_old[r.request.tag.order_id]) for r in new) > 0
    assert svc.load_model(params, version=0) == 0
    assert svc.model_versions() == (0, 7)
    entries = {e.model_version for shard in svc.store._shards for e in shard.values()}
    assert entries == {0, 7}


@pytest.mark.parametrize("scale, seed", [(0.0, 0), (0.05, 3)])
def test_register_perturbed_equals_reference(world, scale, seed):
    ref_sc = RSV.ServiceConfig(model=RSV.ModelSection.from_lnn_config(world["ref_cfg"]))
    ref_svc = RSV.FraudService(ref_sc, params=world["ref_params"])
    v_ref = ref_svc.register_perturbed(0, scale, seed=seed)
    svc = FraudService(ServiceConfig.from_json(ref_sc.to_json()), params=world["params"],
                       device="cpu")
    v = svc.register_perturbed(0, scale, seed=seed)
    assert v == v_ref == 1
    want = dict(jax.tree_util.tree_flatten_with_path(ref_svc.model_params(1))[0])
    got = svc.model_params(1)
    for path, leaf in want.items():
        node = got
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert (svc.model_params(1) is not svc.model_params(0))


# ------------------------------------------------------------- shadow scoring
def test_shadow_divergence_zero_for_clone_alert_for_canary(world):
    events, params, sc = world["events"], world["params"], world["sc"]
    svc = FraudService(sc, params=params, device="cpu").build()
    clone = svc.register_perturbed(0, 0.0)
    canary = svc.register_perturbed(0, 5.0, seed=1)
    svc.enable_shadow(clone, fraction=0.5, threshold=0.0)
    delivered = []
    for ev in events:
        out = svc.submit(ev)
        svc.shadow_observe(out)
        delivered.extend(out)
    sh = svc.shadow_stats()
    assert sh["sampled"] == len(delivered) // 2 > 0
    assert sh["divergence_max"] == 0.0 and not sh["alert_active"]
    assert svc.stats().model_stale_reads == 0       # shadow reads are not counted
    svc.enable_shadow(canary, fraction=1.0, threshold=0.01, collect_eval=4)
    assert svc.shadow_observe(delivered) == len(delivered)
    sh = svc.shadow_stats()
    assert sh["alert_active"] and sh["alerts"] > 0 and sh["divergence_max"] > 0.01
    assert len(sh["eval"]) == 4 and svc.stats().shadow["role"] == "canary"
    svc.disable_shadow()
    assert svc.shadow_observe(delivered) == 0 and svc.shadow_stats() == {}
    with pytest.raises(KeyError, match="not registered"):
        svc.enable_shadow(42)


# ------------------------------------------------------------------- stats
def test_service_stats_json_roundtrip():
    sample = ServiceStats(
        mode="streaming", state="serving", model_version=3,
        model_versions=(0, 3, 9), model_swaps=2, requests=100, scored=90,
        shed=7, blocked=5, block_timeouts=3, queue_depth=4,
        queue_depth_peak=12, in_flight_peak=2, flushes=31, refreshes=6,
        entities_written=250, model_stale_reads=11, store_size=420,
        rollbacks=1, last_good_version=0,
        scores_by_version={0: 40, 3: 50},
        shadow={"version": 9, "fraction": 0.5, "alerts": 1, "alert_active": True},
        store_stats={"hits": 10, "model_stale_reads": 11},
        workers=[{"worker": 0, "queue_depth": 2, "alive": True}],
        extra={"pool": {"steals": 1}},
    )
    defaults = ServiceStats()
    for f in dataclasses.fields(ServiceStats):
        assert getattr(sample, f.name) != getattr(defaults, f.name), f.name
    wire = json.loads(json.dumps(sample.to_dict()))
    back = ServiceStats.from_dict(wire)
    assert back == sample and isinstance(back.model_versions, tuple)
    assert back.scores_by_version == {0: 40, 3: 50}
    # the reference reads the same wire form into the same fields
    assert RSV.ServiceStats.from_dict(wire).to_dict() == sample.to_dict()
    with pytest.raises(ValueError, match="unknown key"):
        ServiceStats.from_dict({**wire, "scoredd": 1})


def test_live_stats_are_json_safe(world):
    svc = FraudService(world["sc"], params=world["params"], device="cpu").build()
    svc.replay(world["events"][:40])
    d = json.loads(json.dumps(svc.stats().to_dict()))
    assert d["mode"] == "streaming" and d["requests"] == 40
    assert ServiceStats.from_dict(d) == svc.stats()
