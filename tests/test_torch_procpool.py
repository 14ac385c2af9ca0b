"""The port's process backend (``repro_torch.stream.procpool``) on the CPU,
case for case as the reference's ``tests/test_procpool.py``:

* **wire**: the pickle-free frame codec — round trips, and frames byte-equal
  to the reference's ``pack_frame`` for the same header and sections — and
  the shared-memory ring allocator;
* **child**: the full :class:`ShardServer` command surface driven in-parent,
  each reply held against the reference's ``ShardServer`` on the same
  inputs and the same model file (scores 1e-5: f32 on both sides, summed in
  another order; reads, stats and snapshots exact), and a REFRESH bin equal
  bit for bit to the inline refresh's own stage-1 call;
* **pool**: entity-affine shards required, an injected store rejected,
  heartbeat restart after a SIGKILL, reshard, post-shutdown stats, a hot
  swap with process == inline bit for bit in scores and KV bytes, the
  autoscaler end to end on both backends, and a spawned child that loads
  neither ``jax`` nor ``repro``.

The bit-parity gates on the other axes live beside their inline twins:
``tests/test_torch_stream.py`` (N=1 and N=4, and the reference's inline
engine as the anchor) and ``tests/test_torch_checkpoint.py`` (checkpoint
/ restore, ``worker_kill``).  Children compute with the parent's intra-op
thread count, pinned to one here.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core as R
import repro.stream.procpool as RP
from repro.serve.kvstore import pack_key
from repro.train.checkpoint import save_checkpoint as ref_save_checkpoint
from repro_torch.core import LNNConfig, PaddedGraph, lnn_init
from repro_torch.core.layers import row_stable_matmul
from repro_torch.core.lnn import lnn_stage1
from repro_torch.data import SynthConfig, generate_event_stream
from repro_torch.serve import KVStore
from repro_torch.service import FraudService, ModelSection, ServiceConfig
from repro_torch.stream import EngineConfig, StreamingEngine
from repro_torch.stream.procpool import (ProcessWorkerPool, ShardServer, ShmRing, pack_frame,
                                         unpack_frame)

SCORE_TOL = 1e-5
STORE_TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, in the parent and so in every child: many small
    products, and under several test workers torch's default of a thread
    per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(ref_cfg):
    return LNNConfig(**{f.name: getattr(ref_cfg, f.name)
                        for f in dataclasses.fields(LNNConfig)})


# ---------------------------------------------------------------- wire codec
def test_frame_roundtrip_multi_section():
    header = {"cmd": "score", "version": 3, "keys": [[1, 2], [3, 4]]}
    secs = [
        ("feats", np.arange(12, dtype="<f4").reshape(3, 4)),
        ("mask", np.asarray([1, 0, 1], np.int8)),
        ("empty", np.zeros((0, 4), np.float32)),
    ]
    buf = pack_frame(header, secs)
    assert buf == RP.pack_frame(header, secs)
    h, out = unpack_frame(buf)
    assert h["cmd"] == "score" and h["version"] == 3
    assert h["keys"] == [[1, 2], [3, 4]]
    assert "sections" not in h          # descriptor list is consumed
    for name, arr in secs:
        assert out[name].dtype == arr.dtype
        assert out[name].shape == arr.shape
        assert out[name].tobytes() == arr.tobytes()
    # views are zero-copy and read-only — copy before mutating
    with pytest.raises(ValueError):
        out["feats"][0, 0] = 9.0
    # and the reference reads the port's frame as its own
    h_ref, out_ref = RP.unpack_frame(buf)
    assert h_ref == h and all(out_ref[n].tobytes() == a.tobytes() for n, a in secs)


def test_frame_roundtrip_no_sections():
    buf = pack_frame({"cmd": "ping", "id": 7})
    assert buf == RP.pack_frame({"cmd": "ping", "id": 7})
    h, out = unpack_frame(buf)
    assert h == {"cmd": "ping", "id": 7} and out == {}


def test_shm_ring_alloc_free_wrap():
    ring = ShmRing(nbytes=64)
    try:
        a = ring.alloc(1, 24)
        b = ring.alloc(2, 24)
        assert (a, b) == (0, 24)
        assert ring.alloc(3, 24) is None          # full: 48 + 24 > 64
        ring.free(1)                              # tail advances to msg 2
        c = ring.alloc(3, 24)                     # wraps to offset 0
        assert c == 0
        arr = np.arange(6, dtype="<f4")
        ring.write(c, arr)
        assert bytes(ring.shm.buf[0:24]) == arr.tobytes()
        assert ring.alloc(4, 128) is None         # larger than capacity
    finally:
        ring.destroy()


# ------------------------------------------------- child server (in-parent)
@pytest.fixture(scope="module")
def server_world(tmp_path_factory):
    """One reference model file, read by the reference's server and the port's."""
    ref_cfg = R.LNNConfig(num_gnn_layers=2, hidden_dim=8, feat_dim=4, mlp_dims=(8,))
    params = R.lnn_init(jax.random.PRNGKey(0), ref_cfg)
    models = tmp_path_factory.mktemp("models")
    path = str(models / "v0.npz")
    ref_save_checkpoint(path, params)
    path2 = str(models / "v1.npz")
    ref_save_checkpoint(path2, R.lnn_init(jax.random.PRNGKey(1), ref_cfg))
    return ref_cfg, _port_cfg(ref_cfg), path, path2


def _servers(world, num_shards=1):
    """(reference server, port server) over the same model file."""
    ref_cfg, cfg, path, _ = world
    store_cfg = dict(dim=cfg.hidden_dim, num_shards=num_shards,
                     shard_by_entity=num_shards > 1)
    ref = RP.ShardServer(wid=0, cfg=ref_cfg, store_cfg=store_cfg, k_max=4, max_batch=4,
                         model_path=path, model_version=0)
    port = ShardServer(wid=0, cfg=cfg, store_cfg=store_cfg, k_max=4, max_batch=4,
                       model_path=path, model_version=0, device="cpu")
    return ref, port


def _ask(srv, header, sections=None):
    """Drive one command; replies carry sections as (name, arr) pairs."""
    h, secs = srv.handle(header, sections or {})
    return h, dict(secs)


def _ask_both(servers, header, sections=None):
    """The same command to both servers: (port reply, reference reply), the
    headers equal but for the port's per-process launch counts."""
    ref, port = servers
    (h_ref, s_ref), (h, s) = _ask(ref, header, sections), _ask(port, header, sections)
    assert {k: v for k, v in h.items() if k != "launches"} == h_ref
    assert s.keys() == s_ref.keys()
    return (h, s), (h_ref, s_ref)


def _same(s, s_ref, *names):
    for name in names:
        assert s[name].dtype == s_ref[name].dtype and s[name].shape == s_ref[name].shape
        assert s[name].tobytes() == s_ref[name].tobytes(), name


def test_shard_server_put_read_score_stats(server_world):
    servers = _servers(server_world)
    cfg = server_world[1]
    keys = np.asarray([pack_key(1, 0), pack_key(2, 0)], np.int64)
    vals = np.arange(16, dtype=np.float32).reshape(2, 8)
    (h, _), _ = _ask_both(servers, {"cmd": "put", "id": 1, "pver": 0, "model_version": 0,
                                    "stamp": 12.5}, {"keys": keys, "values": vals})
    assert h["ok"] == 1 and h["n"] == 2

    (h, s), (_, s_ref) = _ask_both(servers, {"cmd": "read", "id": 2, "version": 0,
                                             "pairs": [[1, 0], [9, 0]]})
    _same(s, s_ref, "emb", "has", "stale")
    assert list(s["has"]) == [1, 0]
    assert s["emb"][0].tobytes() == vals[0].tobytes()

    feats = np.random.default_rng(0).normal(size=(2, cfg.feat_dim)).astype(np.float32)
    (h, s), (_, s_ref) = _ask_both(servers, {"cmd": "score", "id": 3, "version": 0,
                                             "keys": [[[1, 0]], [[2, 0]]], "remote": []},
                                   {"feats": feats})
    assert h["version"] == 0
    assert s["probs"].shape == (2,) and np.all((s["probs"] >= 0) & (s["probs"] <= 1))
    np.testing.assert_allclose(s["probs"], s_ref["probs"], atol=SCORE_TOL, rtol=SCORE_TOL)
    _same(s, s_ref, "stale")

    (h, _), _ = _ask_both(servers, {"cmd": "stats", "id": 4})
    assert h["len"] == 2 and h["stats"]["puts"] == 2
    assert set(h["launches"]) >= {"stage2_score", "csr_spmm", "edge_softmax"}

    (h, _), _ = _ask_both(servers, {"cmd": "ping", "id": 5})
    assert h["ok"] == 1 and h["wid"] == 0


def test_shard_server_score_merges_remote_slots(server_world):
    """Non-owned slots arrive pre-resolved; the server must splice them in
    at their (row, slot) positions instead of reading its own store."""
    servers = _servers(server_world)
    cfg = server_world[1]
    remote_emb = np.ones((2, cfg.hidden_dim), np.float32)
    feats = np.zeros((1, cfg.feat_dim), np.float32)
    (h, s), (_, s_ref) = _ask_both(
        servers,
        {"cmd": "score", "id": 1, "version": 0,
         "keys": [[[5, 0], [6, 0]]],
         # slot (0,0): remote hit with staleness 2; slot (0,1): remote miss
         "remote": [[0, 0, 1, 2], [0, 1, 0, -1]]},
        {"feats": feats, "remote_emb": remote_emb})
    assert h["ok"] == 1
    assert int(s["stale"][0]) == 2          # the remote hit's staleness won
    np.testing.assert_allclose(s["probs"], s_ref["probs"], atol=SCORE_TOL, rtol=SCORE_TOL)


def test_shard_server_snapshot_load_set_model(server_world):
    ref_cfg, cfg, path, path2 = server_world
    servers = _servers(server_world)
    keys = np.asarray([pack_key(3, 1)], np.int64)
    vals = np.full((1, 8), 2.0, np.float32)
    _ask_both(servers, {"cmd": "put", "id": 1, "pver": 1, "model_version": 0,
                        "stamp": 1.0}, {"keys": keys, "values": vals})
    (h, s), (_, s_ref) = _ask_both(servers, {"cmd": "snapshot", "id": 2})
    assert h["shard_off"] == [0, 1] and h["len"] == 1
    _same(s, s_ref, "keys", "values", "versions", "stamps", "model_versions")
    assert s["keys"].tolist() == keys.tolist()
    assert s["versions"].tolist() == [1]

    # LOAD composes additively into a fresh server, shard by shard
    fresh = _servers(server_world)
    (h2, _), _ = _ask_both(
        fresh,
        {"cmd": "load", "id": 3, "shard": 0},
        {"keys": s["keys"], "values": s["values"], "versions": s["versions"],
         "stamps": s["stamps"], "model_versions": s["model_versions"]})
    assert h2["ok"] == 1 and h2["n"] == 1
    (_, r), (_, r_ref) = _ask_both(fresh, {"cmd": "read", "id": 4, "version": 0,
                                           "pairs": [[3, 1]]})
    assert list(r["has"]) == [1]
    _same(r, r_ref, "emb", "has", "stale")

    # SET_MODEL registers a new version and scoring under it activates it
    (h, _), _ = _ask_both(servers, {"cmd": "set_model", "id": 5, "version": 1,
                                    "path": path2})
    assert h["ok"] == 1
    feats = np.full((1, cfg.feat_dim), 0.5, np.float32)
    (h, s), (_, s_ref) = _ask_both(servers, {"cmd": "score", "id": 6, "version": 1,
                                             "keys": [[[3, 1]]], "remote": []},
                                   {"feats": feats})
    assert h["version"] == 1
    np.testing.assert_allclose(s["probs"], s_ref["probs"], atol=SCORE_TOL, rtol=SCORE_TOL)

    # a warmup runs every bucket under the active version and the others named
    (h, _), _ = _ask_both(servers, {"cmd": "warmup", "id": 7, "versions": [0, 1]})
    assert h["ok"] == 1


def test_shard_server_errors_reply_not_raise(server_world):
    servers = _servers(server_world)
    cfg = server_world[1]
    for srv in servers:
        h, secs = srv.handle({"cmd": "no_such", "id": 9}, {})
        assert "error" in h and "no_such" in h["error"] and secs == []
        h, _ = _ask(srv, {"cmd": "score", "id": 10, "version": 42,
                          "keys": [[]], "remote": []},
                    {"feats": np.zeros((1, cfg.feat_dim), np.float32)})
        assert "error" in h            # unknown model version -> error frame


@pytest.mark.parametrize("gnn_type", ["gcn", "gat", "sage"])
def test_shard_server_refresh_is_the_inline_stage1_call(small_communities, tmp_path, gnn_type):
    """A REFRESH bin gives the rows of the inline refresh's own stage-1 call
    (``RefreshDriver._run_stage1``) bit for bit, and the reference server's
    within 2e-5."""
    graph = small_communities[0].graph
    ref_cfg = R.LNNConfig(gnn_type=gnn_type, num_gnn_layers=3, hidden_dim=16,
                          feat_dim=graph.features.shape[1], mlp_dims=(8,))
    path = str(tmp_path / "v0.npz")
    ref_save_checkpoint(path, R.lnn_init(jax.random.PRNGKey(2), ref_cfg))
    ref_world = (ref_cfg, _port_cfg(ref_cfg), path, path)
    servers = _servers(ref_world)
    secs = {name: np.asarray(v) for name, v in graph._asdict().items() if v is not None}
    header = {"cmd": "refresh", "id": 1, "version": 0, "fields": list(secs)}
    (_, s), (_, s_ref) = _ask_both(servers, header, secs)
    params = servers[1]._params_by_version[0]
    with torch.no_grad():
        inline = lnn_stage1(params, ref_world[1], PaddedGraph(*graph).to("cpu"),
                            mm=row_stable_matmul).numpy()
    assert s["h"].tobytes() == inline.tobytes()
    np.testing.assert_allclose(s["h"], s_ref["h"], atol=STORE_TOL, rtol=STORE_TOL)


# --------------------------------------------------------- pool lifecycle
@pytest.fixture(scope="module")
def proc_world():
    events, g, _ = generate_event_stream(
        SynthConfig(num_users=40, num_rings=2, feature_noise=0.8, seed=5),
        rate_per_s=500.0)
    cfg = LNNConfig(num_gnn_layers=2, hidden_dim=16,
                    feat_dim=g.order_features.shape[1], mlp_dims=(8,))
    params = lnn_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    return events[:150], cfg, params


def _store_bytes(store):
    return {k: (np.asarray(v).tobytes(), ver, mv)
            for shard in store.shard_items()
            for k, v, ver, _st, mv in shard}


def _engine(params, cfg, **ecfg):
    return StreamingEngine(params, cfg, EngineConfig(**ecfg), device="cpu")


def test_processpool_requires_entity_affine_shards(proc_world):
    _events, cfg, params = proc_world
    with pytest.raises(ValueError, match="shard"):
        ProcessWorkerPool(
            params, cfg,
            dict(dim=cfg.hidden_dim, num_shards=1, shard_by_entity=False),
            num_workers=2, device="cpu")


def test_engine_rejects_injected_store_for_process_backend(proc_world):
    _events, cfg, params = proc_world
    with pytest.raises(ValueError, match="injected store|owns its KV"):
        StreamingEngine(params, cfg, EngineConfig(backend="process"),
                        store=KVStore(cfg.hidden_dim), device="cpu")


def test_worker_death_heartbeat_restart_preserves_shard(proc_world):
    """SIGKILL a shard process between submissions: the next poll's
    liveness sweep must respawn it and restore its shard (snapshot journal
    + puts since) — KV bytes identical before and after, restart counted,
    and the stream finishes with every score delivered in order."""
    events, cfg, params = proc_world
    eng = _engine(params, cfg, max_batch=8, num_workers=2, backend="process")
    try:
        eng.warmup()
        out = []
        for ev in events[:80]:
            out.extend(eng.submit(ev))
        pool = eng.pool
        before = _store_bytes(eng.store)
        assert len(before) > 0, "no KV writes before the kill — test is void"
        pool.kill_worker(0)
        assert pool.dead_workers() == 1
        out.extend(pool.poll(events[80].arrival))     # heartbeat sweep
        assert pool.dead_workers() == 0
        assert pool.ping() == [0, 1]
        assert _store_bytes(eng.store) == before, \
            "shard restore lost or corrupted KV state"
        for ev in events[80:]:
            out.extend(eng.submit(ev))
        out.extend(eng.flush())
        rows = pool.worker_summary()
        assert sum(r["restarts"] for r in rows) == 1
        assert all(r["alive"] for r in rows)
        seqs = [r.request.seq for r in out]
        assert seqs == sorted(seqs) == list(range(len(events)))
    finally:
        eng.close()


def test_process_reshard_preserves_store_and_scores(proc_world):
    """``reshard`` re-spawns the topology at a new width and re-places
    every entry under the new rendezvous layout — no entry lost, and every
    order of the stream still scores."""
    events, cfg, params = proc_world
    s_ref = _engine(params, cfg, max_batch=8).replay(events).scores_by_order()
    eng = _engine(params, cfg, max_batch=8, num_workers=2, backend="process")
    try:
        eng.warmup()
        out = []
        for ev in events[:70]:
            out.extend(eng.submit(ev))
        keys_before = set(_store_bytes(eng.store))
        out.extend(eng.pool.reshard(3))
        assert eng.pool.num_workers == 3
        assert len(eng.pool._children) == 3
        assert set(_store_bytes(eng.store)) == keys_before
        for ev in events[70:]:
            out.extend(eng.submit(ev))
        out.extend(eng.flush())
    finally:
        eng.close()
    s = {r.request.tag.order_id: r.score for r in out}
    # flush composition changes at the reshard boundary (forced drain), but
    # a row's score does not depend on its flush: every order scores as in
    # the one-worker inline replay
    assert s == s_ref


def test_post_shutdown_summary_still_renders(proc_world):
    events, cfg, params = proc_world
    eng = _engine(params, cfg, max_batch=8, num_workers=2, backend="process")
    rep = eng.replay(events[:40])
    n = len(eng.store)
    stats = dict(eng.store.stats)
    eng.close()
    eng.close()                                     # idempotent
    assert len(eng.store) == n                      # cached, not a dead call
    assert dict(eng.store.stats) == stats
    summary = rep.summary()
    assert all(not w["alive"] for w in summary["workers"])
    with pytest.raises(RuntimeError, match="shut down"):
        eng.pool.read_pairs(0, [[1, 0]], None)


# ------------------------------------------------ engine hot-swap KV parity
def test_process_hot_swap_parity_scores_and_kv_bytes(proc_world):
    """A mid-stream hot-swap replay under backend='process' (N=4) produces
    bit-identical scores AND KV value bytes / versions / model versions to
    the inline backend, with equal store counters.  (Stamps are wall-clock
    and excluded by construction.)"""
    events, cfg, params = proc_world
    params2 = lnn_init(torch.Generator().manual_seed(1), cfg, device="cpu")
    half = len(events) // 2

    def run(backend):
        eng = _engine(params, cfg, max_batch=8, num_workers=4, backend=backend)
        try:
            eng.warmup()
            out = []
            for i, ev in enumerate(events):
                if i == half:
                    eng.load_model(params2, 1)
                out.extend(eng.submit(ev))
            out.extend(eng.flush())
            traits = [(r.request.tag.order_id, r.score, r.staleness,
                       r.model_version, r.worker, r.batch_size) for r in out]
            return traits, _store_bytes(eng.store), dict(eng.store.stats)
        finally:
            eng.close()

    ti, kv_i, st_i = run("inline")
    tp, kv_p, st_p = run("process")
    assert ti == tp, "process scores diverged from inline"
    assert kv_i == kv_p, "process KV bytes diverged from inline"
    assert st_i == st_p, "store counters diverged from inline"
    assert {t[3] for t in tp} == {0, 1}


# ------------------------------------------------------------ config wiring
def test_workers_section_validation_and_roundtrip():
    sc = ServiceConfig(mode="streaming")
    assert sc.workers.backend == "inline"
    d = sc.to_dict()
    assert d["workers"]["backend"] == "inline"
    back = ServiceConfig.from_dict(d)
    assert back.workers.backend == "inline"

    proc = sc.replace(workers={"backend": "process", "ring_bytes": 8192})
    assert proc.workers.backend == "process"
    assert proc.to_engine_config().backend == "process"
    assert sc.to_engine_config().backend == "inline"

    with pytest.raises(ValueError):
        sc.replace(workers={"backend": "threads"})
    with pytest.raises(ValueError):
        sc.replace(workers={"ring_bytes": 16})
    with pytest.raises(ValueError, match="unknown"):
        sc.replace(workers={"backed": "process"})


def test_admission_autoscale_knob_validation():
    sc = ServiceConfig(mode="streaming")
    ok = sc.replace(admission={"autoscale": True, "autoscale_min_workers": 2,
                               "autoscale_max_workers": 4})
    assert ok.admission.autoscale and ok.admission.autoscale_max_workers == 4
    with pytest.raises(ValueError):
        sc.replace(admission={"autoscale_min_workers": 3,
                              "autoscale_max_workers": 2})
    with pytest.raises(ValueError):
        sc.replace(admission={"autoscale_low_depth": 9.0,
                              "autoscale_high_depth": 8.0})
    with pytest.raises(ValueError):
        sc.replace(admission={"autoscale_sustain": 0})
    with pytest.raises(ValueError):
        sc.replace(admission={"autoscale_cooldown": -1})


@pytest.mark.parametrize("backend", ["inline", "process"])
def test_service_autoscale_end_to_end(proc_world, backend):
    """The admission knob wired through: sustained queue depth grows the
    pool via ``reshard`` mid-stream, every admitted request still scores
    exactly once, and the scaling is visible in stats."""
    events, cfg, params = proc_world
    sc = ServiceConfig(
        mode="streaming", model=ModelSection.from_lnn_config(cfg),
    ).replace(
        engine={"num_workers": 1, "max_batch": 32, "max_wait_s": 1.0},
        store={"shard_by_entity": True},      # reshardable even from N=1
        workers={"backend": backend},
        admission={"autoscale": True, "adaptive_steal": True,
                   "autoscale_min_workers": 1, "autoscale_max_workers": 2,
                   "autoscale_high_depth": 3.0, "autoscale_low_depth": 0.5,
                   "autoscale_sustain": 2, "autoscale_cooldown": 0})
    svc = FraudService(sc, params=params, device="cpu").build()
    try:
        evs = events[:60]
        out = []
        for ev in evs:
            out.extend(svc.submit(ev))
        out.extend(svc.drain())
        st = svc.stats()
        assert st.extra["autoscaler"]["scale_ups"] >= 1
        assert svc.engine.pool.num_workers == 2
        assert svc.engine.pool.steal_threshold >= 32   # adaptive, floored
        admitted = [r for r in out if r.admitted]
        oids = sorted(r.request.tag.order_id for r in admitted)
        assert oids == sorted(ev.order_id for ev in evs)
        assert len(st.workers) == 2                    # tear-free snapshot
    finally:
        svc.close()


# -------------------------------------------------------- what a child loads
def test_spawned_child_loads_neither_jax_nor_repro(proc_world, capfd):
    """A shard process imports only the port: its interpreter's import log
    (``PYTHONPROFILEIMPORTTIME``, on the stderr the child inherits) names
    ``repro_torch.stream.procpool`` and no module of ``jax``, ``jaxlib`` or
    ``repro`` — though this test's own process has them all loaded."""
    _events, cfg, params = proc_world
    pool = ProcessWorkerPool(params, cfg, dict(dim=cfg.hidden_dim), device="cpu",
                             child_env={"PYTHONPROFILEIMPORTTIME": "1"})
    try:
        assert pool.ping() == [0]
        assert pool.warmup() and pool.child_launches()["stage2_score"] == 0
    finally:
        pool.shutdown()
    assert pool.dead_workers() == 1
    mods = {line.rsplit("|", 1)[-1].strip()
            for line in capfd.readouterr().err.splitlines() if line.startswith("import time:")}
    assert {"torch", "repro_torch.stream.procpool"} <= mods
    assert not {m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro")}


def test_refresh_bins_of_one_child_do_not_deadlock(proc_world):
    """Three full-size bins for one child: each is posted once the child's
    rows for the last one are read, so neither side blocks sending into a
    full pipe (posting all three first deadlocks: a bin's frame and its
    rows are each larger than the pipe's buffer).  The rows are the inline
    refresh's stage-1 call's, bit for bit."""
    import threading

    from repro_torch.core.graph import pad_graph
    from repro_torch.stream import StreamIngester

    events, cfg, params = proc_world
    ing = StreamIngester(cfg.feat_dim)
    for ev in events:
        ing.ingest(ev)
    pg = pad_graph(ing.materialize().coo, num_nodes=4096, max_deg=32)
    pool = ProcessWorkerPool(params, cfg, dict(dim=cfg.hidden_dim), device="cpu")
    got: list = []
    try:
        run = threading.Thread(target=lambda: got.extend(pool.refresh_bins([pg] * 3, [0] * 3, 0)),
                               daemon=True)
        run.start()
        run.join(timeout=120)
        if run.is_alive():             # unblock the thread before failing
            pool.kill_worker(0)
            run.join(timeout=30)
        assert len(got) == 3, "refresh_bins did not finish: the pipe deadlocked"
    finally:
        pool.shutdown()
    with torch.no_grad():
        inline = lnn_stage1(params, cfg, pg.to("cpu"), mm=row_stable_matmul).numpy()
    assert all(h.tobytes() == inline.tobytes() for h in got)
