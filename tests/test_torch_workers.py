"""The port's multi-worker speed layer, as the reference's
``tests/test_workers.py`` checks it: router key-affinity and rendezvous
minimal movement (over seeded random entities), explicit-reshard-only
semantics, the reorder collector, virtual service occupancy, work stealing,
the depth autoscaler; and the port's ``Stage2Scorer``: one weight pack per
model version, a flush that keeps the model it started with, per-slot
entity types, and hybrid models refused."""
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import LNNConfig, lnn_init, tag_entity
from repro_torch.serve.kvstore import KVStore, entity_shard, pack_key
from repro_torch.stream import (DepthAutoscaler, EngineConfig, MicroBatcher, ScoreRequest,
                                ShardRouter, SpeedLayerWorker, Stage2Scorer, StreamingEngine,
                                WorkerPool)
from repro_torch.stream.microbatch import ScoredResult
from repro_torch.stream.workers import _ReorderBuffer


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the replays run many small products, and under
    several test workers on one host torch's default of a thread per core
    oversubscribes it (a replay then runs tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------- router
def test_router_matches_entity_affine_store():
    n = 4
    router = ShardRouter(n)
    store = KVStore(dim=2, num_shards=n, shard_by_entity=True)
    for ent in range(200):
        w = router.worker_of(ent)
        for t in (0, 3, 17):
            assert store.shard_of(pack_key(ent, t)) == w
        assert entity_shard(ent, n) == w


def test_router_routes_by_primary_entity_and_pins_cold_requests():
    router = ShardRouter(3)
    assert router.route([(42, 5), (99, 2)]) == router.worker_of(42)
    assert router.route([]) == 0


def test_router_worker_count_changes_only_via_reshard():
    router = ShardRouter(2)
    with pytest.raises(AttributeError):
        router.num_workers = 5
    before = {e: router.worker_of(e) for e in range(100)}
    assert router.reshard(3) == 1 and router.num_workers == 3
    moved = [e for e in before if router.worker_of(e) != before[e]]
    assert moved and all(router.worker_of(e) == 2 for e in moved)
    with pytest.raises(ValueError):
        router.reshard(0)
    with pytest.raises(ValueError):
        ShardRouter(0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_router_affinity_properties(seed):
    """Over seeded random entities and worker counts: two routers with the
    same count agree; without ``reshard`` the map is frozen; after
    ``reshard(n + grow)`` it is a fresh router's, and every entity that
    moved landed on an added worker."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        ents = [int(e) for e in rng.integers(0, 2**40, int(rng.integers(1, 50)))]
        n, grow = int(rng.integers(1, 9)), int(rng.integers(1, 5))
        a, b = ShardRouter(n), ShardRouter(n)
        before = [a.worker_of(e) for e in ents]
        assert before == [b.worker_of(e) for e in ents] == [entity_shard(e, n) for e in ents]
        assert all(0 <= w < n for w in before)
        assert [a.worker_of(e) for e in ents] == before
        a.reshard(n + grow)
        after = [a.worker_of(e) for e in ents]
        assert after == [ShardRouter(n + grow).worker_of(e) for e in ents]
        assert all(x == y or x >= n for y, x in zip(before, after))


# ---------------------------------------------------------- reorder buffer
def _result(seq, score=0.5):
    req = ScoreRequest(features=np.zeros(2, np.float32), entity_keys=[], arrival=0.0, seq=seq)
    return ScoredResult(request=req, score=score, staleness=-1, queued_s=0.0, service_s=0.0,
                        batch_size=1)


def test_reorder_buffer_releases_in_submission_order():
    rb = _ReorderBuffer()
    rb.add([_result(2), _result(1)])
    assert rb.release() == []
    rb.add([_result(0)])
    assert [r.request.seq for r in rb.release()] == [0, 1, 2]
    rb.add([_result(3)])
    assert [r.request.seq for r in rb.release()] == [3]
    assert len(rb) == 0 and rb.max_held == 3


# ------------------------------------------------------------ worker/steal
def _const_score_fn(feats, key_lists):
    return np.full(feats.shape[0], 0.5), np.zeros(feats.shape[0], np.int32)


def _req(arrival, seq=-1, feat_dim=4, keys=()):
    return ScoreRequest(features=np.zeros(feat_dim, np.float32), entity_keys=list(keys),
                        arrival=arrival, seq=seq)


def test_worker_defers_flush_while_virtually_busy():
    w = SpeedLayerWorker(0, _const_score_fn, max_batch=2, max_wait_s=10.0,
                         service_model_s=1.0)
    for i in range(6):
        w.enqueue(_req(arrival=0.1 * i, seq=i))
    assert len(w.pump(now=0.5)) == 2
    assert w.busy_until == pytest.approx(1.1)
    assert len(w) == 4 and w.pump(now=0.6) == []
    assert len(w.pump(now=1.2)) == 2 and len(w) == 2
    assert w.stats["max_queue_depth"] == 6


def _bare_pool(max_batch, steal_threshold):
    pool = WorkerPool.__new__(WorkerPool)      # no scorers: a constant score_fn
    pool.router = ShardRouter(2)
    pool.max_batch = max_batch
    pool.steal_threshold = steal_threshold
    pool.workers = [SpeedLayerWorker(w, _const_score_fn, max_batch=max_batch,
                                     max_wait_s=10.0, service_model_s=5.0) for w in range(2)]
    pool._reorder = _ReorderBuffer()
    pool._seq = 0
    pool.pool_stats = {"steals": 0, "stolen_requests": 0, "routed": 0}
    return pool


def test_pool_steals_from_backed_up_shard():
    pool = _bare_pool(max_batch=2, steal_threshold=3)
    victim, thief = pool.workers
    for i in range(6):
        victim.enqueue(_req(arrival=0.01 * i, seq=i))
    victim.busy_until = 100.0
    out = pool.poll(now=1.0)
    assert pool.pool_stats["steals"] == 1 and pool.pool_stats["stolen_requests"] == 3
    assert thief.stats["stolen_in"] == victim.stats["stolen_out"] == 3
    assert [r.request.seq for r in out] == [0, 1] and all(r.worker == 1 for r in out)
    assert len(victim) == 3 and len(thief) == 1
    # stamps floor at the steal time, not the victim's missed triggers
    assert all(r.queued_s == pytest.approx(1.0 - r.request.arrival) for r in out)


def test_pool_does_not_steal_below_threshold():
    pool = _bare_pool(max_batch=4, steal_threshold=8)
    victim = pool.workers[0]
    for i in range(5):
        victim.enqueue(_req(arrival=0.01 * i, seq=i))
    victim.busy_until = 100.0
    pool.poll(now=1.0)
    assert pool.pool_stats["steals"] == 0 and len(victim) == 5


def test_take_steals_oldest_requests_atomically():
    mb = MicroBatcher(_const_score_fn, max_batch=8, max_wait_s=10.0)
    for i in range(5):
        mb.enqueue(_req(arrival=0.1 * i, seq=i))
    assert [r.seq for r in mb.take(2)] == [0, 1]
    assert len(mb) == 3 and mb.stats["stolen"] == 2
    assert mb.oldest_arrival == pytest.approx(0.2)
    assert mb.take(0) == [] and len(mb.take(99)) == 3 and len(mb) == 0


def test_concurrent_take_and_flush_score_each_request_once():
    """Thieves and flushers on several threads drain one queue: every
    request comes out exactly once, and no flush scores zero rows."""
    rows = []

    def score_fn(feats, key_lists):
        rows.append(feats.shape[0])
        return _const_score_fn(feats, key_lists)

    mb = MicroBatcher(score_fn, max_batch=4, max_wait_s=10.0)
    for i in range(2000):
        mb.enqueue(_req(arrival=0.0, seq=i))
    seen, lock = [], threading.Lock()

    def drain(steal):
        while len(mb):
            got = mb.take(3) if steal else mb.flush(0.0)
            with lock:
                seen.extend(r.seq if steal else r.request.seq for r in got)

    threads = [threading.Thread(target=drain, args=(i % 2 == 0,)) for i in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sorted(seen) == list(range(2000))
    assert 0 not in rows and mb.stats["flushes"] == len(rows)


# -------------------------------------------------------- depth autoscaler
class _FakePool:
    """Exactly the surface DepthAutoscaler touches."""

    def __init__(self, num_workers=2, max_batch=8):
        self.num_workers, self.max_batch = num_workers, max_batch
        self.steal_threshold, self.depth, self.resharded = None, 0, []

    def __len__(self):
        return self.depth

    def reshard(self, n):
        self.resharded.append(n)
        self.num_workers = n
        return [f"drained@{n}"]


def test_autoscaler_hysteresis_scale_up_down_cooldown():
    pool = _FakePool(num_workers=1)
    a = DepthAutoscaler(pool, min_workers=1, max_workers=3, high_depth=4.0, low_depth=1.0,
                        sustain=3, cooldown=2)
    pool.depth = 20
    assert a.observe(0.0) == [] and a.observe(0.0) == []
    assert a.observe(0.0) == ["drained@2"] and a.stats["scale_ups"] == 1
    assert a.observe(0.0) == [] and a.observe(0.0) == []          # cooldown
    for _ in range(2):
        assert a.observe(0.0) == []
    assert a.observe(0.0) == ["drained@3"] and pool.num_workers == 3
    pool.depth = 0
    for _ in range(4):
        a.observe(0.0)
    assert a.observe(0.0) == ["drained@2"] and a.stats["scale_downs"] == 1
    assert pool.resharded == [2, 3, 2]


def test_autoscaler_adaptive_steal_and_state_roundtrip():
    pool = _FakePool(num_workers=2, max_batch=8)
    a = DepthAutoscaler(pool, autoscale=False, adaptive_steal=True, high_depth=8.0,
                        low_depth=1.0)
    a.observe(0.0)
    assert pool.steal_threshold == 8                  # floored at max_batch
    pool.depth = 64
    for _ in range(DepthAutoscaler.WINDOW):
        a.observe(0.0)
    assert pool.steal_threshold == 64 and pool.resharded == []
    st = a.state_dict()
    b = DepthAutoscaler(_FakePool(num_workers=2, max_batch=8), autoscale=False,
                        adaptive_steal=True, high_depth=8.0, low_depth=1.0)
    b.load_state(st)
    assert b.state_dict() == st
    for bad in (dict(min_workers=0), dict(min_workers=3, max_workers=2),
                dict(low_depth=8.0, high_depth=8.0)):
        with pytest.raises(ValueError):
            DepthAutoscaler(_FakePool(), **bad)


def test_autoscaler_grows_a_live_pool_and_scores_stay_the_same():
    """Sustained depth grows a real inline pool through ``WorkerPool.reshard``
    mid-stream; every request scores once, as one fixed worker scores it."""
    from repro_torch.data import SynthConfig, generate_event_stream

    events, g, _ = generate_event_stream(
        SynthConfig(num_users=60, num_rings=2, feature_noise=0.8, seed=3), rate_per_s=500.0)
    evs = events[:160]
    cfg = LNNConfig(num_gnn_layers=2, hidden_dim=16, feat_dim=g.order_features.shape[1])
    params = lnn_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    ecfg = dict(max_batch=32, max_wait_s=1.0, shard_by_entity=True)
    s_ref = StreamingEngine(params, cfg, EngineConfig(**ecfg),
                            device="cpu").replay(evs).scores_by_order()
    eng = StreamingEngine(params, cfg, EngineConfig(**ecfg), device="cpu")
    scaler = DepthAutoscaler(eng.pool, min_workers=1, max_workers=3, high_depth=4.0,
                             low_depth=0.5, sustain=4, cooldown=8)
    out = []
    for ev in evs:
        out.extend(eng.submit(ev))
        out.extend(scaler.observe(ev.arrival))
    out.extend(eng.flush())
    assert scaler.stats["scale_ups"] >= 1 and eng.pool.num_workers > 1
    assert eng.store.num_shards == eng.pool.num_workers
    assert {r.request.tag.order_id: r.score for r in out} == s_ref
    assert len(out) == len(evs)


# ------------------------------------------------------------ Stage2Scorer
@pytest.fixture(scope="module")
def scorer_world():
    cfg = LNNConfig(num_gnn_layers=2, hidden_dim=8, feat_dim=4)
    params = lnn_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    params_b = lnn_init(torch.Generator().manual_seed(1), cfg, device="cpu")
    store = KVStore(cfg.hidden_dim)
    rng = np.random.default_rng(0)
    store.put_batch([pack_key(e, 0) for e in range(6)],
                    rng.normal(size=(6, cfg.hidden_dim)).astype(np.float32))
    feats = rng.normal(size=(4, 4)).astype(np.float32)
    keys = [[(0, 1), (1, 1)], [(2, 1)], [], [(3, 1), (4, 1), (5, 1)]]
    return cfg, params, params_b, store, feats, keys


def test_scorer_keeps_one_pack_per_version(scorer_world):
    cfg, params, params_b, store, feats, keys = scorer_world
    sc = Stage2Scorer(params, cfg, store, k_max=4, device="cpu")
    p0, pack0 = sc(feats, keys), sc._pack
    assert p0[2] == 0 and p0[0].dtype == np.float32 and p0[0].shape == (4,)
    sc.set_model(params_b, 1)
    p1 = sc(feats, keys)
    assert p1[2] == 1 and not np.array_equal(p1[0], p0[0])
    np.testing.assert_array_equal(p1[0], Stage2Scorer(params_b, cfg, store, 4,
                                                      device="cpu")(feats, keys)[0])
    sc.set_model(params, 0)                      # back: the version's pack is reused
    assert sc._pack is pack0
    np.testing.assert_array_equal(sc(feats, keys)[0], p0[0])
    sc.set_model(params_b, 0)                    # the version anew, other weights: repacked
    assert sc._pack is not pack0
    np.testing.assert_array_equal(sc(feats, keys)[0], p1[0])
    np.testing.assert_array_equal(p0[1], [1, 1, -1, 1])     # served from snapshot 0 for t=1


def test_flush_finishes_on_the_model_it_started_with(scorer_world):
    """A hot swap landing during a flush's KV lookup does not reach that
    flush: it scores and stamps the (params, version, pack) it captured."""
    cfg, params, params_b, store, feats, keys = scorer_world
    sc = Stage2Scorer(params, cfg, store, k_max=4, device="cpu")
    want = sc(feats, keys)[0]

    class SwappingStore:
        def lookup_batch_versioned(self, *args, **kw):
            sc.set_model(params_b, 5)
            return store.lookup_batch_versioned(*args, **kw)

    sc.store = SwappingStore()
    probs, _, version = sc(feats, keys)
    assert version == 0
    np.testing.assert_array_equal(probs, want)
    assert sc.model_version == 5


def test_scorer_slot_types_follow_the_entity_tags():
    cfg = LNNConfig(num_gnn_layers=2, hidden_dim=8, feat_dim=4,
                    entity_types=("buyer", "merchant", "device", "payment"))
    params = lnn_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    sc = Stage2Scorer(params, cfg, KVStore(8, require_typed=True), k_max=3, device="cpu")
    pairs = [[(tag_entity(7, 2), 0), (tag_entity(9, 0), 1), (tag_entity(1, 3), 0),
              (tag_entity(2, 1), 0)], [], [(tag_entity(4, 1), 2)]]
    np.testing.assert_array_equal(sc._slot_types(pairs),
                                  [[2, 0, 3], [-1, -1, -1], [1, -1, -1]])
    probs, stale, _ = sc(np.zeros((3, 4), np.float32), pairs)
    assert np.isfinite(probs).all() and (stale == -1).all()


def test_scorer_refuses_a_hybrid_model(scorer_world):
    cfg, params, _, store, _, _ = scorer_world

    class Hybrid:
        lnn_params = params
        gbdt = None

    with pytest.raises(NotImplementedError, match="queue 1 item 2"):
        Stage2Scorer(Hybrid(), cfg, store, k_max=4, device="cpu")
    sc = Stage2Scorer(params, cfg, store, k_max=4, device="cpu")
    with pytest.raises(NotImplementedError, match="hybrid"):
        sc.set_model(Hybrid(), 1)
    assert sc.model_version == 0
