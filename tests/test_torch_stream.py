"""The port's streaming path against the reference's, on the CPU: the event
stream, the named-attack stream, the ingester and its community subgraphs
are equal to the reference's; a whole ``StreamingEngine`` replay with the
reference's parameters (``repro.core.lnn_init`` through numpy and
``repro_torch.params.from_numpy``) gives the reference's scores within
1e-5 and its KV store within 2e-5 (f32 on both sides, summed in another
order), with the same flushes, staleness and refresh counters; and the
engine behaves as the reference's tests check it."""
import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

import repro.core as R
import repro.data as RD
import repro.stream as RS
from repro.core.dds import IncrementalDDSBuilder as RefBuilder
from repro.core.partition import IncrementalPartitioner as RefPartitioner
from repro_torch.core import ENTITY_TYPE_NAMES, LNNConfig, check_no_future_leak, lnn_init
from repro_torch.core.dds import IncrementalDDSBuilder
from repro_torch.core.graph import pad_graph
from repro_torch.core.partition import IncrementalPartitioner
from repro_torch.data import (AttackConfig, SynthConfig, generate_attack_stream,
                              generate_event_stream)
from repro_torch.params import from_numpy
from repro_torch.stream import (CheckoutEvent, EngineConfig, MicroBatcher, ScoreRequest,
                                StreamingEngine, StreamIngester, events_from_static)
from repro_torch.stream.microbatch import bucket_size

GNN_TYPES = ["gcn", "gat", "sage"]
WORLD = dict(num_users=80, num_rings=3, feature_noise=0.8, seed=5)
RATE = 500.0
SCORE_TOL = 1e-5     # scores, f32 on both sides
STORE_TOL = 2e-5     # stage-1 embeddings in the KV store (graph aggregations)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the replays run many small products, and under
    several test workers on one host torch's default of a thread per core
    oversubscribes it (a replay then runs tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(ref_cfg):
    return LNNConfig(**{f.name: getattr(ref_cfg, f.name)
                        for f in dataclasses.fields(LNNConfig)})


def _to_port(params):
    return from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")


def _ref_engine(params, cfg, ecfg):
    with warnings.catch_warnings():      # the reference deprecates direct construction
        warnings.simplefilter("ignore", DeprecationWarning)
        return RS.StreamingEngine(params, cfg, ecfg)


def _store_contents(store) -> dict:
    """key -> (value, model version) of every entry of every shard."""
    return {k: (e.value, e.model_version) for shard in store._shards for k, e in shard.items()}


@pytest.fixture(scope="module")
def worlds():
    """The reference's event stream and the port's, from the same seed."""
    ref = RD.generate_event_stream(RD.SynthConfig(**WORLD), rate_per_s=RATE)
    port = generate_event_stream(SynthConfig(**WORLD), rate_per_s=RATE)
    return ref, port


def _same_events(ref_events, events):
    assert len(ref_events) == len(events) > 0
    for a, b in zip(ref_events, events):
        assert (a.order_id, a.snapshot, a.entities, a.label, a.arrival) == \
            (b.order_id, b.snapshot, b.entities, b.label, b.arrival)
        np.testing.assert_array_equal(a.features, b.features)
        assert a.features.dtype == b.features.dtype


# ------------------------------------------------------------- the streams
def test_event_stream_equals_reference(worlds):
    (ref_events, ref_g, ref_split), (events, g, split) = worlds
    _same_events(ref_events, events)
    np.testing.assert_array_equal(ref_split, split)
    for f in ("edges", "order_snapshot", "order_features", "labels", "entity_type"):
        np.testing.assert_array_equal(getattr(ref_g, f), getattr(g, f))
    # the static-graph replay at another rate and seed
    from repro.stream import events_from_static as ref_events_from_static
    _same_events(ref_events_from_static(ref_g, rate_per_s=75.0, seed=3),
                 events_from_static(g, rate_per_s=75.0, seed=3))


@pytest.mark.parametrize("kw", [{}, {"seed": 3, "feature_noise": 0.5, "num_rings": 2}])
def test_attack_stream_equals_reference(kw):
    ref_events, ref_patterns = RD.generate_attack_stream(RD.AttackConfig(**kw), rate_per_s=RATE)
    events, patterns = generate_attack_stream(AttackConfig(**kw), rate_per_s=RATE)
    _same_events(ref_events, events)
    np.testing.assert_array_equal(ref_patterns, patterns)
    assert set(patterns) == {"legit", "ring", "burst", "bin_test"}
    assert all(len(ev.entities) == 4 for ev in events)


# ------------------------------------------------------------- the ingester
def test_ingester_equals_reference(worlds):
    """Entity keys and closed windows per event, and at every few windows the
    drained community groups and their materialized subgraphs."""
    (ref_events, _, _), (events, g, _) = worlds
    feat_dim = g.order_features.shape[1]
    ref_ing, ing = RS.StreamIngester(feat_dim), StreamIngester(feat_dim)
    drained = 0
    for ref_ev, ev in zip(ref_events, events):
        a, b = ref_ing.ingest(ref_ev), ing.ingest(ev)
        assert (a.order_id, a.entity_keys, a.closed_window) == \
            (b.order_id, b.entity_keys, b.closed_window)
        if b.closed_window is None or b.closed_window[1] % 3:
            continue
        assert ref_ing.dirty_communities == ing.dirty_communities
        groups = ing.take_refreshable_by_community(b.closed_window[1])
        assert ref_ing.take_refreshable_by_community(a.closed_window[1]) == groups
        assert groups and ref_ing.dirty_count == ing.dirty_count
        cids = [c for c, _ in groups]
        assert [ref_ing.community_node_count(c) for c in cids] == \
            [ing.community_node_count(c) for c in cids]
        sub_ref = ref_ing.materialize_communities(cids)
        sub = ing.materialize_communities(cids)
        check_no_future_leak(sub)
        assert sub_ref.entity_snap_ids == sub.entity_snap_ids
        assert sub_ref.last_hop == sub.last_hop
        pg_ref, pg = pad_graph(sub_ref.coo, max_deg=32), pad_graph(sub.coo, max_deg=32)
        for f in pg._fields:
            np.testing.assert_array_equal(getattr(pg_ref, f), getattr(pg, f), err_msg=f)
        drained += 1
    assert drained >= 3
    assert ref_ing.stats == ing.stats


def _ingest_pair(events, feat_dim, history, max_history):
    out = []
    for builder_cls, part_cls in ((RefBuilder, RefPartitioner),
                                  (IncrementalDDSBuilder, IncrementalPartitioner)):
        b, part = builder_cls(feat_dim, history, max_history), part_cls()
        for ev in events:
            b.add_order(ev.entities, ev.snapshot, ev.features, ev.label)
            part.add_order(ev.entities)
        out.append((b, part))
    return out


@pytest.mark.parametrize("history,max_history",
                         [("all", None), ("all", 4), ("consecutive", None)])
def test_build_subgraph_equals_reference(worlds, history, max_history):
    """``build_subgraph`` over component-closed entity sets (single
    communities and a union) builds the reference's subgraph, which holds
    the port's no-future-leak checks; an unclosed set raises as there."""
    _, (events, g, _) = worlds
    (rb, rpart), (b, part) = _ingest_pair(events, g.order_features.shape[1], history,
                                          max_history)
    assert rpart.assignment() == part.assignment()
    communities = sorted({part.community_of(e) for e in part.assignment()})
    for pick in ([communities[0]], [communities[-1]], communities[1:4]):
        ents = set()
        for c in pick:
            ents.update(part.members(c))
        sub_ref, sub = rb.build_subgraph(ents), b.build_subgraph(ents)
        check_no_future_leak(sub)
        for f in ("num_nodes", "src", "dst", "etype", "features", "node_type", "snapshot",
                  "label", "label_mask"):
            np.testing.assert_array_equal(getattr(sub_ref.coo, f), getattr(sub.coo, f),
                                          err_msg=f)
        assert sub_ref.entity_snap_ids == sub.entity_snap_ids
        assert sub_ref.last_hop == sub.last_hop
    multi = next(ev for ev in events if len(ev.entities) >= 2)
    ents = set(part.members(part.community_of(multi.entities[0])))
    ents.discard(int(multi.entities[1]))
    with pytest.raises(ValueError, match="component-closed"):
        b.build_subgraph(ents)


# ------------------------------------------------- whole replays, held to it
def _replay_pair(ref_params, ref_cfg, events, **ecfg):
    ref_eng = _ref_engine(ref_params, ref_cfg, RS.EngineConfig(**ecfg))
    ref_rep = ref_eng.replay(events)
    eng = StreamingEngine(_to_port(ref_params), _port_cfg(ref_cfg), EngineConfig(**ecfg),
                          device="cpu")
    rep = eng.replay(events)
    return ref_eng, ref_rep, eng, rep


def _assert_replays_agree(ref_eng, ref_rep, eng, rep):
    s_ref, s = ref_rep.scores_by_order(), rep.scores_by_order()
    assert set(s) == set(s_ref) and len(s) == len(rep.results)
    np.testing.assert_allclose([s[o] for o in sorted(s)], [s_ref[o] for o in sorted(s)],
                               atol=SCORE_TOL, rtol=SCORE_TOL)
    assert rep.staleness_summary() == ref_rep.staleness_summary()
    # flush decisions run on the virtual clock: the same batches, in order
    assert [(r.request.tag.order_id, r.batch_size, r.staleness, r.worker)
            for r in rep.results] == \
        [(r.request.tag.order_id, r.batch_size, r.staleness, r.worker)
         for r in ref_rep.results]
    for k in ("flushes", "size_flushes", "deadline_flushes", "padded_rows", "requests"):
        assert eng.pool.stats[k] == ref_eng.pool.stats[k], k
    for k in ("refreshes", "entities_written", "per_shard_written", "nodes_padded",
              "communities_refreshed", "stage1_launches", "last_budget"):
        assert eng.refresher.stats[k] == ref_eng.refresher.stats[k], k
    assert list(eng.refresher.stats["budget_history"]) == \
        list(ref_eng.refresher.stats["budget_history"])
    c_ref, c = _store_contents(ref_eng.store), _store_contents(eng.store)
    assert set(c) == set(c_ref) and len(c) > 0
    keys = sorted(c)
    np.testing.assert_allclose(np.stack([c[k][0] for k in keys]),
                               np.stack([c_ref[k][0] for k in keys]),
                               atol=STORE_TOL, rtol=STORE_TOL)
    assert [c[k][1] for k in keys] == [c_ref[k][1] for k in keys]
    assert eng.store.stats == ref_eng.store.stats


@pytest.mark.parametrize("gnn_type", GNN_TYPES)
def test_replay_matches_reference(worlds, gnn_type):
    (ref_events, g, _), (events, _, _) = worlds
    ref_cfg = R.LNNConfig(gnn_type=gnn_type, num_gnn_layers=3, hidden_dim=32,
                          feat_dim=g.order_features.shape[1])
    params = R.lnn_init(jax.random.PRNGKey(0), ref_cfg)
    ref_eng = _ref_engine(params, ref_cfg, RS.EngineConfig(max_batch=8))
    ref_rep = ref_eng.replay(ref_events)
    eng = StreamingEngine(_to_port(params), _port_cfg(ref_cfg), EngineConfig(max_batch=8),
                          device="cpu")
    rep = eng.replay(events)
    _assert_replays_agree(ref_eng, ref_rep, eng, rep)
    assert eng.refresher.stats["refreshes"] > 10


def test_typed_attack_replay_matches_reference():
    """The typed named-attack stream through a typed GAT model (per-type
    towers, type-tagged KV keys, per-slot entity types into stage 2), at
    four workers."""
    ref_events, _ = RD.generate_attack_stream(RD.AttackConfig(), rate_per_s=RATE)
    events, _ = generate_attack_stream(AttackConfig(), rate_per_s=RATE)
    ref_cfg = R.LNNConfig(gnn_type="gat", num_gnn_layers=3, hidden_dim=32, feat_dim=12,
                          entity_types=ENTITY_TYPE_NAMES)
    params = R.lnn_init(jax.random.PRNGKey(4), ref_cfg)
    ref_eng = _ref_engine(params, ref_cfg, RS.EngineConfig(max_batch=8, num_workers=4))
    ref_rep = ref_eng.replay(ref_events)
    eng = StreamingEngine(_to_port(params), _port_cfg(ref_cfg),
                          EngineConfig(max_batch=8, num_workers=4), device="cpu")
    rep = eng.replay(events)
    _assert_replays_agree(ref_eng, ref_rep, eng, rep)
    assert eng.store.require_typed and "typed" in eng.params
    assert len({r.worker for r in rep.results}) > 1


# ------------------------------------------------------------- micro-batcher
def _const_score_fn(feats, key_lists):
    return np.full(feats.shape[0], 0.5), np.zeros(feats.shape[0], np.int32)


def _req(arrival, feat_dim=4):
    return ScoreRequest(features=np.zeros(feat_dim, np.float32), entity_keys=[],
                        arrival=arrival)


def test_bucket_size_is_pow2_floored_at_two_and_capped():
    assert [bucket_size(n, 16) for n in range(1, 17)] == \
        [2, 2, 4, 4, 8, 8, 8, 8] + [16] * 8
    assert bucket_size(5, 6) == 6 and bucket_size(1, 1) == 1


def test_microbatch_size_trigger():
    mb = MicroBatcher(_const_score_fn, max_batch=4, max_wait_s=10.0)
    out = []
    for i in range(3):
        out += mb.submit(_req(arrival=0.001 * i), now=0.001 * i)
    assert out == [] and len(mb) == 3
    out += mb.submit(_req(arrival=0.003), now=0.003)
    assert len(out) == 4 and len(mb) == 0
    assert mb.stats["size_flushes"] == 1
    assert all(r.batch_size == 4 for r in out)


def test_microbatch_deadline_trigger_and_injected_clock():
    mb = MicroBatcher(_const_score_fn, max_batch=64, max_wait_s=0.005)
    mb.submit(_req(arrival=1.000), now=1.000)
    assert mb.poll(now=1.004) == []
    out = mb.poll(now=1.0051)
    assert len(out) == 1 and mb.stats["deadline_flushes"] == 1
    assert out[0].queued_s == pytest.approx(0.005)      # stamped at the deadline
    t = {"now": 100.0}
    mb = MicroBatcher(_const_score_fn, max_batch=8, max_wait_s=0.005, clock=lambda: t["now"])
    mb.submit(_req(arrival=0.0))                         # stamped from the clock
    t["now"] += 0.004
    assert mb.poll() == []
    t["now"] += 0.002
    assert len(mb.poll()) == 1
    import time
    assert MicroBatcher(_const_score_fn).clock is time.monotonic


def test_empty_deadline_flush_is_a_noop():
    """A deadline flush that lost its queue to a concurrent take emits
    nothing: no zero-row score call, no flush counted."""
    calls = []

    def score_fn(feats, key_lists):
        calls.append(feats.shape[0])
        return _const_score_fn(feats, key_lists)

    mb = MicroBatcher(score_fn, max_batch=8, max_wait_s=0.005)
    mb.submit(_req(arrival=1.0), now=1.0)
    dl = mb.deadline()
    assert len(mb.take(1)) == 1
    assert mb.flush(dl) == [] and calls == []
    assert (mb.stats["flushes"], mb.stats["deadline_flushes"], mb.stats["empty_flushes"]) == \
        (0, 0, 1)
    out = mb.submit(_req(arrival=3.0), now=3.0) + mb.poll(now=3.1)
    assert len(out) == 1 and calls == [2]               # one row, bucket 2


# ------------------------------------------------------------ engine behaviour
@pytest.fixture(scope="module")
def port_world(worlds):
    _, (events, g, _) = worlds
    cfg = LNNConfig(num_gnn_layers=3, hidden_dim=32, feat_dim=g.order_features.shape[1])
    params = lnn_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    return events, cfg, params


def test_bucket_padding_does_not_move_real_rows(port_world):
    """Five requests padded to bucket 8, as a flush pads them, score each
    row as it scores alone in bucket 2, bit for bit."""
    events, cfg, params = port_world
    eng = StreamingEngine(params, cfg, EngineConfig(max_batch=8), device="cpu")
    for ev in events:
        eng.submit(ev)
    eng.flush()
    keys = [eng.ingester.builder.entity_keys(ev.entities, ev.snapshot) for ev in events[-5:]]
    assert any(keys)
    feats = np.stack([ev.features for ev in events[-5:]]).astype(np.float32)

    def padded(rows):
        b = bucket_size(len(rows), 8)
        f = np.zeros((b, feats.shape[1]), np.float32)
        f[:len(rows)] = feats[rows]
        return eng._score_batch(f, [keys[i] for i in rows] + [[]] * (b - len(rows)))[0]

    p5 = padded(list(range(5)))
    assert p5.shape == (8,)
    np.testing.assert_array_equal(p5[:5], np.concatenate([padded([i])[:1] for i in range(5)]))


def test_staleness_grows_with_refresh_interval(port_world):
    events, cfg, params = port_world
    fresh = StreamingEngine(params, cfg, EngineConfig(max_batch=8), device="cpu")
    lazy = StreamingEngine(params, cfg, EngineConfig(max_batch=8, refresh_every=6),
                           device="cpu")
    s_fresh = fresh.replay(events).staleness_summary()
    s_lazy = lazy.replay(events).staleness_summary()
    assert s_fresh["stale_frac"] == 0.0 < s_lazy["stale_frac"]
    assert lazy.refresher.stats["refreshes"] < fresh.refresher.stats["refreshes"]


def test_cold_start_scores_without_history():
    cfg = LNNConfig(num_gnn_layers=2, hidden_dim=16, feat_dim=4)
    params = lnn_init(torch.Generator().manual_seed(1), cfg, device="cpu")
    eng = StreamingEngine(params, cfg, EngineConfig(max_batch=2, max_wait_s=0.001),
                          device="cpu")
    evs = [CheckoutEvent(order_id=i, snapshot=0, entities=(i, 100 + i),
                         features=np.zeros(4, np.float32), label=0.0, arrival=0.001 * i)
           for i in range(3)]
    out = []
    for ev in evs:
        out += eng.submit(ev)
    out += eng.flush()
    assert len(out) == 3
    assert all(np.isfinite(r.score) for r in out)
    assert all(r.staleness == -1 for r in out)


def test_results_arrive_in_submission_order_and_summary(port_world):
    events, cfg, params = port_world
    eng = StreamingEngine(params, cfg, EngineConfig(max_batch=8, num_workers=4), device="cpu")
    rep = eng.replay(events[:120])
    assert [r.request.seq for r in rep.results] == list(range(120))
    summary = rep.summary()
    assert summary["events"] == summary["scored"] == 120
    assert summary["num_workers"] == 4 and len(summary["workers"]) == 4
    pct = rep.percentiles_ms()
    assert 0.0 <= pct["p50"] <= pct["p95"] <= pct["p99"]
    assert summary["flushes"] == sum(w["flushes"] for w in summary["workers"])


def test_work_stealing_preserves_scores(port_world):
    events, cfg, params = port_world
    evs = events[:150]
    ref = StreamingEngine(params, cfg, EngineConfig(max_batch=8), device="cpu")
    s_ref = ref.replay(evs).scores_by_order()
    eng = StreamingEngine(params, cfg, EngineConfig(max_batch=8, num_workers=4,
                                                    service_model_s=0.05,
                                                    steal_threshold=10), device="cpu")
    rep = eng.replay(evs)
    assert eng.pool.pool_stats["steals"] > 0
    assert rep.scores_by_order() == s_ref
    off_affine = [r for r in rep.results
                  if r.worker != eng.pool.router.route(r.request.entity_keys)]
    assert 0 < len(off_affine) <= eng.pool.pool_stats["stolen_requests"]


def test_live_reshard_preserves_scores_and_affinity(port_world):
    from repro_torch.serve.kvstore import pack_key

    events, cfg, params = port_world
    s_ref = StreamingEngine(params, cfg, EngineConfig(max_batch=8),
                            device="cpu").replay(events).scores_by_order()
    eng = StreamingEngine(params, cfg, EngineConfig(max_batch=8, num_workers=2), device="cpu")
    eng.warmup()
    results, half = [], len(events) // 2
    for ev in events[:half]:
        results.extend(eng.submit(ev))
    results.extend(eng.pool.reshard(4))
    assert eng.pool.num_workers == 4 and eng.store.num_shards == 4
    for ent in range(50):
        assert eng.store.shard_of(pack_key(ent, 0)) == eng.pool.router.worker_of(ent)
    for ev in events[half:]:
        results.extend(eng.submit(ev))
    results.extend(eng.flush())
    assert {r.request.tag.order_id: r.score for r in results} == s_ref
    for n0, n1 in ((2, 8), (4, 2)):
        bad = StreamingEngine(params, cfg, EngineConfig(max_batch=8, num_workers=n0),
                              device="cpu")
        bad.pool.router.reshard(n1)
        with pytest.raises(RuntimeError, match="WorkerPool.reshard"):
            bad.submit(events[0])
