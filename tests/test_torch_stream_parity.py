"""The streaming engine's bit-identity ladder, rebuilt on the port against
itself on the CPU: N-worker replays and randomised flush interleavings
score bit for bit as one worker does; community-local refresh writes the
same KV bytes and version stamps as whole-graph refresh, at every bin
budget, across a mid-stream hot swap, asynchronously and at lazy
cadences; and the replayed scores equal the port's monolithic
``lnn_forward`` on the materialized graph within 1e-4 (the reference's
bound: stage 1 and stage 2 sum in another order than the full forward)."""
import numpy as np
import pytest
import torch

from repro_torch.core import LNNConfig, lnn_forward, lnn_init, lnn_stage1
from repro_torch.core.graph import pad_graph
from repro_torch.core.layers import chunked_matmul, row_stable_matmul
from repro_torch.data import SynthConfig, generate_event_stream
from repro_torch.serve.lambda_pipeline import host_sigmoid
from repro_torch.stream import EngineConfig, StreamingEngine

GNN_TYPES = ["gcn", "gat", "sage"]
MONOLITHIC_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the replays run many small products, and under
    several test workers on one host torch's default of a thread per core
    oversubscribes it (a replay then runs tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    events, g, _ = generate_event_stream(
        SynthConfig(num_users=80, num_rings=3, feature_noise=0.8, seed=5), rate_per_s=500.0)
    return events, g.order_features.shape[1]


def _model(feat_dim, gnn_type="gcn", seed=0):
    cfg = LNNConfig(gnn_type=gnn_type, num_gnn_layers=3, hidden_dim=32, feat_dim=feat_dim)
    return cfg, lnn_init(torch.Generator().manual_seed(seed), cfg, device="cpu")


def _engine(params, cfg, **kw):
    return StreamingEngine(params, cfg, EngineConfig(max_batch=8, **kw), device="cpu")


def _store_contents(store) -> dict:
    """key -> (bytes, version stamp) of every entry of every shard."""
    return {k: (e.value.tobytes(), e.model_version)
            for shard in store._shards for k, e in shard.items()}


@pytest.fixture(scope="module", params=GNN_TYPES)
def single(request, world):
    """One worker, community-local refresh: the replay the others are held to."""
    events, feat_dim = world
    cfg, params = _model(feat_dim, request.param)
    eng = _engine(params, cfg)
    return cfg, params, eng, eng.replay(events)


# ------------------------------------------------------------- N workers
@pytest.mark.parametrize("num_workers", [2, 4])
def test_nworker_replay_bit_identical(world, single, num_workers):
    events, _ = world
    cfg, params, _, rep1 = single
    eng = _engine(params, cfg, num_workers=num_workers)
    rep = eng.replay(events)
    assert rep.scores_by_order() == rep1.scores_by_order()
    assert rep.staleness_summary() == rep1.staleness_summary()
    served = [w for w in rep.summary()["workers"] if w["requests"] > 0]
    assert len(served) > 1


def test_randomised_flush_interleavings_bit_identical(world):
    """Every knob that changes when and how flushes fire, drawn from a
    seeded generator: worker count, batch cap, deadline, virtual service
    time, steal threshold."""
    events, feat_dim = world
    evs = events[:150]
    cfg, params = _model(feat_dim)
    s_ref = _engine(params, cfg).replay(evs).scores_by_order()
    rng = np.random.default_rng(0)
    for trial in range(4):
        kw = dict(num_workers=int(rng.integers(2, 5)),
                  max_wait_s=float(rng.choice([0.001, 0.005, 0.02])),
                  service_model_s=float(rng.choice([0.0, 0.01, 0.05])),
                  steal_threshold=int(rng.choice([6, 10])))
        eng = StreamingEngine(params, cfg, EngineConfig(max_batch=int(rng.choice([4, 8, 16])),
                                                        **kw), device="cpu")
        assert eng.replay(evs).scores_by_order() == s_ref, (trial, kw)


# ------------------------------------------------------------- refresh scope
def _assert_same_refresh(eng_f, rep_f, eng_c, rep_c):
    assert rep_c.scores_by_order() == rep_f.scores_by_order()
    assert rep_c.staleness_summary() == rep_f.staleness_summary()
    cf, cc = _store_contents(eng_f.store), _store_contents(eng_c.store)
    assert set(cf) == set(cc) and cf == cc
    for k in ("refreshes", "entities_written", "per_shard_written"):
        assert eng_c.refresher.stats[k] == eng_f.refresher.stats[k], k


@pytest.mark.parametrize("num_workers", [1, 4])
def test_community_local_equals_whole_graph(world, single, num_workers):
    events, _ = world
    cfg, params, eng1, rep1 = single
    eng_f = _engine(params, cfg, community_local=False, num_workers=num_workers)
    rep_f = eng_f.replay(events)
    if num_workers == 1:
        eng_c, rep_c = eng1, rep1
    else:
        eng_c = _engine(params, cfg, community_size=512, num_workers=num_workers)
        rep_c = eng_c.replay(events)
    _assert_same_refresh(eng_f, rep_f, eng_c, rep_c)
    assert eng_c.refresher.stats["nodes_padded"] < eng_f.refresher.stats["nodes_padded"]


@pytest.mark.parametrize("community_size", [1, 256, 512])
def test_bin_budgets_keep_store_bytes(world, community_size):
    events, feat_dim = world
    evs = events[:120]
    cfg, params = _model(feat_dim)
    eng_f, eng_c = (_engine(params, cfg, community_local=False),
                    _engine(params, cfg, community_size=community_size))
    _assert_same_refresh(eng_f, eng_f.replay(evs), eng_c, eng_c.replay(evs))
    if community_size == 1:      # every community its own stage-1 call
        st = eng_c.refresher.stats
        assert st["stage1_launches"] == st["communities_refreshed"] > st["refreshes"]


def test_hot_swap_mid_stream_keeps_scopes_equal(world):
    events, feat_dim = world
    cfg, params = _model(feat_dim)
    params_b = lnn_init(torch.Generator().manual_seed(9), cfg, device="cpu")
    half = len(events) // 2

    def run(community_local):
        eng = _engine(params, cfg, community_local=community_local, community_size=512)
        eng.warmup()
        out = []
        for ev in events[:half]:
            out.extend(eng.submit(ev))
        assert eng.load_model(params_b) == 1
        for ev in events[half:]:
            out.extend(eng.submit(ev))
        out.extend(eng.flush())
        return {r.request.tag.order_id: (r.score, r.model_version) for r in out}, eng

    s_f, eng_f = run(False)
    s_c, eng_c = run(True)
    assert s_c == s_f
    assert {v for _, v in s_f.values()} == {0, 1}
    cf = _store_contents(eng_f.store)
    assert _store_contents(eng_c.store) == cf
    assert {mv for _, mv in cf.values()} == {0, 1}


def test_async_refresh_drains_to_the_sync_bytes(world):
    events, feat_dim = world
    evs = events[:150]
    cfg, params = _model(feat_dim)
    eng_f = _engine(params, cfg, community_local=False)
    eng_f.replay(evs)
    eng_a = _engine(params, cfg, community_size=512, async_refresh=True)
    rep_a = eng_a.replay(evs)
    eng_a.close()
    assert _store_contents(eng_a.store) == _store_contents(eng_f.store)
    assert len(rep_a.results) == len(evs) and eng_a.refresher._inflight == []
    with pytest.raises(RuntimeError):            # close() stopped the refresh thread
        eng_a.refresher._pool.submit(lambda: None)


@pytest.mark.parametrize("refresh_every", [2, 4])
def test_lazy_cadence_keeps_scopes_equal(world, refresh_every):
    events, feat_dim = world
    cfg, params = _model(feat_dim)
    eng_f = _engine(params, cfg, community_local=False, refresh_every=refresh_every)
    eng_c = _engine(params, cfg, community_size=512, refresh_every=refresh_every)
    rep_f, rep_c = eng_f.replay(events), eng_c.replay(events)
    _assert_same_refresh(eng_f, rep_f, eng_c, rep_c)
    assert rep_c.staleness_summary()["stale_frac"] > 0.0


# ------------------------------------------------------------- stage-1 rows
def test_chunked_matmul_rows_do_not_depend_on_the_graph_size():
    """The card's row-stable product: chunks of a fixed row count, the last
    padded with zeros.  Its rows are the plain product's within f32
    rounding, and a row's bits are the same at every N (the same chunk
    shape every time)."""
    gen = torch.Generator().manual_seed(0)
    x, w, v = torch.randn(300, 12, generator=gen), torch.randn(12, 7, generator=gen), \
        torch.randn(12, generator=gen)
    for wt in (w, v):
        full = chunked_matmul(x, wt, 64)
        assert full.shape == (x @ wt).shape
        torch.testing.assert_close(full, x @ wt, atol=1e-5, rtol=1e-5)
        for n in (1, 63, 64, 65, 200):
            assert torch.equal(chunked_matmul(x[:n], wt, 64), full[:n])
    assert torch.equal(row_stable_matmul(x, w), x @ w)      # the CPU takes x @ w


@pytest.mark.parametrize("gnn_type", GNN_TYPES)
def test_community_stage1_rows_equal_whole_graph_rows(world, gnn_type):
    """Stage 1 as the refresh runs it, on one community's pow2-padded
    subgraph and on the whole graph: the same rows, bit for bit."""
    from repro_torch.stream import StreamIngester
    events, feat_dim = world
    cfg, params = _model(feat_dim, gnn_type, seed=1)
    ing = StreamIngester(feat_dim)
    for ev in events:
        ing.ingest(ev)
    full = ing.materialize()

    def stage1(coo):
        n = 64
        while n < coo.num_nodes:
            n *= 2
        with torch.no_grad():
            return lnn_stage1(params, cfg, pad_graph(coo, num_nodes=n, max_deg=32).to("cpu"),
                              mm=row_stable_matmul).numpy()

    h_full = stage1(full.coo)
    part = ing.partitioner
    for c in sorted({part.community_of(e) for e in part.assignment()})[:5]:
        sub = ing.materialize_communities([c])
        h_sub = stage1(sub.coo)
        for pair, nid in sub.entity_snap_ids.items():
            np.testing.assert_array_equal(h_sub[nid], h_full[full.entity_snap_ids[pair]])


# ------------------------------------------------------------- monolithic
def test_replay_matches_monolithic_forward(world, single):
    """Ingest -> refresh -> micro-batched scoring against the port's own
    ``lnn_forward`` over the whole materialized graph."""
    events, _ = world
    cfg, params, eng, rep = single
    assert len(rep.results) == len(events)
    pg = pad_graph(eng.ingester.materialize().coo, max_deg=32).to("cpu")
    with torch.no_grad():
        full = host_sigmoid(lnn_forward(params, cfg, pg).numpy())
    scores = rep.scores_by_order()
    # the builder's order id is the position in the event stream
    err = max(abs(scores[ev.order_id] - full[i]) for i, ev in enumerate(events))
    assert err < MONOLITHIC_TOL, err
    assert rep.staleness_summary()["max"] == 0
    assert eng.store.stats["misses"] == 0
