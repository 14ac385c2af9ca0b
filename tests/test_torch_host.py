"""The port's host code (numpy: synthetic data, partition, DDS build,
padding, sharding, KV store) is array-equal to the reference's for the
same seed and inputs."""
import numpy as np
import pytest

import repro.core.dds as ref_dds
import repro.core.graph as ref_graph
import repro.core.hetero as ref_hetero
import repro.core.partition as ref_partition
import repro.data.pipeline as ref_pipeline
import repro.data.synth as ref_synth
import repro.dist.sharding as ref_sharding
import repro.serve.kvstore as ref_kv
import repro_torch.core.dds as dds
import repro_torch.core.graph as graph
import repro_torch.core.hetero as hetero
import repro_torch.core.partition as partition
import repro_torch.data.pipeline as pipeline
import repro_torch.data.synth as synth
import repro_torch.dist.sharding as sharding
import repro_torch.serve.kvstore as kv

SYNTH = dict(num_users=150, num_rings=4, feature_noise=0.8, seed=7)


def _assert_same(a, b, path="root"):
    """Deep equality over dataclasses, dicts, lists and arrays."""
    if hasattr(a, "__dataclass_fields__"):
        assert type(a).__name__ == type(b).__name__, path
        for f in a.__dataclass_fields__:
            _assert_same(getattr(a, f), getattr(b, f), f"{path}.{f}")
    elif isinstance(a, tuple) and hasattr(a, "_fields"):
        for f in a._fields:
            _assert_same(getattr(a, f), getattr(b, f), f"{path}.{f}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
    else:
        assert a == b, path


def _static_pair(seed=7, **kw):
    cfg = dict(SYNTH, seed=seed, **kw)
    g_ref, et_ref = ref_synth.generate_transactions(ref_synth.SynthConfig(**cfg))
    g, et = synth.generate_transactions(synth.SynthConfig(**cfg))
    return (g_ref, et_ref), (g, et)


@pytest.mark.parametrize("seed", [0, 7])
def test_generate_transactions_equal(seed):
    (g_ref, et_ref), (g, et) = _static_pair(seed)
    _assert_same(g_ref, g)
    np.testing.assert_array_equal(et_ref, et)


def test_split_masks_and_standardize_equal():
    (g_ref, _), (g, _) = _static_pair()
    split_ref = ref_pipeline.make_split_masks(g_ref.order_snapshot)
    split = pipeline.make_split_masks(g.order_snapshot)
    np.testing.assert_array_equal(split_ref, split)
    f_ref, stats_ref = ref_pipeline.standardize_features(g_ref.order_features, split_ref == 0)
    f, stats = pipeline.standardize_features(g.order_features, split == 0)
    np.testing.assert_array_equal(f_ref, f)
    _assert_same(list(stats_ref), list(stats))


@pytest.mark.parametrize("community_size", [64, 128])
def test_partition_equal(community_size):
    (g_ref, _), (g, _) = _static_pair()
    np.testing.assert_array_equal(
        ref_partition.partition_transactions(g_ref.num_orders, g_ref.num_entities,
                                             g_ref.edges, community_size=community_size),
        partition.partition_transactions(g.num_orders, g.num_entities, g.edges,
                                         community_size=community_size))


@pytest.mark.parametrize("history,max_history", [("all", None), ("all", 4),
                                                 ("consecutive", None)])
def test_build_dds_and_pad_graph_equal(history, max_history):
    (g_ref, _), (g, _) = _static_pair()
    d_ref = ref_dds.build_dds(g_ref, history, max_history)
    d = dds.build_dds(g, history, max_history)
    _assert_same(d_ref.coo, d.coo)
    assert d_ref.entity_snap_ids == d.entity_snap_ids
    assert d_ref.last_hop == d.last_hop
    dds.check_no_future_leak(d)
    for max_deg in (None, 8):
        for policy in ("recent", "first"):
            _assert_same(ref_graph.pad_graph(d_ref.coo, max_deg=max_deg,
                                             deg_cap_policy=policy),
                         graph.pad_graph(d.coo, max_deg=max_deg, deg_cap_policy=policy))


def test_build_communities_equal(small_fraud_dataset):
    g_ref, _, _ = small_fraud_dataset
    g = dds.StaticGraph(**{f: getattr(g_ref, f) for f in g_ref.__dataclass_fields__})
    b_ref = ref_pipeline.build_communities(g_ref, community_size=128, max_deg=16)
    b = pipeline.build_communities(g, community_size=128, max_deg=16)
    assert len(b_ref) == len(b) > 1
    for x, y in zip(b_ref, b):
        _assert_same(x.graph, y.graph)
        np.testing.assert_array_equal(x.global_order_ids, y.global_order_ids)
        np.testing.assert_array_equal(x.global_entity_ids, y.global_entity_ids)
        assert x.dds.entity_snap_ids == y.dds.entity_snap_ids
        assert x.dds.last_hop == y.dds.last_hop


def test_incremental_dds_builder_equal():
    """The streaming builder, fed the same orders in event-time order,
    builds the same graph as the reference's and as the port's batch build."""
    (g_ref, _), _ = _static_pair()
    order = np.argsort(g_ref.order_snapshot, kind="stable")
    ents = [[] for _ in range(g_ref.num_orders)]
    for o, e in g_ref.edges:
        ents[o].append(int(e))
    builders = (ref_dds.IncrementalDDSBuilder(g_ref.order_features.shape[1], "all", 4),
                dds.IncrementalDDSBuilder(g_ref.order_features.shape[1], "all", 4))
    for o in order:
        for b in builders:
            b.add_order(ents[o], int(g_ref.order_snapshot[o]),
                        g_ref.order_features[o], float(g_ref.labels[o]))
    d_ref, d = (b.build() for b in builders)
    _assert_same(d_ref.coo, d.coo)
    assert d_ref.last_hop == d.last_hop
    batch = dds.build_dds(builders[1].to_static(), "all", 4)
    _assert_same(graph.pad_graph(batch.coo, max_deg=16), graph.pad_graph(d.coo, max_deg=16))
    assert builders[0].entity_keys(ents[order[-1]], 40) == \
        builders[1].entity_keys(ents[order[-1]], 40)


def test_typed_graph_tower_codes_equal():
    """Type-tagged entity ids give the typed graph its tower codes."""
    raw = np.asarray([3, 8, 11, 20])
    tagged = np.asarray([hetero.tag_entity(int(r), i % 4) for i, r in enumerate(raw)])
    np.testing.assert_array_equal(ref_hetero.type_codes_array(tagged),
                                  hetero.type_codes_array(tagged))
    g = ref_synth.generate_transactions(ref_synth.SynthConfig(**SYNTH))[0]
    typed_ids = [hetero.tag_entity(e, int(t) % 4) for e, t in enumerate(g.entity_type)]
    builders = (ref_dds.IncrementalDDSBuilder(g.order_features.shape[1]),
                dds.IncrementalDDSBuilder(g.order_features.shape[1]))
    for o in np.argsort(g.order_snapshot, kind="stable")[:200]:
        es = [typed_ids[e] for e in g.edges[g.edges[:, 0] == o, 1]]
        for b in builders:
            b.add_order(es, int(g.order_snapshot[o]), g.order_features[o])
    d_ref, d = (b.build() for b in builders)
    assert d.coo.tower is not None and (d.coo.tower >= 0).any()
    _assert_same(d_ref.coo, d.coo)
    _assert_same(ref_graph.pad_graph(d_ref.coo), graph.pad_graph(d.coo))


def test_sharding_hashes_equal():
    rng = np.random.default_rng(0)
    keys = [0, 1, 2**20, 2**40 + 5, 2**62 + 3] + [int(k) for k in rng.integers(0, 2**62, 200)]
    for k in keys:
        assert sharding.splitmix64(k) == ref_sharding.splitmix64(k)
        for n in (1, 3, 8):
            assert sharding.stable_shard(k, n) == ref_sharding.stable_shard(k, n)
            assert sharding.rendezvous_shard(k, n) == ref_sharding.rendezvous_shard(k, n)


def test_pack_key_and_entity_shard_equal():
    for e in (0, 5, 2**30, kv.MAX_ENTITY):
        for t in (0, 3, kv.MAX_SNAPSHOT):
            assert kv.pack_key(e, t) == ref_kv.pack_key(e, t)
            assert kv.unpack_key(kv.pack_key(e, t)) == (e, t)
        assert kv.entity_shard(e, 5) == ref_kv.entity_shard(e, 5)
    for bad in ((kv.MAX_ENTITY + 1, 0), (0, kv.MAX_SNAPSHOT + 1), (-1, 0)):
        with pytest.raises(ValueError):
            kv.pack_key(*bad)
    with pytest.raises(ValueError, match="no type tag"):
        kv.pack_key(9, 3, require_typed=True)


@pytest.mark.parametrize("num_shards,shard_by_entity", [(1, False), (4, False), (4, True)])
def test_kvstore_lookups_equal(num_shards, shard_by_entity, tmp_path):
    rng = np.random.default_rng(num_shards)
    stores = [mod.KVStore(4, capacity=40, num_shards=num_shards,
                          shard_by_entity=shard_by_entity, clock=lambda: 0.0)
              for mod in (ref_kv, kv)]
    keys = [(int(e), int(t)) for e, t in rng.integers(0, 20, (60, 2))]
    vals = rng.normal(size=(60, 4)).astype(np.float32)
    for s, mod in zip(stores, (ref_kv, kv)):
        s.put_batch([mod.pack_key(e, t) for e, t in keys], vals, version=2)
    queries = [[(int(e), int(t)) for e, t in rng.integers(0, 22, (5, 2))] for _ in range(8)]
    out = []
    for s, mod in zip(stores, (ref_kv, kv)):
        exact = s.lookup_batch([[mod.pack_key(e, t) for e, t in q] for q in queries], 4)
        versioned = s.lookup_batch_versioned(queries, 4)
        out.append((exact, versioned, s.stats, sorted(s.keys())))
    _assert_same(out[0], out[1])
    stores[1].save(str(tmp_path / "kv.npz"))
    back = kv.KVStore.load(str(tmp_path / "kv.npz"), num_shards=num_shards)
    assert sorted(back.keys()) == sorted(stores[1].keys())
