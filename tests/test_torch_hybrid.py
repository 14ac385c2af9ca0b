"""The port's hybrid GNN -> GBDT head (``repro_torch.models.hybrid``) on the
CPU: ``train_hybrid`` on the same embeddings grows the reference's trees
and gives its probabilities; a hybrid file either package writes, the
other loads; the embedding is within 1e-5 of the reference's and a row's
bits do not depend on its batch; a hybrid service replays bit for bit at
one and at four workers; and a typed hybrid service restores from its
WAL and checkpoint bit for bit (the reference's ladder rung 7)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core as R
import repro.models.hybrid as RH
from repro_torch.core import ENTITY_TYPE_NAMES, LNNConfig, lnn_init, lnn_stage2_embed
from repro_torch.data import AttackConfig, generate_attack_stream
from repro_torch.models.hybrid import (EMBED_ROWS, HybridModel, embed_rows,
                                       is_hybrid_checkpoint, load_hybrid, save_hybrid,
                                       train_hybrid)
from repro_torch.params import flatten_paths, from_numpy, to_numpy
from repro_torch.service import FraudService, ModelSection, ServiceConfig
from repro_torch.stream import CheckoutEvent
from repro_torch.train.checkpoint import save_checkpoint

TOL = dict(atol=1e-5, rtol=1e-5)
_TINY = AttackConfig(num_buyers=25, num_merchants=6, num_rings=2, ring_size=4, ring_pool=2,
                     num_bursts=1, burst_orders=6, num_bin_runs=1, bin_cards=5,
                     num_snapshots=6)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: many small products, and under several test
    workers torch's default of a thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_cfg(gnn="gcn", typed=True, feat_dim=4):
    return R.LNNConfig(gnn_type=gnn, num_gnn_layers=2, hidden_dim=8, mlp_dims=(8,),
                       feat_dim=feat_dim, entity_types=ENTITY_TYPE_NAMES if typed else ())


def _port(ref_cfg, ref_params):
    cfg = LNNConfig(**{f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(LNNConfig)})
    return cfg, from_numpy(jax.tree_util.tree_map(np.asarray, ref_params), "cpu")


def _embeddings(n=64, dim=12, seed=2):
    x = np.random.default_rng(seed).normal(size=(n, dim)).astype(np.float32)
    return x, (x[:, 0] + 0.5 * x[:, 3] > 0).astype(np.float64)


def test_train_hybrid_grows_the_reference_trees():
    ref_cfg = _ref_cfg()
    ref_params = R.lnn_init(jax.random.PRNGKey(1), ref_cfg)
    cfg, params = _port(ref_cfg, ref_params)
    x, y = _embeddings()
    ref = RH.train_hybrid(ref_params, ref_cfg, x, y)
    hy = train_hybrid(params, cfg, x, y, device="cpu")
    assert isinstance(hy, HybridModel) and hy.gbdt.base_score == ref.gbdt.base_score
    assert len(hy.gbdt.trees) == len(ref.gbdt.trees) > 0
    for a, b in zip(hy.gbdt.trees, ref.gbdt.trees):
        for f in ("feature", "threshold_bin", "left", "right", "value"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for a, b in zip(hy.gbdt.bin_edges, ref.gbdt.bin_edges):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(hy.gbdt.predict_proba(x), ref.gbdt.predict_proba(x))


def test_save_load_roundtrip_and_files_cross_packages(tmp_path):
    ref_cfg = _ref_cfg()
    ref_params = R.lnn_init(jax.random.PRNGKey(1), ref_cfg)
    cfg, params = _port(ref_cfg, ref_params)
    x, y = _embeddings()
    hy = train_hybrid(params, cfg, x, y, device="cpu")
    want = hy.gbdt.predict_proba(x)
    path, ref_path = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    save_hybrid(path, hy)
    RH.save_hybrid(ref_path, RH.train_hybrid(ref_params, ref_cfg, x, y))
    template = lnn_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    for p in (path, ref_path):
        assert is_hybrid_checkpoint(p) and RH.is_hybrid_checkpoint(p)
        back = load_hybrid(p, template, cfg)
        np.testing.assert_array_equal(back.gbdt.predict_proba(x), want)
        got, want_leaves = dict(flatten_paths(back.lnn_params)), dict(flatten_paths(params))
        assert got.keys() == want_leaves.keys()
        for key, a in got.items():
            assert a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), want_leaves[key].numpy())
    ref_back = RH.load_hybrid(path, ref_params, ref_cfg)      # the port's file in the reference
    np.testing.assert_array_equal(ref_back.gbdt.predict_proba(x), want)
    for a, b in zip(jax.tree_util.tree_leaves(ref_back.lnn_params),
                    jax.tree_util.tree_leaves(ref_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    plain = str(tmp_path / "plain.npz")
    save_checkpoint(plain, params)
    assert not is_hybrid_checkpoint(plain)


@pytest.mark.parametrize("gnn", ["gcn", "gat", "sage"])
@pytest.mark.parametrize("typed", [False, True])
def test_embedding_matches_reference_and_rows_keep_their_bits(gnn, typed):
    """``embed_rows`` within 1e-5 of the reference's ``lnn_stage2_embed``,
    and each row's bits the same at B=2, B=3 and in a batch of 2 x
    EMBED_ROWS + 5 rows."""
    ref_cfg = _ref_cfg(gnn, typed)
    ref_params = R.lnn_init(jax.random.PRNGKey(3), ref_cfg)
    cfg, params = _port(ref_cfg, ref_params)
    rng = np.random.default_rng(4)
    b, k = 2 * EMBED_ROWS + 5, 6
    emb = rng.normal(size=(b, k, 8)).astype(np.float32)
    mask = (rng.uniform(size=(b, k)) > 0.3).astype(np.float32)
    mask[1] = 0.0                       # a row with every slot masked
    feats = rng.normal(size=(b, 4)).astype(np.float32)
    st = np.where(mask > 0, rng.integers(0, 4, (b, k)), -1).astype(np.int32) if typed else None
    t = [torch.from_numpy(a) for a in (emb, mask, feats)]
    ts = None if st is None else torch.from_numpy(st)
    got = embed_rows(params, cfg, *t, slot_type=ts)
    want = np.asarray(R.lnn_stage2_embed(ref_params, ref_cfg, emb, mask, feats, slot_type=st))
    assert got.shape == (b, 8 + 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    for lo, hi in ((0, 2), (3, 6), (17, 19)):
        part = embed_rows(params, cfg, *(a[lo:hi] for a in t),
                          slot_type=None if ts is None else ts[lo:hi])
        np.testing.assert_array_equal(part, got[lo:hi])
    with torch.no_grad():                # the unchunked embedding agrees too
        np.testing.assert_allclose(lnn_stage2_embed(params, cfg, *t, slot_type=ts).numpy(),
                                   got, **TOL)


@pytest.fixture(scope="module")
def attack_world():
    events, _ = generate_attack_stream(_TINY)
    return events


def _service(cfg, params, num_workers=1):
    sc = ServiceConfig(mode="streaming", model=ModelSection.from_lnn_config(cfg)).replace(
        engine={"max_batch": 4, "num_workers": num_workers})
    return FraudService(sc, params, device="cpu").build()


def _hybrid_from_first_half(svc, cfg, params, events):
    """The reference test's recipe: stage-2 embeddings of the served half's
    requests, read back from the live store, train the booster."""
    eng = svc.engine
    key_lists = [eng.ingester.builder.entity_keys(ev.entities, ev.snapshot) for ev in events]
    emb, mask, _ = svc.store.lookup_batch_versioned(key_lists, svc.config.engine.k_max)
    st = eng.pool.workers[0].scorer._slot_types(key_lists) if cfg.entity_types else None
    feats = np.stack([ev.features for ev in events]).astype(np.float32)
    x = embed_rows(params, cfg, torch.from_numpy(emb), torch.from_numpy(mask),
                   torch.from_numpy(feats), None if st is None else torch.from_numpy(st))
    return train_hybrid(params, cfg, x, np.asarray([ev.label for ev in events]), device="cpu")


@pytest.mark.parametrize("gnn", ["gcn", "gat", "sage"])
def test_hybrid_replay_bit_identical_at_any_worker_count(attack_world, gnn):
    events = attack_world
    cfg = LNNConfig(gnn_type=gnn, num_gnn_layers=2, hidden_dim=8, mlp_dims=(8,),
                    feat_dim=events[0].features.shape[0], entity_types=ENTITY_TYPE_NAMES)
    params = lnn_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    half = len(events) // 2
    trainer = _service(cfg, params)
    trainer.replay(events[:half])
    hy = _hybrid_from_first_half(trainer, cfg, params, events[:half])
    scores = {}
    for n in (1, 4):
        svc = _service(cfg, hy, num_workers=n)
        rep = svc.replay(events)
        assert {r.model_version for r in rep.results} == {0}
        scores[n] = rep.scores_by_order()
        if n == 4:
            assert sum(w["requests"] > 0 for w in svc.stats().workers) >= 2
    assert scores[4] == scores[1] and len(scores[1]) == len(events)
    assert all(0.0 <= s <= 1.0 for s in scores[1].values())


def test_hybrid_is_refused_in_batch_mode():
    cfg = LNNConfig(num_gnn_layers=2, hidden_dim=8, mlp_dims=(8,), feat_dim=4)
    params = lnn_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    x, y = _embeddings(dim=12)
    hy = train_hybrid(params, cfg, x, y, device="cpu")
    sc = ServiceConfig(mode="batch", model=ModelSection.from_lnn_config(cfg))
    with pytest.raises(Exception, match="streaming"):
        FraudService(sc, hy, device="cpu").build()


def test_typed_hybrid_wal_checkpoint_restore_bit_identical(attack_world, tmp_path):
    """Typed entity ids survive the WAL event codec and checkpointing: a
    restored service scores probe traffic bit for bit as the one it was
    restored from, with the hybrid registered before the crash active."""
    events = attack_world
    cfg = LNNConfig(gnn_type="gat", num_gnn_layers=2, hidden_dim=8, mlp_dims=(8,),
                    feat_dim=events[0].features.shape[0], entity_types=ENTITY_TYPE_NAMES)
    params = lnn_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    svc = _service(cfg, params)
    svc.enable_wal(str(tmp_path))
    half = len(events) // 2
    svc.replay(events[:half])
    hy = _hybrid_from_first_half(svc, cfg, params, events[:half])
    svc.activate_model(svc.register_model(hy, version=1))
    svc.checkpoint()
    svc.replay(events[half:], warmup=False)

    restored = FraudService.restore(str(tmp_path), device="cpu")
    assert restored.model_version == 1
    assert isinstance(restored.model_params(1), HybridModel)
    np.testing.assert_array_equal(
        to_numpy(restored.model_params(1).lnn_params)["last"]["w"],
        to_numpy(hy.lnn_params)["last"]["w"])
    probes = [CheckoutEvent(order_id=90_000 + i, snapshot=_TINY.num_snapshots,
                            entities=ev.entities, features=ev.features, label=ev.label,
                            arrival=events[-1].arrival + 1.0 + i)
              for i, ev in enumerate(events[-6:])]
    s1 = svc.replay(probes, warmup=False).scores_by_order()
    s2 = restored.replay(probes, warmup=False).scores_by_order()
    assert s1 == s2 and len(s1) == 6
    svc.close()
    restored.close()
