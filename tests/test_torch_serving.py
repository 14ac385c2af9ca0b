"""The port's Lambda slice as a whole, on the CPU: ``BatchLayer.refresh``
fills the KV store, ``SpeedLayer.score`` scores checkouts from it, and both
agree with the reference's layers run with the same parameters (1e-5: f32
on both sides, summed in a different order).  The port's
``split_equivalence_check`` holds at the reference's 1e-4."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core as R
import repro.serve as RS
from repro.serve.kvstore import pack_key
from repro_torch.core import LNNConfig, PaddedGraph
from repro_torch.params import from_numpy
from repro_torch.serve import (BatchLayer, KVStore, SpeedLayer, history_requests,
                               host_sigmoid, split_equivalence_check)

GNN_TYPES = ["gcn", "gat", "sage"]


def _port_batches(batches):
    """Reference community batches with their graphs as the port's type."""
    return [dataclasses.replace(b, graph=PaddedGraph(*b.graph)) for b in batches]


@pytest.fixture(scope="module", params=GNN_TYPES)
def served(request, small_communities):
    """Reference and port layers over one parameter set, both refreshed."""
    feat_dim = small_communities[0].graph.features.shape[1]
    ref_cfg = R.LNNConfig(gnn_type=request.param, num_gnn_layers=3, hidden_dim=32,
                          feat_dim=feat_dim)
    params = R.lnn_init(jax.random.PRNGKey(2), ref_cfg)
    ref_store = RS.KVStore(ref_cfg.hidden_dim)
    RS.BatchLayer(params, ref_cfg, ref_store).refresh(small_communities)
    ref_speed = RS.SpeedLayer(params, ref_cfg, ref_store, k_max=16)

    cfg = LNNConfig(**{f.name: getattr(ref_cfg, f.name)
                       for f in dataclasses.fields(LNNConfig)})
    tparams = from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    store = KVStore(cfg.hidden_dim)
    batches = _port_batches(small_communities)
    stats = BatchLayer(tparams, cfg, store, device="cpu").refresh(batches)
    speed = SpeedLayer(tparams, cfg, store, k_max=16, device="cpu")
    return dict(ref_store=ref_store, ref_speed=ref_speed, store=store, speed=speed,
                stats=stats, cfg=cfg, params=tparams, batches=batches)


def test_refresh_writes_the_reference_embeddings(served):
    ref_store, store = served["ref_store"], served["store"]
    assert served["stats"]["entities_written"] == len(ref_store) == len(store) > 0
    assert sorted(store.keys()) == sorted(ref_store.keys())
    for key in sorted(store.keys())[::7]:
        np.testing.assert_allclose(store.get(key), ref_store.get(key),
                                   atol=1e-5, rtol=1e-5)


def test_scores_match_reference_speed_layer(served, small_communities):
    ref_requests = RS.history_requests(small_communities)
    requests = history_requests(served["batches"])
    assert len(requests) == len(ref_requests) > 16
    for lo in range(0, len(requests), 16):
        chunk, ref_chunk = requests[lo:lo + 16], ref_requests[lo:lo + 16]
        assert [r.entity_keys for r in chunk] == [r.entity_keys for r in ref_chunk]
        got = served["speed"].score(chunk)
        assert got.dtype == np.float32 and got.shape == (len(chunk),)
        np.testing.assert_allclose(got, served["ref_speed"].score(ref_chunk),
                                   atol=1e-5, rtol=1e-5)


def test_split_equivalence_holds(served):
    worst = split_equivalence_check(served["speed"].score, served["params"],
                                    served["cfg"], served["batches"], atol=1e-4,
                                    device="cpu")
    assert 0.0 <= worst < 1e-4


def test_equivalence_check_detects_a_wrong_scorer(served):
    with pytest.raises(AssertionError, match="lambda split mismatch"):
        split_equivalence_check(lambda reqs: np.zeros(len(reqs), np.float32),
                                served["params"], served["cfg"], served["batches"],
                                device="cpu")


def test_speed_layer_handles_cold_entities_and_dicts(served):
    """Orders whose entities were never refreshed still score (self tower
    only), and the dict spelling of a request is accepted."""
    cfg = served["cfg"]
    speed = SpeedLayer(served["params"], cfg, KVStore(cfg.hidden_dim), device="cpu")
    out = speed.score([{"features": np.zeros(cfg.feat_dim, np.float32),
                        "entity_keys": [(1, 2), (3, 4)]}])
    assert out.shape == (1,) and np.isfinite(out).all()
    ref = served["ref_speed"]
    ref_cold = RS.SpeedLayer(ref.params, ref.cfg, RS.KVStore(cfg.hidden_dim))
    np.testing.assert_allclose(
        out, ref_cold.score([{"features": np.zeros(cfg.feat_dim, np.float32),
                              "entity_keys": [(1, 2), (3, 4)]}]), atol=1e-5)
    assert served["store"].get(pack_key(10**9, 0)) is None


def test_layers_without_a_device_need_cuda(served, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, store = served["cfg"], served["store"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchLayer(served["params"], cfg, store)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpeedLayer(served["params"], cfg, store)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        split_equivalence_check(served["speed"].score, served["params"], cfg,
                                served["batches"])


def test_host_sigmoid_is_element_deterministic():
    """A request's probability does not depend on the batch around it."""
    x = np.random.default_rng(0).normal(size=37).astype(np.float32) * 8
    full = host_sigmoid(x)
    assert full.dtype == np.float32
    for n in (1, 2, 4, 5, 16):
        np.testing.assert_array_equal(host_sigmoid(x[:n]), full[:n])
    np.testing.assert_allclose(full, 1 / (1 + np.exp(-x.astype(np.float64))), rtol=1e-7)


def test_speed_layer_pack_built_once_gives_the_same_scores(served):
    """The weights packed once at construction score exactly as packing them
    on every call does, and replacing the params repacks them."""
    cfg, store, params = served["cfg"], served["store"], served["params"]
    requests = history_requests(served["batches"])[:16]
    speed = SpeedLayer(params, cfg, store, k_max=16, device="cpu")
    assert speed.pack is not None
    per_call = SpeedLayer(params, cfg, store, k_max=16, device="cpu")
    per_call.pack = None
    np.testing.assert_array_equal(speed.score(requests), per_call.score(requests))
    speed.params = {**params, "mlp": [{"w": 2 * lyr["w"], "b": lyr["b"]} for lyr in params["mlp"]]}
    fresh = SpeedLayer(speed.params, cfg, store, k_max=16, device="cpu")
    np.testing.assert_array_equal(speed.score(requests), fresh.score(requests))
    assert not np.array_equal(speed.score(requests), per_call.score(requests))


def test_set_model_restamps_refresh_and_repacks_scores(served):
    """``set_model`` as the reference's: a refresh after
    ``BatchLayer.set_model`` stamps the new version on the store's entries,
    and ``SpeedLayer.set_model`` repacks, so its scores equal those of a
    fresh layer built on the new weights."""
    cfg, params = served["cfg"], served["params"]
    params_b = {**params, "mlp": [{"w": 2 * lyr["w"], "b": lyr["b"] + 0.5}
                                  for lyr in params["mlp"]]}
    store = KVStore(cfg.hidden_dim)
    batch = BatchLayer(params, cfg, store, device="cpu")
    batch.refresh(served["batches"][:1])
    assert {e[4] for shard in store.shard_items() for e in shard} == {0}
    batch.set_model(params_b, 7)
    assert batch.params is params_b and batch.model_version == 7
    batch.refresh(served["batches"][:1])
    assert {e[4] for shard in store.shard_items() for e in shard} == {7}

    requests = history_requests(served["batches"])[:16]
    speed = SpeedLayer(params, cfg, store, k_max=16, device="cpu")
    assert speed.model_version == 0
    before = speed.score(requests)
    old_pack = speed.pack
    speed.set_model(params_b, 7)
    assert speed.model_version == 7 and speed.params is params_b
    assert speed.pack is not old_pack
    fresh = SpeedLayer(params_b, cfg, store, k_max=16, device="cpu")
    np.testing.assert_array_equal(speed.score(requests), fresh.score(requests))
    assert not np.array_equal(speed.score(requests), before)
