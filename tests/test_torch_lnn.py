"""The port's LNN (stage 1, stage 2, forward) against the reference with the
same parameters, which cross from ``repro.core.lnn_init`` through numpy and
``repro_torch.params.from_numpy``.  The reference runs its Pallas kernels
in interpret mode (``use_pallas=True``); the port runs its plain CPU path.
Tolerance 1e-5: f32 on both sides, summed in a different order.  Also the
reference's ladder rungs rebuilt on the port, and the parameter files."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core.dds import IncrementalDDSBuilder
from repro.core.hetero import ENTITY_TYPE_NAMES, tag_entity
from repro.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch import params as P
from repro_torch.core import (LNNConfig, PaddedGraph, lnn_forward, lnn_init,
                              lnn_order_tower, lnn_stage1, lnn_stage2_batch,
                              lnn_stage2_embed, lnn_stage2_online, pad_graph)

GNN_TYPES = ["gcn", "gat", "sage"]
TOL = dict(atol=1e-5, rtol=1e-5)


def _port_cfg(ref_cfg):
    kw = {f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(LNNConfig)}
    return LNNConfig(**kw)


def _to_port(params):
    return P.from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")


def _cpu(graph):
    """A reference PaddedGraph (numpy fields) as the port's, on the CPU."""
    return PaddedGraph(*graph).to("cpu")


@pytest.fixture(scope="module", params=GNN_TYPES)
def models(request, small_communities):
    feat_dim = small_communities[0].graph.features.shape[1]
    ref_cfg = R.LNNConfig(gnn_type=request.param, num_gnn_layers=3, hidden_dim=32,
                          feat_dim=feat_dim, use_pallas=True)
    params = R.lnn_init(jax.random.PRNGKey(0), ref_cfg)
    return ref_cfg, params, _port_cfg(ref_cfg), _to_port(params)


def test_stage1_matches_reference(models, small_communities):
    ref_cfg, params, cfg, tparams = models
    for b in small_communities[:2]:
        want = np.asarray(R.lnn_stage1(params, ref_cfg, b.graph))
        got = lnn_stage1(tparams, cfg, _cpu(b.graph)).numpy()
        np.testing.assert_allclose(got, want, **TOL)


def test_forward_and_stage2_batch_match_reference(models, small_communities):
    ref_cfg, params, cfg, tparams = models
    for b in small_communities[:2]:
        g = _cpu(b.graph)
        want = np.asarray(R.lnn_forward(params, ref_cfg, b.graph))
        np.testing.assert_allclose(lnn_forward(tparams, cfg, g).numpy(), want, **TOL)
        h = np.array(R.lnn_stage1(params, ref_cfg, b.graph))
        want_b = np.asarray(R.lnn_stage2_batch(params, ref_cfg, jnp.asarray(h), b.graph))
        got_b = lnn_stage2_batch(tparams, cfg, torch.from_numpy(h), g).numpy()
        np.testing.assert_allclose(got_b, want_b, **TOL)


def test_stage2_online_and_embed_match_reference(models):
    ref_cfg, params, cfg, tparams = models
    rng = np.random.default_rng(3)
    b, k = 9, 8
    mask = (rng.uniform(size=(b, k)) < 0.6).astype(np.float32)
    mask[4] = 0.0
    emb = rng.normal(size=(b, k, cfg.hidden_dim)).astype(np.float32) * mask[..., None]
    feats = rng.normal(size=(b, cfg.feat_dim)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (emb, mask, feats)]
    want = np.asarray(R.lnn_stage2_online(params, ref_cfg, emb, mask, feats))
    np.testing.assert_allclose(lnn_stage2_online(tparams, cfg, *t).numpy(), want, **TOL)
    want_e = np.asarray(R.lnn_stage2_embed(params, ref_cfg, emb, mask, feats))
    np.testing.assert_allclose(lnn_stage2_embed(tparams, cfg, *t).numpy(), want_e, **TOL)


@pytest.mark.parametrize("gnn_type", GNN_TYPES)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_stage2_online_positional_order_h_and_slot_type(gnn_type, use_pallas):
    """The same positional call ``(params, cfg, emb, mask, feats, order_h,
    slot_type)`` means the same in both packages: a typed model, with the
    order's state from ``lnn_order_tower`` in the sixth place.  The
    reference reads it on its XLA path and recomputes it on its Pallas
    path; the port always recomputes it."""
    ref_cfg = R.LNNConfig(gnn_type=gnn_type, num_gnn_layers=2, hidden_dim=16,
                          mlp_dims=(16,), feat_dim=12, entity_types=ENTITY_TYPE_NAMES,
                          use_pallas=use_pallas)
    params = R.lnn_init(jax.random.PRNGKey(4), ref_cfg)
    rng = np.random.default_rng(5)
    b, k = 7, 8
    mask = (rng.uniform(size=(b, k)) < 0.7).astype(np.float32)
    mask[2] = 0.0
    emb = rng.normal(size=(b, k, 16)).astype(np.float32) * mask[..., None]
    feats = rng.normal(size=(b, 12)).astype(np.float32)
    slot_type = np.where(mask > 0, rng.integers(0, len(ENTITY_TYPE_NAMES), (b, k)),
                         -1).astype(np.int32)
    order_h = R.lnn_order_tower(params, ref_cfg, jnp.asarray(feats))
    want = np.asarray(R.lnn_stage2_online(params, ref_cfg, emb, mask, feats, order_h,
                                          jnp.asarray(slot_type)))
    cfg, tparams = _port_cfg(ref_cfg), _to_port(params)
    got = lnn_stage2_online(tparams, cfg, *(torch.from_numpy(a) for a in (emb, mask, feats)),
                            torch.from_numpy(np.array(order_h)),
                            torch.from_numpy(slot_type))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_order_tower_matches_stage1(models, small_communities):
    """Ladder rung: an order's stage-1 state is recomputable from its raw
    features alone (final-hop edges are excluded from stage 1)."""
    _, _, cfg, tparams = models
    for b in small_communities[:3]:
        n_orders = b.global_order_ids.size
        h = lnn_stage1(tparams, cfg, _cpu(b.graph))
        tower = lnn_order_tower(tparams, cfg, torch.from_numpy(b.graph.features[:n_orders]))
        np.testing.assert_allclose(tower.numpy(), h[:n_orders].numpy(), atol=1e-6)


def test_online_path_matches_batch_path(models, small_communities):
    """Ladder rung: KV-style lookups + online stage 2 equal the batch
    stage 2 over the whole graph."""
    _, _, cfg, tparams = models
    for b in small_communities[:3]:
        n_orders = b.global_order_ids.size
        g = _cpu(b.graph)
        h = lnn_stage1(tparams, cfg, g)
        full = lnn_stage2_batch(tparams, cfg, h, g).numpy()
        k = int(b.graph.max_deg)
        emb = np.zeros((n_orders, k, cfg.hidden_dim), np.float32)
        msk = np.zeros((n_orders, k), np.float32)
        for o, hops in b.dds.last_hop.items():
            for j, (_, _, nid) in enumerate(hops[:k]):
                emb[o, j] = h[nid].numpy()
                msk[o, j] = 1.0
        online = lnn_stage2_online(tparams, cfg, torch.from_numpy(emb),
                                   torch.from_numpy(msk), g.features[:n_orders])
        np.testing.assert_allclose(online.numpy(), full[:n_orders], atol=1e-5)


def test_padding_rows_do_not_affect_scores(models, small_communities):
    _, _, cfg, tparams = models
    b = small_communities[0]
    n_real = b.dds.coo.num_nodes
    s1, s2 = (lnn_forward(tparams, cfg, pad_graph(b.dds.coo, num_nodes=n_real + pad,
                                                   max_deg=b.graph.max_deg).to("cpu"))
              .numpy()[:n_real] for pad in (8, 64))
    np.testing.assert_allclose(s1, s2, atol=1e-6)


@pytest.mark.parametrize("gnn_type", GNN_TYPES)
def test_typed_forward_matches_reference(gnn_type, small_fraud_dataset):
    """Heterogeneous model on a typed graph: stage-1 type embeddings and the
    per-type stage-2 towers."""
    g, _, _ = small_fraud_dataset
    typed_ids = [tag_entity(e, int(t) % len(ENTITY_TYPE_NAMES))
                 for e, t in enumerate(g.entity_type)]
    builder = IncrementalDDSBuilder(g.order_features.shape[1])
    for o in np.argsort(g.order_snapshot, kind="stable")[:150]:
        builder.add_order([typed_ids[e] for e in g.edges[g.edges[:, 0] == o, 1]],
                          int(g.order_snapshot[o]), g.order_features[o])
    graph = R.pad_graph(builder.build().coo, max_deg=16)
    assert graph.tower is not None
    ref_cfg = R.LNNConfig(gnn_type=gnn_type, num_gnn_layers=2, hidden_dim=16,
                          mlp_dims=(16,), feat_dim=graph.features.shape[1],
                          entity_types=ENTITY_TYPE_NAMES, use_pallas=True)
    params = R.lnn_init(jax.random.PRNGKey(1), ref_cfg)
    want = np.asarray(R.lnn_forward(params, ref_cfg, graph))
    got = lnn_forward(_to_port(params), _port_cfg(ref_cfg), _cpu(graph)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("gnn_type", GNN_TYPES)
@pytest.mark.parametrize("typed", [False, True])
def test_lnn_init_layout_matches_reference(gnn_type, typed):
    kw = dict(gnn_type=gnn_type, num_gnn_layers=3, hidden_dim=16, mlp_dims=(16, 8),
              feat_dim=12, entity_types=ENTITY_TYPE_NAMES if typed else ())
    want = jax.tree_util.tree_map(lambda a: np.asarray(a).shape,
                                  R.lnn_init(jax.random.PRNGKey(0), R.LNNConfig(**kw)))
    got_params = lnn_init(torch.Generator().manual_seed(0), LNNConfig(**kw), device="cpu")
    got = jax.tree_util.tree_map(lambda t: tuple(t.shape), got_params,
                                 is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert got == want
    again = lnn_init(torch.Generator().manual_seed(0), LNNConfig(**kw), device="cpu")
    for a, b in zip(P.flatten_paths(got_params), P.flatten_paths(again)):
        assert a[0] == b[0] and torch.equal(a[1], b[1])


@pytest.mark.parametrize("typed", [False, True])
def test_params_round_trip_through_npz(typed, tmp_path):
    ref_cfg = R.LNNConfig(gnn_type="gat", num_gnn_layers=3, hidden_dim=8, mlp_dims=(8,),
                          feat_dim=4, entity_types=ENTITY_TYPE_NAMES if typed else ())
    params = R.lnn_init(jax.random.PRNGKey(2), ref_cfg)
    save_checkpoint(str(tmp_path / "ref.npz"), params, step=3)
    loaded = P.load_npz(str(tmp_path / "ref.npz"), "cpu")
    direct = _to_port(params)
    assert loaded.keys() == direct.keys()
    for (ka, a), (kb, b) in zip(P.flatten_paths(loaded), P.flatten_paths(direct)):
        assert ka == kb and torch.equal(a, b)
    P.save_npz(str(tmp_path / "port.npz"), loaded)
    back, step = load_checkpoint(str(tmp_path / "port.npz"), params)
    assert step is None
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
