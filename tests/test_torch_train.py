"""The port's training stack against the reference's on the CPU, from the
same parameters (carried across from ``repro.core.lnn_init`` through numpy
and ``params.from_numpy``) and the same inputs:

- ``lnn_loss`` and its gradients against ``jax.value_and_grad`` of the
  reference's (its training path, ``use_pallas=False``), for gcn, gat, sage
  and a typed model: loss within 1e-5 relative; each leaf's gradient within
  1e-5 of that leaf's scale (max |g|) of the reference's gradient taken in
  float64, and of its float32 gradient up to that one's own distance from
  the float64 one (GAT's final-hop ``a_dst`` and ``a_et`` gradients cancel
  to ~1e-5 of the others', where the reference's own f32 rounding is about
  1e-5 of their scale);
- ``adamw``, ``clip_by_global_norm`` and ``cosine_schedule`` from identical
  parameters, gradients and state, within 1e-6 over 3 steps (gradients and
  optimizer held apart: the first AdamW step divides by |g|, so gradients
  that differ in their last bits would move it by a part of lr);
- the losses of 3 training steps against the reference's jitted step,
  within 1e-4 relative; ``evaluate_lnn``'s ROC-AUC and AP within 1e-6;
- a short ``train_lnn`` whose training loss falls; checkpoints that cross
  both ways; the metrics equal to the reference's.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core as R
import repro.train.checkpoint as RC
import repro.train.loop as RL
import repro.train.metrics as RM
import repro.train.optim as RO
from repro.core.dds import IncrementalDDSBuilder
from repro.core.hetero import ENTITY_TYPE_NAMES, tag_entity
from repro_torch import params as P
from repro_torch.core import LNNConfig, PaddedGraph, lnn_loss
from repro_torch.data.pipeline import CommunityBatch
from repro_torch.train import (adamw, average_precision, binary_metrics, clip_by_global_norm,
                               cosine_schedule, load_checkpoint, roc_auc, save_checkpoint)
from repro_torch.train.loop import evaluate_lnn, train_lnn, train_masks
from repro_torch.train.optim import grad_step

GNN_TYPES = ["gcn", "gat", "sage"]


def _port_cfg(ref_cfg):
    return LNNConfig(**{f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(LNNConfig)})


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _lookup(tree, path):
    for part in path.split("/"):
        tree = tree[int(part)] if isinstance(tree, (list, tuple)) else tree[part]
    return np.asarray(tree)


def _port_batches(batches):
    """The reference's community batches with the port's graph type."""
    return [CommunityBatch(graph=PaddedGraph(*b.graph), global_order_ids=b.global_order_ids,
                           dds=b.dds) for b in batches]


def _assert_grads_close(grads_port, grads_ref, grads_exact, tol):
    """Every leaf of the port's gradient tree within ``tol`` of the scale
    (max |g|) of the same leaf of the reference's float64 gradient
    ``grads_exact``, and as close to the reference's float32 gradient
    ``grads_ref`` plus that one's own distance from ``grads_exact``."""
    checked = 0
    for path, g in P.flatten_paths(grads_port):
        g = g.detach().numpy()
        want, exact = _lookup(grads_ref, path), _lookup(grads_exact, path)
        scale = float(np.abs(exact).max())
        err = float(np.abs(g - exact).max())
        assert err <= tol * scale, f"{path}: max|d| {err:.3e} > {tol:g} of scale {scale:.3e}"
        excess = np.abs(g - want) - np.abs(want - exact)
        assert float(excess.max()) <= tol * scale, f"{path}: against the f32 reference"
        checked += 1
    assert checked == len(jax.tree_util.tree_leaves(grads_ref))


def _reference_grads_f64(params, ref_cfg, graph):
    """The reference's gradient of its loss, computed in float64."""
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), params)
        g64 = graph._replace(**{f: np.asarray(getattr(graph, f), np.float64)
                                for f in ("features", "nbr_mask", "label", "label_mask")})
        return _np_tree(jax.grad(R.lnn_loss)(p64, ref_cfg, g64))


def _typed_graph(small_fraud_dataset):
    g, _, _ = small_fraud_dataset
    typed_ids = [tag_entity(e, int(t) % len(ENTITY_TYPE_NAMES))
                 for e, t in enumerate(g.entity_type)]
    builder = IncrementalDDSBuilder(g.order_features.shape[1])
    for o in np.argsort(g.order_snapshot, kind="stable")[:150]:
        builder.add_order([typed_ids[e] for e in g.edges[g.edges[:, 0] == o, 1]],
                          int(g.order_snapshot[o]), g.order_features[o], label=g.labels[o])
    return R.pad_graph(builder.build().coo, max_deg=16)


@pytest.mark.parametrize("model", GNN_TYPES + ["gat typed"])
def test_lnn_loss_and_gradients_match_reference(model, small_communities, small_fraud_dataset):
    gnn, typed = model.split()[0], model.endswith("typed")
    graph = _typed_graph(small_fraud_dataset) if typed else small_communities[0].graph
    ref_cfg = R.LNNConfig(gnn_type=gnn, num_gnn_layers=2, hidden_dim=16, mlp_dims=(16,),
                          feat_dim=graph.features.shape[1], pos_weight=3.0,
                          entity_types=ENTITY_TYPE_NAMES if typed else ())
    params = R.lnn_init(jax.random.PRNGKey(3), ref_cfg)
    assert float(np.sum(graph.label_mask * (graph.node_type == 0))) > 0
    loss_ref, grads_ref = jax.value_and_grad(R.lnn_loss)(params, ref_cfg, graph)

    tparams = P.from_numpy(_np_tree(params), "cpu")
    leaves = P.tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_()
    loss = lnn_loss(tparams, _port_cfg(ref_cfg), PaddedGraph(*graph).to("cpu"))
    grads = P.tree_unflatten(tparams, torch.autograd.grad(loss, leaves))
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref), rtol=1e-5)
    _assert_grads_close(grads, _np_tree(grads_ref),
                        _reference_grads_f64(params, ref_cfg, graph), 1e-5)


def _opt_inputs(seed=0):
    """A tree with 2-D (decayed), 3-D (decayed, as GCN's w_nbr) and 1-D
    (not decayed) leaves, and three steps of gradients, one of them tiny."""
    rng = np.random.default_rng(seed)
    params = {"a": rng.normal(size=(5, 4)).astype(np.float32),
              "layers": [{"w": rng.normal(size=(3, 4, 2)).astype(np.float32),
                          "b": rng.normal(size=(2,)).astype(np.float32)}],
              "v": rng.normal(size=(7,)).astype(np.float32)}
    grads = [jax.tree_util.tree_map(lambda x: (rng.normal(size=x.shape) * s).astype(np.float32),
                                    params) for s in (0.3, 2.0, 1e-4)]
    return params, grads


def test_cosine_schedule_and_clip_match_reference():
    sched_ref, sched = RO.cosine_schedule(3e-3, 200, 10), cosine_schedule(3e-3, 200, 10)
    for step in (0, 1, 5, 10, 11, 57, 199, 200, 250):
        np.testing.assert_allclose(float(sched(torch.tensor(step, dtype=torch.int32))),
                                   float(sched_ref(step)), rtol=1e-6, atol=1e-12)
    params, grads = _opt_inputs()
    for g, max_norm in ((grads[0], 1.0), (grads[1], 1.0), (grads[1], 100.0)):
        want, want_norm = RO.clip_by_global_norm(g, max_norm)
        got, norm = clip_by_global_norm(P.from_numpy(g, "cpu"), max_norm)
        np.testing.assert_allclose(float(norm), float(want_norm), rtol=1e-6)
        for path, leaf in P.flatten_paths(got):
            np.testing.assert_allclose(leaf.numpy(), _lookup(want, path), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("clip_norm", [1.0, None])
def test_adamw_matches_reference_over_three_steps(clip_norm):
    params, grads = _opt_inputs(1)
    sched = (3e-3, 30, 2)
    init_r, update_r = RO.adamw(RO.cosine_schedule(*sched), weight_decay=1e-2,
                                clip_norm=clip_norm)
    init_p, update_p = adamw(cosine_schedule(*sched), weight_decay=1e-2, clip_norm=clip_norm)
    p_ref, s_ref = params, init_r(params)
    p_port = P.from_numpy(params, "cpu")
    s_port = init_p(p_port)
    for g in grads:
        # the same gradients, parameters and state on both sides
        p_ref, s_ref, aux_ref = update_r(g, s_ref, p_ref)
        p_port, s_port, aux = update_p(P.from_numpy(g, "cpu"), s_port, p_port)
        for tree, want in ((p_port, p_ref), (s_port.mu, s_ref.mu), (s_port.nu, s_ref.nu)):
            for path, leaf in P.flatten_paths(tree):
                np.testing.assert_allclose(leaf.numpy(), _lookup(_np_tree(want), path),
                                           rtol=1e-6, atol=1e-6, err_msg=path)
        assert int(s_port.step) == int(s_ref.step)
        np.testing.assert_allclose(float(aux["lr"]), float(aux_ref["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(aux["grad_norm"]), float(aux_ref["grad_norm"]),
                                   rtol=1e-6)
        p_port = P.from_numpy(_np_tree(p_ref), "cpu")   # identical params for the next step
        s_port = s_port._replace(mu=P.from_numpy(_np_tree(s_ref.mu), "cpu"),
                                 nu=P.from_numpy(_np_tree(s_ref.nu), "cpu"))


@pytest.mark.parametrize("gnn", GNN_TYPES)
def test_three_training_steps_match_reference_losses(gnn, small_communities, small_fraud_dataset):
    _, _, split = small_fraud_dataset
    batches = small_communities[:3]
    ref_cfg = R.LNNConfig(gnn_type=gnn, num_gnn_layers=2, hidden_dim=16, mlp_dims=(16,),
                          feat_dim=batches[0].graph.features.shape[1], pos_weight=3.0)
    params = R.lnn_init(jax.random.PRNGKey(4), ref_cfg)
    sched = (3e-3, 30, 10)
    init_r, update_r = RO.adamw(RO.cosine_schedule(*sched), weight_decay=1e-4)
    init_p, update_p = adamw(cosine_schedule(*sched), weight_decay=1e-4)

    @jax.jit
    def step_ref(params, state, graph, mask):
        loss, grads = jax.value_and_grad(RL._masked_loss)(params, ref_cfg, graph, mask)
        params, state, _ = update_r(grads, state, params)
        return params, state, loss

    cfg = _port_cfg(ref_cfg)
    masks = train_masks(_port_batches(batches), split)
    tparams = P.from_numpy(_np_tree(params), "cpu")
    state_r, state_p = init_r(params), init_p(tparams)
    for b, m in zip(batches, masks):
        assert m.sum() > 0
        params, state_r, loss_r = step_ref(params, state_r, b.graph, m)
        graph = PaddedGraph(*b.graph).to("cpu")._replace(label_mask=torch.from_numpy(m))
        tparams, state_p, loss = grad_step(lambda p: lnn_loss(p, cfg, graph), tparams, state_p,
                                           update_p)
        np.testing.assert_allclose(float(loss), float(loss_r), rtol=1e-4)


def test_evaluate_matches_reference(small_communities, small_fraud_dataset):
    _, _, split = small_fraud_dataset
    ref_cfg = R.LNNConfig(gnn_type="gcn", num_gnn_layers=2, hidden_dim=16, mlp_dims=(16,),
                          feat_dim=small_communities[0].graph.features.shape[1])
    params = R.lnn_init(jax.random.PRNGKey(5), ref_cfg)
    tparams = P.from_numpy(_np_tree(params), "cpu")
    batches = _port_batches(small_communities)
    for which in (1, 2):
        want = RL.evaluate_lnn(params, ref_cfg, small_communities, split, which)
        got = evaluate_lnn(tparams, _port_cfg(ref_cfg), batches, split, which, device="cpu")
        assert (got["n"], got["pos"]) == (want["n"], want["pos"])
        for k in ("roc_auc", "average_precision"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-6)


def test_train_lnn_loss_falls(small_communities, small_fraud_dataset):
    _, _, split = small_fraud_dataset
    cfg = LNNConfig(gnn_type="gcn", num_gnn_layers=2, hidden_dim=16, mlp_dims=(16,),
                    feat_dim=small_communities[0].graph.features.shape[1], pos_weight=3.0)
    res = train_lnn(_port_batches(small_communities), split, cfg, epochs=4, patience=10,
                    seed=0, device="cpu")
    losses = [h["train_loss"] for h in res.history]
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert 0 <= res.best_epoch < 4
    assert P.tree_leaves(res.params)[0].device.type == "cpu"


def test_checkpoints_cross_both_ways(tmp_path):
    ref_cfg = R.LNNConfig(gnn_type="gat", num_gnn_layers=2, hidden_dim=8, mlp_dims=(8,),
                          feat_dim=4)
    params = R.lnn_init(jax.random.PRNGKey(6), ref_cfg)
    state = RO.adamw()[0](params)
    tree_ref = {"params": params, "opt": state}

    # reference save -> port load, into the port's structure
    RC.save_checkpoint(str(tmp_path / "ref.npz"), tree_ref, step=7)
    tparams = P.from_numpy(_np_tree(params), "cpu")
    like = {"params": tparams, "opt": adamw()[0](tparams)}
    got, step = load_checkpoint(str(tmp_path / "ref.npz"), like)
    assert step == 7 and type(got["opt"]).__name__ == "OptState"
    for path, leaf in P.flatten_paths(got["params"]):
        assert isinstance(leaf, torch.Tensor)
        np.testing.assert_array_equal(leaf.numpy(), _lookup(_np_tree(params), path))

    # port save -> reference load
    bumped = P.tree_map(lambda t: t + 1.0, tparams)
    save_checkpoint(str(tmp_path / "port.npz"), {"params": bumped, "opt": like["opt"]}, step=9)
    back, step = RC.load_checkpoint(str(tmp_path / "port.npz"), tree_ref)
    assert step == 9
    for path, leaf in P.flatten_paths(bumped):
        np.testing.assert_array_equal(_lookup(back["params"], path), leaf.numpy())
    assert int(back["opt"].step) == 0
    _, step = load_checkpoint(str(tmp_path / "port.npz"), {"params": bumped})
    assert step == 9

    # a shape that differs, a key that is missing
    wrong = P.tree_map(lambda t: t, tparams)
    wrong["input"]["w"] = torch.zeros(5, 8)
    with pytest.raises(ValueError, match="shape mismatch for params/input/w"):
        load_checkpoint(str(tmp_path / "ref.npz"), {"params": wrong})
    with pytest.raises(KeyError, match="params/extra"):
        load_checkpoint(str(tmp_path / "ref.npz"), {"params": {**tparams, "extra": tparams["input"]["b"]}})


def test_metrics_equal_reference():
    rng = np.random.default_rng(0)
    for n in (10, 257):
        y = (rng.uniform(size=n) < 0.3).astype(np.float32)
        y[:2] = (0, 1)
        s = np.round(rng.normal(size=n), 1)      # ties
        assert roc_auc(y, s) == RM.roc_auc(y, s)
        assert average_precision(y, s) == RM.average_precision(y, s)
        assert binary_metrics(y, s) == RM.binary_metrics(y, s)
    with pytest.raises(ValueError, match="both classes"):
        roc_auc(np.ones(4), np.arange(4.0))
