"""The port's Table 3 baselines against the reference's on the CPU: the GBDT
(numpy, copied) gives the same trees and the same encoded features, array
for array; the MLP from carried-across parameters gives the same logits and
probabilities within 1e-6 (f32, the same products in another library); the
MLP learns a separable problem; and the port's LNN beats the tabular
baseline on ring fraud, as ``tests/test_system.py`` shows for the
reference, at the same data and epochs."""
import jax
import numpy as np
import torch

from repro.baselines import GBDTConfig as RGBDTConfig, train_gbdt as r_train_gbdt
from repro.baselines.mlp import (MLPConfig as RMLPConfig, mlp_forward as r_mlp_forward,
                                 mlp_init as r_mlp_init, predict_mlp as r_predict_mlp)
from repro_torch.baselines import GBDTConfig, MLPConfig, mlp_forward, train_gbdt
from repro_torch.baselines.mlp import predict_mlp, train_mlp
from repro_torch.core import LNNConfig
from repro_torch.data import (SynthConfig, build_communities, generate_transactions,
                              make_split_masks, standardize_features)
from repro_torch.params import from_numpy
from repro_torch.train.loop import evaluate_lnn, train_lnn
from repro_torch.train.metrics import binary_metrics, roc_auc


def _tabular(seed=0, n=600, f=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = ((x[:, 0] + 0.5 * x[:, 1] ** 2 + 0.3 * rng.normal(size=n)) > 0.6).astype(np.float32)
    return x, y


def test_gbdt_and_encoded_features_equal_reference():
    x, y = _tabular()
    cfg = dict(num_trees=12, max_depth=3)
    for val in (False, True):   # with and without early stopping on a validation set
        extra = (x[400:], y[400:]) if val else ()
        want = r_train_gbdt(x[:400], y[:400], RGBDTConfig(**cfg), *extra)
        got = train_gbdt(x[:400], y[:400], GBDTConfig(**cfg), *extra)
        assert len(got.trees) == len(want.trees) and got.base_score == want.base_score
        for a, b in zip(got.bin_edges, want.bin_edges):
            assert np.array_equal(a, b)
        for ta, tb in zip(got.trees, want.trees):
            for field in ("feature", "threshold_bin", "left", "right", "value"):
                assert np.array_equal(getattr(ta, field), getattr(tb, field))
        assert np.array_equal(got.leaf_value_features(x), want.leaf_value_features(x))
        assert np.array_equal(got.predict_proba(x), want.predict_proba(x))


def test_mlp_forward_and_predict_match_reference():
    x, _ = _tabular(1, n=50)
    cfg = RMLPConfig(hidden_dims=(16, 8))
    params = r_mlp_init(jax.random.PRNGKey(0), x.shape[1], cfg)
    tparams = from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    np.testing.assert_allclose(mlp_forward(tparams, torch.from_numpy(x)).numpy(),
                               np.asarray(r_mlp_forward(params, x)), atol=1e-6, rtol=1e-6)
    got = predict_mlp(tparams, x)
    assert got.dtype == np.float32 and got.shape == (50,)
    np.testing.assert_allclose(got, r_predict_mlp(params, x), atol=1e-6, rtol=1e-6)


def test_mlp_learns_separable():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(600, 5)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    p = train_mlp(x[:400], y[:400], x[400:], y[400:], MLPConfig(epochs=60), device="cpu")
    assert roc_auc(y[400:], predict_mlp(p, x[400:])) > 0.95


def test_lnn_beats_tabular_baseline_on_ring_fraud():
    """``tests/test_system.py``'s end-to-end check on the port: the same data,
    GBDT encoding, communities, model and epochs, on the CPU."""
    cfg = SynthConfig(num_users=300, num_rings=6, feature_noise=0.8, seed=0)
    g, _ = generate_transactions(cfg)
    split = make_split_masks(g.order_snapshot)
    feats, _ = standardize_features(g.order_features, split == 0)
    g.order_features = feats

    gbdt = train_gbdt(feats[split == 0], g.labels[split == 0], GBDTConfig(),
                      feats[split == 1], g.labels[split == 1])
    m_gbdt = binary_metrics(g.labels[split == 2], gbdt.predict_proba(feats[split == 2]))

    enc = np.concatenate([feats, gbdt.leaf_value_features(feats)], 1).astype(np.float32)
    mu, sd = enc[split == 0].mean(0), enc[split == 0].std(0) + 1e-6
    g.order_features = ((enc - mu) / sd).astype(np.float32)

    batches = build_communities(g, community_size=256, max_deg=24)
    lcfg = LNNConfig(gnn_type="gcn", num_gnn_layers=3, hidden_dim=64,
                     feat_dim=g.order_features.shape[1], pos_weight=3.0)
    res = train_lnn(batches, split, lcfg, epochs=25, patience=6, seed=0, device="cpu")
    m_lnn = evaluate_lnn(res.params, lcfg, batches, split, 2, device="cpu")

    assert m_lnn["roc_auc"] > m_gbdt["roc_auc"]
    assert m_lnn["average_precision"] > m_gbdt["average_precision"]
    assert m_lnn["roc_auc"] > 0.9
