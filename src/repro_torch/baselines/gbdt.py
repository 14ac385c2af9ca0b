"""Histogram gradient-boosted decision trees (binary logloss) in numpy.

Stand-in for LightGBM (paper §4.2's LGB baseline) — same algorithmic family:
quantile feature binning, second-order (grad/hess) histogram split finding,
depth-wise growth, shrinkage, L2 leaf regularization.

Also provides the paper's feature-encoding trick: "we use the encoded
features from an existing LightGBM" — ``leaf_value_features`` maps each
sample to its per-tree leaf values (n_trees-dim dense encoding), which then
feed the MLP and LNN models.

A copy of the reference's ``repro.baselines.gbdt`` (host code, numpy only;
the port imports nothing of the reference), so that the port's LNN input
features are the reference's bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class GBDTConfig:
    num_trees: int = 60
    max_depth: int = 4
    learning_rate: float = 0.15
    num_bins: int = 32
    min_child_weight: float = 1.0
    reg_lambda: float = 1.0
    min_gain: float = 1e-6


@dataclass
class _Tree:
    # flat arrays indexed by node id; leaves have feature == -1
    feature: np.ndarray
    threshold_bin: np.ndarray
    left: np.ndarray
    right: np.ndarray
    value: np.ndarray

    def predict_bins(self, xb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Returns (leaf_value, leaf_index) per sample for binned input."""
        n = xb.shape[0]
        node = np.zeros(n, np.int64)
        active = self.feature[node] >= 0
        while active.any():
            f = self.feature[node[active]]
            thr = self.threshold_bin[node[active]]
            go_left = xb[active, f] <= thr
            nxt = np.where(go_left, self.left[node[active]], self.right[node[active]])
            node[active] = nxt
            active = self.feature[node] >= 0
        return self.value[node], node


@dataclass
class GBDTModel:
    cfg: GBDTConfig
    bin_edges: list = field(default_factory=list)   # per feature
    trees: list = field(default_factory=list)
    base_score: float = 0.0

    # ---------------------------------------------------------------- utils
    def bin_data(self, x: np.ndarray) -> np.ndarray:
        xb = np.empty(x.shape, np.int32)
        for j, edges in enumerate(self.bin_edges):
            xb[:, j] = np.searchsorted(edges, x[:, j], side="left")
        return xb

    def raw_predict(self, x: np.ndarray) -> np.ndarray:
        xb = self.bin_data(x)
        out = np.full(x.shape[0], self.base_score)
        for t in self.trees:
            out += t.predict_bins(xb)[0]
        return out

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        return 1.0 / (1.0 + np.exp(-self.raw_predict(x)))

    def leaf_value_features(self, x: np.ndarray) -> np.ndarray:
        """Per-tree leaf values — the dense 'LGB-encoded' feature vector."""
        xb = self.bin_data(x)
        cols = [t.predict_bins(xb)[0] for t in self.trees]
        return np.stack(cols, axis=1).astype(np.float32)


def _fit_tree(xb, grad, hess, cfg: GBDTConfig, num_bins_per_feat):
    n, d = xb.shape
    feature = [-1]
    thr = [0]
    left = [-1]
    right = [-1]
    value = [0.0]
    # frontier: (node_id, sample_idx, depth)
    frontier = [(0, np.arange(n), 0)]
    while frontier:
        nid, idx, depth = frontier.pop()
        g_sum = grad[idx].sum()
        h_sum = hess[idx].sum()
        value[nid] = -g_sum / (h_sum + cfg.reg_lambda)
        if depth >= cfg.max_depth or idx.size < 2:
            continue
        parent_score = g_sum * g_sum / (h_sum + cfg.reg_lambda)
        best = (cfg.min_gain, -1, -1)  # (gain, feat, bin)
        for f in range(d):
            nb = num_bins_per_feat[f]
            gh = np.zeros((nb, 2))
            np.add.at(gh, xb[idx, f], np.stack([grad[idx], hess[idx]], 1))
            gl = np.cumsum(gh[:, 0])
            hl = np.cumsum(gh[:, 1])
            gr = g_sum - gl
            hr = h_sum - hl
            ok = (hl >= cfg.min_child_weight) & (hr >= cfg.min_child_weight)
            gain = np.where(
                ok,
                gl * gl / (hl + cfg.reg_lambda)
                + gr * gr / (hr + cfg.reg_lambda)
                - parent_score,
                -np.inf,
            )
            b = int(np.argmax(gain))
            if gain[b] > best[0]:
                best = (float(gain[b]), f, b)
        if best[1] < 0:
            continue
        _, f, b = best
        go_left = xb[idx, f] <= b
        l_id, r_id = len(feature), len(feature) + 1
        feature += [-1, -1]
        thr += [0, 0]
        left += [-1, -1]
        right += [-1, -1]
        value += [0.0, 0.0]
        feature[nid], thr[nid], left[nid], right[nid] = f, b, l_id, r_id
        frontier.append((l_id, idx[go_left], depth + 1))
        frontier.append((r_id, idx[~go_left], depth + 1))
    return _Tree(
        feature=np.asarray(feature, np.int64),
        threshold_bin=np.asarray(thr, np.int64),
        left=np.asarray(left, np.int64),
        right=np.asarray(right, np.int64),
        value=np.asarray(value, np.float64),
    )


def train_gbdt(
    x: np.ndarray,
    y: np.ndarray,
    cfg: GBDTConfig = GBDTConfig(),
    x_val: np.ndarray | None = None,
    y_val: np.ndarray | None = None,
    early_stop_rounds: int = 10,
) -> GBDTModel:
    """Fit with optional early stopping on validation logloss."""
    y = y.astype(np.float64)
    model = GBDTModel(cfg=cfg)
    # quantile bin edges
    for j in range(x.shape[1]):
        qs = np.quantile(x[:, j], np.linspace(0, 1, cfg.num_bins + 1)[1:-1])
        model.bin_edges.append(np.unique(qs))
    xb = model.bin_data(x)
    num_bins_per_feat = [len(e) + 1 for e in model.bin_edges]

    p0 = np.clip(y.mean(), 1e-6, 1 - 1e-6)
    model.base_score = float(np.log(p0 / (1 - p0)))
    raw = np.full(x.shape[0], model.base_score)
    raw_val = None
    if x_val is not None:
        xb_val = model.bin_data(x_val)
        raw_val = np.full(x_val.shape[0], model.base_score)
    best_loss, best_ntrees, stall = np.inf, 0, 0

    for _ in range(cfg.num_trees):
        p = 1.0 / (1.0 + np.exp(-raw))
        grad = p - y
        hess = np.maximum(p * (1 - p), 1e-12)
        tree = _fit_tree(xb, grad, hess, cfg, num_bins_per_feat)
        tree.value *= cfg.learning_rate
        model.trees.append(tree)
        raw += tree.predict_bins(xb)[0]
        if raw_val is not None:
            raw_val += tree.predict_bins(xb_val)[0]
            pv = np.clip(1.0 / (1.0 + np.exp(-raw_val)), 1e-9, 1 - 1e-9)
            loss = -(y_val * np.log(pv) + (1 - y_val) * np.log(1 - pv)).mean()
            if loss < best_loss - 1e-7:
                best_loss, best_ntrees, stall = loss, len(model.trees), 0
            else:
                stall += 1
                if stall >= early_stop_rounds:
                    model.trees = model.trees[:best_ntrees]
                    break
    return model
