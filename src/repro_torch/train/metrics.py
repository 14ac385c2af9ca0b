"""Evaluation metrics for the paper's Table 3: ROC AUC and Average Precision.

Pure numpy, no sklearn dependency; a copy of the reference's
``repro.train.metrics`` (the port imports nothing of the reference).
Semantics match ``sklearn.metrics.roc_auc_score`` and
``sklearn.metrics.average_precision_score`` (step-wise AP, not
interpolated), which is what the paper reports.
"""
from __future__ import annotations

import numpy as np


def _validate(y_true: np.ndarray, y_score: np.ndarray):
    y_true = np.asarray(y_true).ravel().astype(np.int64)
    y_score = np.asarray(y_score).ravel().astype(np.float64)
    if y_true.shape != y_score.shape:
        raise ValueError(f"shape mismatch {y_true.shape} vs {y_score.shape}")
    if y_true.size == 0:
        raise ValueError("empty inputs")
    pos = int(y_true.sum())
    if pos == 0 or pos == y_true.size:
        raise ValueError("need both classes present")
    return y_true, y_score


def roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """ROC AUC via the Mann-Whitney U statistic with tie correction."""
    y_true, y_score = _validate(y_true, y_score)
    # rank scores (average rank for ties)
    order = np.argsort(y_score, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_scores = y_score[order]
    # average ranks over tie groups
    n = y_score.size
    i = 0
    while i < n:
        j = i
        while j + 1 < n and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0  # 1-based average rank
        i = j + 1
    n_pos = float(y_true.sum())
    n_neg = float(n - n_pos)
    rank_sum_pos = float(ranks[y_true == 1].sum())
    u = rank_sum_pos - n_pos * (n_pos + 1.0) / 2.0
    return u / (n_pos * n_neg)


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Average precision (area under precision-recall, step interpolation).

    AP = sum_k (R_k - R_{k-1}) * P_k over descending-score thresholds,
    with ties handled by treating equal scores as one threshold.
    """
    y_true, y_score = _validate(y_true, y_score)
    desc = np.argsort(-y_score, kind="mergesort")
    y_sorted = y_true[desc]
    scores_sorted = y_score[desc]
    # cumulative true positives / predicted positives
    tp = np.cumsum(y_sorted)
    fp = np.cumsum(1 - y_sorted)
    # threshold boundaries: last index of each tie group
    distinct = np.where(np.diff(scores_sorted))[0]
    idx = np.concatenate([distinct, [y_sorted.size - 1]])
    tp_at = tp[idx].astype(np.float64)
    fp_at = fp[idx].astype(np.float64)
    precision = tp_at / (tp_at + fp_at)
    recall = tp_at / float(y_true.sum())
    # prepend recall 0
    recall_prev = np.concatenate([[0.0], recall[:-1]])
    return float(np.sum((recall - recall_prev) * precision))


def binary_metrics(y_true: np.ndarray, y_score: np.ndarray) -> dict:
    return {
        "roc_auc": roc_auc(y_true, y_score),
        "average_precision": average_precision(y_true, y_score),
    }
