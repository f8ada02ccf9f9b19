"""Evaluation metrics: macro mAP, macro F1, per-label F1.

A copy of :mod:`aecf_tpu.train.metrics` (numpy only): the port imports
nothing of the JAX package, so it keeps its own.

Re-implements the reference protocol (xrays/train_xrays_example.py:260-310)
in pure numpy with sklearn-identical semantics, so the metrics stack has no
sklearn dependency (a cross-check test against sklearn runs when it's
installed):

* mAP: macro ``average_precision_score`` over classes that have at least one
  positive; AP is the step-function sum Σ (Rₙ−Rₙ₋₁)·Pₙ over distinct-score
  thresholds.
* per-label F1 at ``sigmoid(logit) > threshold`` with zero-division → 0;
  labels without positives get F1 = 0.
* macro F1: the reference's quirk — the mean over *strictly positive*
  per-label F1s only (train_xrays_example.py:293), 0.0 if none.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = [
    "average_precision",
    "macro_map",
    "calculate_metrics",
    "expected_calibration_error",
    "brier_score",
    "recall_at_k",
]


def _sigmoid(x: np.ndarray) -> np.ndarray:
    out = np.empty_like(x, dtype=np.float64)
    pos = x >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-x[pos]))
    ex = np.exp(x[~pos])
    out[~pos] = ex / (1.0 + ex)
    return out


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Binary average precision, sklearn-equivalent (step interpolation)."""
    y_true = np.asarray(y_true, dtype=np.float64).ravel()
    y_score = np.asarray(y_score, dtype=np.float64).ravel()
    n_pos = y_true.sum()
    if n_pos == 0:
        return 0.0

    order = np.argsort(-y_score, kind="mergesort")
    y_true = y_true[order]
    y_score = y_score[order]

    # Indices of the last element of each distinct-score group.
    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]

    tps = np.cumsum(y_true)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    precision = tps / (tps + fps)
    recall = tps / n_pos

    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def macro_map(y_true: np.ndarray, y_prob: np.ndarray) -> float:
    """Macro mAP over classes with positives (reference :272-278)."""
    valid = y_true.sum(axis=0) > 0
    if not valid.any():
        return 0.0
    aps = [
        average_precision(y_true[:, i], y_prob[:, i])
        for i in np.where(valid)[0]
    ]
    return float(np.mean(aps))


def _binary_f1(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    tp = float(np.sum((y_pred == 1) & (y_true == 1)))
    fp = float(np.sum((y_pred == 1) & (y_true == 0)))
    fn = float(np.sum((y_pred == 0) & (y_true == 1)))
    denom = 2 * tp + fp + fn
    return 0.0 if denom == 0 else 2 * tp / denom


def expected_calibration_error(
    y_prob: np.ndarray,
    y_true: np.ndarray,
    n_bins: int = 15,
) -> float:
    """Expected calibration error over equal-width confidence bins.

    The reference's headline claim — "maintains both robustness and
    calibration when modalities are missing" / "Calibrated Predictions"
    (reference README.md:7, 17) — ships without any metric code (the test
    suite that measured it was deleted pre-snapshot, PYPI_READY.md:50-59).
    This is the standard ECE estimator: bin predictions by confidence into
    ``n_bins`` equal-width bins on [0, 1] and average |accuracy − mean
    confidence| weighted by bin occupancy.  Multilabel inputs are flattened
    (micro-ECE over every (sample, label) binary decision).

    Args:
      y_prob: probabilities in [0, 1], any shape.
      y_true: binary labels, same shape.
    """
    p = np.asarray(y_prob, dtype=np.float64).ravel()
    t = np.asarray(y_true, dtype=np.float64).ravel()
    if p.size == 0:
        return 0.0
    # NaN compares False against both bounds, slips past the range check,
    # falls outside every bin, yet still counts in p.size — silently
    # deflating the reported ECE.  Reject non-finite inputs explicitly.
    if not np.isfinite(p).all():
        raise ValueError("y_prob must be finite probabilities in [0, 1]")
    if p.min() < 0.0 or p.max() > 1.0:
        raise ValueError("y_prob must be probabilities in [0, 1]")
    # Bin by confidence; right-closed bins, p=0 lands in bin 0.
    idx = np.minimum((p * n_bins).astype(int), n_bins - 1)
    ece = 0.0
    for b in range(n_bins):
        sel = idx == b
        n = int(sel.sum())
        if n == 0:
            continue
        ece += (n / p.size) * abs(t[sel].mean() - p[sel].mean())
    return float(ece)


def recall_at_k(
    query_emb: np.ndarray,
    target_emb: np.ndarray,
    ks: "Tuple[int, ...]" = (1, 5, 10),
) -> dict:
    """Retrieval recall@K for paired embeddings (row i matches row i).

    The protocol of the reference's deleted COCO experiments
    (reference README.md:284-296, removed per PYPI_READY.md:50-59):
    embed queries and targets, rank all targets per query by cosine
    similarity, and report the fraction of queries whose true pair ranks
    in the top K.  Ties broken by index (deterministic).

    Args:
      query_emb: (N, D) — e.g. fused multimodal embeddings.
      target_emb: (N, D) — e.g. the paired caption/image embeddings.
    Returns: ``{k: recall}`` for each requested K.
    """
    q = np.asarray(query_emb, dtype=np.float64)
    t = np.asarray(target_emb, dtype=np.float64)
    if q.shape != t.shape:
        raise ValueError(
            f"query/target shape mismatch: {q.shape} vs {t.shape}"
        )
    n = q.shape[0]
    if n == 0:
        return {int(k): 0.0 for k in ks}
    q = q / (np.linalg.norm(q, axis=1, keepdims=True) + 1e-12)
    t = t / (np.linalg.norm(t, axis=1, keepdims=True) + 1e-12)
    sim = q @ t.T  # (N, N)
    # rank of the true pair: number of targets strictly more similar
    true_sim = np.diag(sim)
    better = (sim > true_sim[:, None]).sum(axis=1)
    # index tie-break: equal-similarity targets with a smaller index win
    ties_before = (
        (np.abs(sim - true_sim[:, None]) < 1e-12)
        & (np.arange(n)[None, :] < np.arange(n)[:, None])
    ).sum(axis=1)
    rank = better + ties_before  # 0-based
    return {int(k): float((rank < k).mean()) for k in ks}


def brier_score(y_prob: np.ndarray, y_true: np.ndarray) -> float:
    """Mean squared error between probabilities and binary labels
    (a proper scoring rule: sensitive to both calibration and refinement)."""
    p = np.asarray(y_prob, dtype=np.float64).ravel()
    t = np.asarray(y_true, dtype=np.float64).ravel()
    if p.size == 0:
        return 0.0
    return float(np.mean((p - t) ** 2))


def calculate_metrics(
    y_pred: np.ndarray,
    y_true: np.ndarray,
    threshold: float = 0.5,
) -> Tuple[float, float, np.ndarray]:
    """(mAP, macro-F1, per-label F1) from raw logits + multi-hot labels.

    Mirrors reference ``calculate_metrics`` (train_xrays_example.py:260-295):
    logits → sigmoid probabilities → binary at ``threshold``.
    """
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    y_prob = _sigmoid(y_pred)
    y_bin = (y_prob > threshold).astype(int)

    map_score = macro_map(y_true, y_prob)

    n_classes = y_true.shape[1]
    f1_scores = np.zeros(n_classes)
    for i in range(n_classes):
        if y_true[:, i].sum() > 0:
            f1_scores[i] = _binary_f1(y_true[:, i], y_bin[:, i])

    positives = f1_scores[f1_scores > 0]
    macro_f1 = float(np.mean(positives)) if positives.size else 0.0

    return map_score, macro_f1, f1_scores
