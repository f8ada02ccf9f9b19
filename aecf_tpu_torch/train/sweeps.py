"""Missing-modality inference sweeps.

A copy of :mod:`aecf_tpu.train.sweeps` (numpy only): the port imports
nothing of the JAX package, so it keeps its own.

BASELINE.json config #4 names "missing-modality inference sweep over
modality subsets": evaluate a trained fusion model with every subset of
modalities present (absent ones zeroed — the reference's missing-modality
convention, a zero vector fails the ‖x‖>1e-6 presence test,
train_xrays_example.py:81-82) and report per-subset metrics.

Generalizes the reference's 3-sweep eval (none/images/texts, :297-310) to
arbitrary modality counts.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from .metrics import (
    _sigmoid,
    brier_score,
    calculate_metrics,
    expected_calibration_error,
)

__all__ = ["modality_subsets", "missing_modality_sweep"]


def modality_subsets(names: Sequence[str]) -> List[Tuple[str, ...]]:
    """All non-empty subsets, largest (full) first."""
    subsets: List[Tuple[str, ...]] = []
    for r in range(len(names), 0, -1):
        subsets.extend(itertools.combinations(names, r))
    return subsets


def missing_modality_sweep(
    predict_fn: Callable[..., np.ndarray],
    modalities: Dict[str, np.ndarray],
    labels: np.ndarray,
    *,
    batch_size: int = 256,
    threshold: float = 0.5,
) -> Dict[Tuple[str, ...], Dict[str, float]]:
    """Evaluate under every modality subset.

    ``predict_fn(**{name: array})`` must accept all modality kwargs and
    return logits; absent modalities are passed as zeros.  Returns
    ``{subset: {"map": ..., "macro_f1": ..., "per_label_f1": [...],
    "ece": ..., "brier": ...}}`` — per-subset calibration (ECE/Brier)
    quantifies the reference's "calibrated under missing modalities"
    claim (reference README.md:7, 17).
    """
    names = list(modalities)
    n = labels.shape[0]
    results: Dict[Tuple[str, ...], Dict[str, float]] = {}
    for subset in modality_subsets(names):
        preds = []
        for start in range(0, n, batch_size):
            end = min(start + batch_size, n)
            kwargs = {}
            for name in names:
                x = modalities[name][start:end]
                if name not in subset:
                    x = np.zeros_like(x)
                kwargs[name] = x
            preds.append(np.asarray(predict_fn(**kwargs)))
        logits = np.concatenate(preds)
        m, f1, per_label = calculate_metrics(logits, labels, threshold)
        probs = _sigmoid(np.asarray(logits, dtype=np.float64))
        results[subset] = {
            "map": m,
            "macro_f1": f1,
            "per_label_f1": per_label.tolist(),
            "ece": expected_calibration_error(probs, labels),
            "brier": brier_score(probs, labels),
        }
    return results
