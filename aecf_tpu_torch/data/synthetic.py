"""Synthetic multimodal feature generation.

A copy of :mod:`aecf_tpu.data.synthetic` (numpy only): the port imports
nothing of the JAX package, so it keeps its own.

The reference's X-ray pipeline consumes pre-extracted CLIP features
(``xray_train_clip_feats.pt`` — train_xrays_example.py:241-242) whose
extraction script and source parquet were stripped from the snapshot
(SURVEY.md §2.2 note).  This module supplies the substitute: synthetic
CLIP-like features with real multi-label structure, so the full experiment
(training, curriculum activation, masked eval sweeps) runs end-to-end and is
*learnable* — masking a modality must actually cost accuracy, which requires
cross-modal label signal.

Construction: each class c gets a prototype direction in each modality;
a sample's modality feature is the sum of its label prototypes (scaled by a
per-class *modality visibility*) + noise, L2-normalized to CLIP-typical
norms.  Half the classes are image-dominant, half text-dominant, so either
modality alone predicts labels imperfectly while together they do well —
reproducing the qualitative behavior the reference experiment measures
(masking a modality costs accuracy; fusion recovers it).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

__all__ = ["make_synthetic_clip_features", "XRAY_PATHOLOGY_NAMES"]

# Pathology label names used by the reference experiment
# (train_xrays_example.py:36-40).
XRAY_PATHOLOGY_NAMES = [
    "Atelectasis", "Cardiomegaly", "Effusion", "Infiltration", "Mass",
    "Nodule", "Pneumonia", "Pneumothorax", "Consolidation", "Edema",
    "Emphysema", "Fibrosis", "Pleural_Thickening", "Hernia", "No Finding",
]


def make_synthetic_clip_features(
    n_train: int = 2048,
    n_val: int = 512,
    image_dim: int = 512,
    text_dim: int = 512,
    num_classes: int = 15,
    label_prob: float = 0.12,
    noise: float = 0.5,
    visibility: Tuple[float, float] = (1.0, 0.15),
    seed: int = 0,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Return ``(train_data, val_data)`` dicts with keys image/text/label.

    Matches the tensor layout the reference loader produces
    (train_xrays_example.py:239-250): float32 features, multi-hot float32
    labels.
    """
    rng = np.random.default_rng(seed)

    img_protos = rng.normal(size=(num_classes, image_dim)).astype(np.float32)
    txt_protos = rng.normal(size=(num_classes, text_dim)).astype(np.float32)

    # Per-class modality visibility: even classes image-dominant, odd
    # classes text-dominant — the complementarity that makes fusion matter.
    strong, weak = visibility
    img_vis = np.where(np.arange(num_classes) % 2 == 0, strong, weak)
    txt_vis = np.where(np.arange(num_classes) % 2 == 0, weak, strong)
    img_protos = img_protos * img_vis[:, None]
    txt_protos = txt_protos * txt_vis[:, None]

    def sample(n, salt):
        r = np.random.default_rng(seed + salt)
        labels = (r.random((n, num_classes)) < label_prob).astype(np.float32)
        # Guarantee at least one positive label per row (multi-label data).
        empty = labels.sum(1) == 0
        labels[empty, r.integers(0, num_classes, size=int(empty.sum()))] = 1.0

        img = labels @ img_protos
        txt = labels @ txt_protos
        img += noise * r.normal(size=img.shape).astype(np.float32)
        txt += noise * r.normal(size=txt.shape).astype(np.float32)

        # CLIP-ish scale: unit-norm features.
        img /= np.linalg.norm(img, axis=1, keepdims=True) + 1e-8
        txt /= np.linalg.norm(txt, axis=1, keepdims=True) + 1e-8
        return {
            "image": img.astype(np.float32),
            "text": txt.astype(np.float32),
            "label": labels,
        }

    return sample(n_train, 1), sample(n_val, 2)
