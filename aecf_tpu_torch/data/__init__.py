"""Data: synthetic CLIP-like features for the training loop.

Port of the numpy part of :mod:`aecf_tpu.data`.  Not ported yet
(ROADMAP.md): the native batch loader (``data/loader.py`` with its C++
batcher) and the pathology report mining (``data/pathology.py``).
"""

from .synthetic import XRAY_PATHOLOGY_NAMES, make_synthetic_clip_features

__all__ = ["XRAY_PATHOLOGY_NAMES", "make_synthetic_clip_features"]
