"""What the two serving drivers share: the predictor over the benchmark's
weights, the host rows requests are cut from, the warm-up of every bucket
and modality subset, and the check of sampled answers against the plain
reference."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .. import models
from ..reference import vision_language as ref

SUBSETS = {"both": ("image", "text"), "image": ("image",), "text": ("text",)}
WIDTH = {"image": "img_dim", "text": "txt_dim"}


class Served:
    """The model, its predictor with the mix's buckets, and ``rows`` host
    rows of each modality to cut requests from."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device,
                 rows: int):
        from aecf_tpu_torch.serve import FusionPredictor

        self.cfg = cfg
        self.weights = models.vision_language_weights(cfg, seed, device)
        self.model = models.vision_language_model(cfg, self.weights)
        model = self.model
        self.predictor = FusionPredictor(
            lambda image, text: model(image, text),
            modality_names=("image", "text"),
            buckets=tuple(traffic["buckets"]), device=device)
        g = models.generator(seed, "inputs", device)
        for m, width in WIDTH.items():
            setattr(self, m, torch.randn((rows, cfg[width]), generator=g,
                                         device=device).cpu().numpy())

    def request(self, start: int, n: int, subset: str) -> Dict[str, np.ndarray]:
        rows = slice(start, start + n)
        return {m: getattr(self, m)[rows] for m in SUBSETS[subset]}

    def warm(self) -> None:
        """The predictor at every bucket under every modality subset,
        twice."""
        for b in self.predictor.buckets:
            for subset in SUBSETS:
                for _ in range(2):
                    self.predictor(**self.request(0, b, subset))

    def release(self) -> None:
        self.model = self.predictor = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def _inputs(served: Served, answers, device):
    """The answered requests' rows as the predictor got them, a missing
    modality as zeros, concatenated."""
    streams = {"image": [], "text": []}
    for start, n, subset, _ in answers:
        req = served.request(start, n, subset)
        for m, parts in streams.items():
            parts.append(req.get(m, np.zeros(
                (n, served.cfg[WIDTH[m]]), np.float32)))
    return [torch.from_numpy(np.concatenate(streams[m])).to(device)
            for m in ("image", "text")]


def check(served: Served, answers: Sequence[Tuple[int, int, str, np.ndarray]],
          device) -> float:
    """The widest gap between an answered probability and the reference's
    over ``answers`` (``(start, rows, subset, answer)`` each)."""
    if not answers:
        return float("inf")
    got = torch.from_numpy(np.concatenate([a[3] for a in answers])).to(device)
    want = ref.probabilities(served.weights, *_inputs(served, answers, device),
                             "f32")
    return float((got.float() - want).abs().max())


def control(served: Served, answers, precision: str, device) -> float:
    """:func:`check` with the reference at ``precision`` in the program's
    place."""
    image, text = _inputs(served, answers, device)
    got = ref.probabilities(served.weights, image, text, precision)
    want = ref.probabilities(served.weights, image, text, "f32")
    return float((got - want).abs().max())
