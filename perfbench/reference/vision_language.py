"""The vision-language model's eval forward in plain PyTorch: each
modality projected to the shared width, the two stacked, pooled by one
learnable query (``softmax(q·k / √E)`` over the two, the context, the out
projection), classified, and the sigmoid.  A missing modality arrives as
zeros, as the served requests' do."""

from __future__ import annotations

import math
from typing import Dict

import torch

from .common import matmul_mode, mm


@torch.no_grad()
def probabilities(p: Dict[str, torch.Tensor], image: torch.Tensor,
                  text: torch.Tensor, precision: str,
                  block: int = 8192) -> torch.Tensor:
    """Probabilities ``(B, classes)`` of rows ``image (B, img)``, ``text
    (B, txt)``, computed ``block`` rows at a time."""
    outs = []
    with matmul_mode(precision):
        for s in range(0, image.shape[0], block):
            outs.append(_block(p, image[s:s + block].float(),
                               text[s:s + block].float(), precision))
    return torch.cat(outs)


def _block(p, image, text, precision):
    B = image.shape[0]
    E = p["pool.out_proj_weight"].shape[0]
    img = mm(image, p["img_proj.weight"].T, precision) + p["img_proj.bias"]
    txt = mm(text, p["txt_proj.weight"].T, precision) + p["txt_proj.bias"]
    kv = torch.stack([img, txt], dim=1)  # (B, 2, E)
    wq, wk, wv = p["pool.in_proj_weight"].chunk(3, dim=0)
    bq, bk, bv = p["pool.in_proj_bias"].chunk(3, dim=0)
    q = mm(p["fusion_query"].reshape(1, E), wq.T, precision) + bq
    rows = kv.reshape(B * 2, E)
    k = (mm(rows, wk.T, precision) + bk).reshape(B, 2, E)
    v = (mm(rows, wv.T, precision) + bv).reshape(B, 2, E)
    a = torch.softmax((k * q.reshape(1, 1, E)).sum(-1) / math.sqrt(E), dim=-1)
    ctx = (a[..., None] * v).sum(1)
    out = mm(ctx, p["pool.out_proj_weight"].T, precision) \
        + p["pool.out_proj_bias"]
    logits = mm(out, p["classifier.weight"].T, precision) + p["classifier.bias"]
    return torch.sigmoid(logits)
