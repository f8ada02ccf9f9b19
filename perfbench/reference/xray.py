"""The AECF paper's chest X-ray classifier trained in plain PyTorch: the
reference's ``AECFModel`` (github.com/leochlon/aecf,
``xrays/train_xrays_example.py``) after curriculum activation — missing
images and reports simulated, two ``Linear → ReLU → Dropout(0.1)``
encoders, a four-head attention pool with entropy-driven curriculum
masking, three dense routes chosen per row by presence, a ``512 → 256 →
C`` classifier with a second dropout — then mean BCE and AdamW, for a run
of steps.

It follows the published definition: every head's Q, K and V projections
of every row, ``softmax(q_h · k_h / √(E/H))`` over the two modalities, the
heads' context, the out projection.  The mask changes only the masked
weights, never the output (the reference's quirk Q1).  Gradients by
autograd, AdamW by its formula (``pool_classifier.adamw``).

The draws, keyed by step ``s``'s words ``fold(rng, s)``: site ``n`` (1,
2, … in the order the forward draws) is either a block of uniforms, ``(r,
c)`` word ``c % 4`` of Philox at counter ``(r, c // 4, n, 0)`` (the top 24
bits over 2**24), or a sub-key ``fold(words, n)``.  The sites: the
missing-modality block ``(B, 3)`` (column 0 drops the image where below
``missing_prob``, column 1 the text, column 2 keeps the image where above
0.5 when both would drop), the image encoder's and the text encoder's
dropout ``(B, hidden)``, the mask's key (its uniforms at tag 0), the
classifier's dropout ``(B, hidden)``; dropout keeps an element where its
uniform is below ``1 - rate``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from . import philox
from .common import matmul_mode, mm
from .pool_classifier import adamw

PRESENCE_EPS = 1e-6
DROP_RATE = 0.1
EPS = 1e-8


def uniforms(words, rows: int, cols: int, tag: int, device) -> torch.Tensor:
    """(rows, cols) uniforms of site ``tag`` keyed by ``words``."""
    groups = (cols + 3) // 4
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    g = torch.arange(groups, dtype=torch.int64, device=device)[None, :]
    r, g = torch.broadcast_tensors(r, g)
    zero = torch.zeros_like(r)
    out = philox.philox((r, g, zero + tag, zero), words)
    bits = torch.stack(out, dim=-1).reshape(rows, groups * 4)[:, :cols]
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _linear(p, name: str, x: torch.Tensor, precision: str) -> torch.Tensor:
    return mm(x, p[f"{name}.weight"].T, precision) + p[f"{name}.bias"]


def forward(p: Dict[str, torch.Tensor], image: torch.Tensor,
            text: torch.Tensor, words, cfg: Dict, precision: str,
            missing: bool = True) -> Dict:
    """One training forward: ``logits``, the pool's head-averaged
    ``weights`` (B, 2) and curriculum ``mask`` (B, 2), and the ``drops``:
    every missing-modality and dropout bit, in site order."""
    B, dev = image.shape[0], image.device
    E, H = cfg["hidden_dim"], cfg["num_heads"]
    site, drops = 0, []

    def next_site():
        nonlocal site
        site += 1
        return site

    def dropout(x):
        keep = uniforms(words, B, x.shape[1], next_site(), dev) < (
            1.0 - DROP_RATE)
        drops.append(keep)
        return torch.where(keep, x / (1.0 - DROP_RATE), 0.0)

    if missing:
        u = uniforms(words, B, 3, next_site(), dev)
        drop_img = u[:, 0] < cfg["missing_prob"]
        drop_txt = u[:, 1] < cfg["missing_prob"]
        both = drop_img & drop_txt
        keep_img = u[:, 2] > 0.5
        drop_img = torch.where(both, ~keep_img, drop_img)
        drop_txt = torch.where(both, keep_img, drop_txt)
        drops += [drop_img, drop_txt, keep_img]
        image = torch.where(drop_img[:, None], 0.0, image)
        text = torch.where(drop_txt[:, None], 0.0, text)
    img = dropout(torch.relu(_linear(p, "image_encoder", image, precision)))
    txt = dropout(torch.relu(_linear(p, "text_encoder", text, precision)))
    img_on = torch.linalg.vector_norm(image, dim=1) > PRESENCE_EPS
    txt_on = torch.linalg.vector_norm(text, dim=1) > PRESENCE_EPS

    # the pool: every head's projections of both modalities
    kv = torch.stack([img, txt], dim=1)  # (B, 2, E)
    wq, wk, wv = p["pool.in_proj_weight"].chunk(3, dim=0)
    bq, bk, bv = p["pool.in_proj_bias"].chunk(3, dim=0)
    dh = E // H
    q = (mm(p["fusion_query"].reshape(1, E), wq.T, precision) + bq
         ).reshape(H, dh)
    rows = kv.reshape(B * 2, E)
    k = (mm(rows, wk.T, precision) + bk).reshape(B, 2, H, dh)
    v = (mm(rows, wv.T, precision) + bv).reshape(B, 2, H, dh)
    scores = (k * q[None, None]).sum(-1) / math.sqrt(dh)  # (B, 2, H)
    a = torch.softmax(scores, dim=1)
    ctx = (a[..., None] * v).sum(1).reshape(B, E)
    pooled = mm(ctx, p["pool.out_proj_weight"].T, precision) \
        + p["pool.out_proj_bias"]
    weights = a.mean(dim=2)  # (B, 2)
    mask_words = philox.fold(words, next_site())
    mask = curriculum_mask(weights.detach(), mask_words, cfg)

    fused = _linear(p, "fusion_proj", pooled, precision)
    img_only = _linear(p, "image_proj", img, precision)
    txt_only = _linear(p, "text_proj", txt, precision)
    both_on = img_on & txt_on
    routed = torch.where(both_on[:, None], fused, torch.where(
        (img_on & ~txt_on)[:, None], img_only,
        torch.where((~img_on & txt_on)[:, None], txt_only, 0.0)))
    hidden = dropout(torch.relu(_linear(p, "classifier_hidden", routed,
                                        precision)))
    logits = _linear(p, "classifier_out", hidden, precision)
    return {"logits": logits, "weights": weights.detach(), "mask": mask,
            "drops": drops}


def curriculum_mask(w: torch.Tensor, words, cfg: Dict) -> torch.Tensor:
    """The curriculum mask (B, M) as booleans: the weights renormalised,
    keep with probability ``1 - base_mask_prob · H(w) / log M``; a row
    left with fewer than ``min_active`` modalities keeps its largest
    weights instead (the first of equal ones)."""
    B, M = w.shape
    w = torch.where(torch.isfinite(w), w, 0.0)
    s = w.sum(-1, keepdim=True)
    w = torch.where(s < EPS, 1.0 / M, w / torch.where(s < EPS, 1.0, s))
    ent = (-torch.xlogy(w, w).sum(-1)).clamp(0.0, math.log(M))
    keep = (1.0 - cfg["base_mask_prob"] * (ent / math.log(M)).clamp(
        0.0, 1.0)).clamp(0.0, 1.0)
    m = uniforms(words, B, M, 0, w.device) < keep[:, None]
    k = min(int(cfg["min_active"]), M)
    top = torch.sort(w, dim=-1, descending=True, stable=True).indices[:, :k]
    fallback = torch.zeros_like(m).scatter(-1, top, True)
    return torch.where(m.sum(-1, keepdim=True) < k, fallback, m)


def train(params: Dict[str, torch.Tensor], batches, *, rng, precision: str,
          cfg: Dict, lr: Optional[float] = None,
          loss_rows: Optional[int] = None, missing: bool = True) -> Dict:
    """Run the steps of ``batches`` (``(images, texts, labels)`` each; step
    ``i`` keyed by ``fold(rng, i)``) from ``params`` (left untouched).
    Faults for the readings that set the limits: ``loss_rows`` takes the
    loss over the first rows alone, ``missing=False`` skips the
    missing-modality simulation, ``lr=0`` leaves the state unchanged.
    Returns per-step ``losses`` (K,), ``weights`` and ``masks`` (K, B, 2)
    and ``drops`` (each step's bits, concatenated); the gradients of the
    first step and of the last (``grads_first``, ``grads_last``); the
    parameters after the last step (``params``)."""
    opt = cfg["optimizer"]
    lr = opt["lr"] if lr is None else lr
    names = list(params)
    p = {k: params[k].detach().clone().float().requires_grad_(True)
         for k in names}
    state = {k: (torch.zeros_like(p[k]), torch.zeros_like(p[k]))
             for k in names}
    losses: List[torch.Tensor] = []
    weights, masks, drops = [], [], []
    grads_first = grads = None
    with matmul_mode(precision):
        for t, (image, text, labels) in enumerate(batches, start=1):
            out = forward(p, image.float(), text.float(),
                          philox.fold(rng, t - 1), cfg, precision, missing)
            rows = slice(0, loss_rows)
            loss = F.binary_cross_entropy_with_logits(
                out["logits"][rows], labels[rows].float())
            g = torch.autograd.grad(loss, [p[k] for k in names])
            grads = dict(zip(names, (x.detach() for x in g)))
            if grads_first is None:
                grads_first = grads
            with torch.no_grad():
                for k in names:
                    adamw(p[k], grads[k], *state[k], t, lr,
                          opt["weight_decay"], opt["betas"], opt["eps"])
            losses.append(loss.detach())
            weights.append(out["weights"])
            masks.append(out["mask"])
            drops.append(torch.cat([d.reshape(-1) for d in out["drops"]]))
    return {
        "losses": torch.stack(losses),
        "weights": torch.stack(weights),
        "masks": torch.stack(masks),
        "drops": torch.stack(drops),
        "grads_first": grads_first,
        "grads_last": grads,
        "params": {k: p[k].detach() for k in names},
    }
