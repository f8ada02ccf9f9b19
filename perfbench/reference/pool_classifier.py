"""The AECF pool classifier's training step in plain PyTorch: the X3
protocol (frozen features → one-query attention pool → linear head → mean
BCE → AdamW), with the curriculum mask's draw, for a run of steps.

It follows the published definition, not the program's restructured one:
the Q, K and V projections of every row, ``softmax(q·k / √E)`` over the M
modalities, the context, the out projection, the head.  The mask
(entropy-scaled keep probability, one Philox draw, at least one modality
kept) changes only the masked weights, never the pooled output: the
reference's quirk Q1.  Gradients by autograd, AdamW by its formula.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from . import philox
from .common import matmul_mode, mm

# The leaves in the program's order: the pool's four, the query, the head.
LEAVES = ("in_proj_weight", "out_proj_weight", "in_proj_bias",
          "out_proj_bias", "query", "head_w", "head_b")


def forward(p: Dict[str, torch.Tensor], kv: torch.Tensor, precision: str):
    """``(logits (B, C), attention weights (B, M))`` for kv ``(B, M, E)``."""
    B, M, E = kv.shape
    wq, wk, wv = p["in_proj_weight"].chunk(3, dim=0)
    bq, bk, bv = p["in_proj_bias"].chunk(3, dim=0)
    q = mm(p["query"].reshape(1, E), wq.T, precision) + bq
    rows = kv.reshape(B * M, E)
    k = (mm(rows, wk.T, precision) + bk).reshape(B, M, E)
    v = (mm(rows, wv.T, precision) + bv).reshape(B, M, E)
    scores = (k * q.reshape(1, 1, E)).sum(-1) / math.sqrt(E)
    a = torch.softmax(scores, dim=-1)
    ctx = (a[..., None] * v).sum(1)
    out = mm(ctx, p["out_proj_weight"].T, precision) + p["out_proj_bias"]
    logits = mm(out, p["head_w"], precision) + p["head_b"]
    return logits, a


def mask(a: torch.Tensor, seed, mask_prob: float,
         min_active: int) -> torch.Tensor:
    """The curriculum mask (B, M) as 0/1 floats: keep with probability
    ``1 - mask_prob · H(a) / log M``; a row left with fewer than
    ``min_active`` modalities keeps its largest weights instead (the
    first of equal ones)."""
    B, M = a.shape
    ent = (-torch.xlogy(a, a).sum(-1)).clamp(0.0, math.log(M))
    keep = (1.0 - mask_prob * (ent / math.log(M)).clamp(0.0, 1.0)).clamp(
        0.0, 1.0)
    u = philox.uniforms(seed, B, M, device=a.device)
    m = (u < keep[:, None]).float()
    k = min(int(min_active), M)
    top = torch.sort(a, dim=-1, descending=True, stable=True).indices[:, :k]
    fallback = torch.zeros_like(a).scatter(-1, top, 1.0)
    return torch.where(m.sum(-1, keepdim=True) < k, fallback, m)


def adamw(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
          t: int, lr: float, wd: float, betas: Sequence[float],
          eps: float) -> None:
    """One decoupled-weight-decay Adam update of ``p`` in place."""
    b1, b2 = betas
    p.mul_(1.0 - lr * wd)
    m.mul_(b1).add_(g, alpha=1.0 - b1)
    v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
    m_hat = m / (1.0 - b1 ** t)
    v_hat = v / (1.0 - b2 ** t)
    p.sub_(lr * m_hat / (v_hat.sqrt() + eps))


def train(params: Dict[str, torch.Tensor], batches, *, rng, precision: str,
          optimizer: Dict, mask_prob: float, min_active: int,
          loss_rows: Optional[int] = None) -> Dict:
    """Run the steps of ``batches`` (``(kv (B, M, E), labels (B, C))``
    each; step ``i`` draws with ``fold(rng, i)``) from ``params`` (left
    untouched).  ``loss_rows`` takes the loss over the first rows alone: a
    fault, half the batch left out, for the readings that set the
    limits.  Returns per-step ``losses`` (K,), ``weights`` (K, B, M)
    and ``masks`` (K, B, M); the gradients of the first step and of the
    last as the optimizer got them (``grads_first``, ``grads_last``); the
    parameters after the last step (``params``)."""
    p = {k: params[k].detach().clone().float().requires_grad_(True)
         for k in LEAVES}
    state = {k: (torch.zeros_like(p[k]), torch.zeros_like(p[k]))
             for k in LEAVES}
    losses: List[torch.Tensor] = []
    weights, masks = [], []
    grads_first = grads = None
    with matmul_mode(precision):
        for t, (kv, labels) in enumerate(batches, start=1):
            logits, a = forward(p, kv.float(), precision)
            rows = slice(0, loss_rows)
            loss = F.binary_cross_entropy_with_logits(logits[rows],
                                                      labels[rows].float())
            g = torch.autograd.grad(loss, [p[k] for k in LEAVES])
            grads = dict(zip(LEAVES, (x.detach() for x in g)))
            if grads_first is None:
                grads_first = grads
            with torch.no_grad():
                a = a.detach()
                weights.append(a)
                masks.append(mask(a, philox.fold(rng, t - 1), mask_prob,
                                  min_active))
                for k in LEAVES:
                    adamw(p[k], grads[k], *state[k], t,
                          optimizer["lr"], optimizer["weight_decay"],
                          optimizer["betas"], optimizer["eps"])
            losses.append(loss.detach())
    return {
        "losses": torch.stack(losses),
        "weights": torch.stack(weights),
        "masks": torch.stack(masks),
        "grads_first": grads_first,
        "grads_last": grads,
        "params": {k: p[k].detach() for k in LEAVES},
    }
