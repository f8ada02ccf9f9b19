"""Large-batch contrastive fusion's training step in plain PyTorch (BASELINE
config 5): the GLOBAL step over every shard's rows in one process, for a
run of steps.

Per shard ``s`` of ``S`` and step ``t``: the AECF pool written out from its
equations — the Q, K and V projections of every row, ``softmax(q·k / √E)``
over the M modalities, the context, the out projection — then ``z =
proj(pooled)`` and ``t = target_proj(target)``, each ``x / (‖x‖ + 1e-8)``.
Every shard's targets are concatenated, so each shard's rows take the whole
global batch as negatives: ``logits_s = z_s t_allᵀ / τ``, row ``b``'s label
``s·B + b``.  The loss is the mean cross-entropy over all rows (the mean of
the shards' means, which the program's ``1/S``-scaled shard losses summed
over the axis give); gradients by autograd through the concatenation,
AdamW by its formula.  The curriculum mask (entropy-scaled keep
probability, one Philox draw with the shard's seed words
``fold(fold(rng, t), s)``, at least ``min_active`` kept, the weights
renormalised) changes only the masked weights, never the pooled output
(the reference's quirk Q1).

Departures from the JAX package's ``examples/train_contrastive.py``:

* seed words: a step's draw folds the run's seed with the global step, then
  with the shard (``philox.fold``), where the example keys step ``i`` with
  ``jax.random.key(i)`` and folds in the axis index; the mask's bits are
  the port's Philox draw per (row, group of four modalities), not JAX's;
* weights come from the benchmark's seed in torch's initial distributions,
  not from ``jax.random.key(0)``; the features and targets are drawn as the
  example draws them (``base + 0.5·N`` a modality, ``base + 0.3·N``);
* every product runs at the stated precision (``'f32'``: IEEE float32,
  TF32 off), where the program runs the configuration's ``'default'``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import philox
from .common import matmul_mode, mm
from .pool_classifier import adamw, mask

# The leaves in the program's order: the pool's four, the query, then the
# two projections' weight and bias.
LEAVES = ("in_proj_weight", "out_proj_weight", "in_proj_bias",
          "out_proj_bias", "query", "proj_w", "proj_b", "target_proj_w",
          "target_proj_b")

NORM_EPS = 1e-8


def pool(p: Dict[str, torch.Tensor], kv: torch.Tensor, precision: str
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(pooled (B, E), attention weights (B, M))`` for kv ``(B, M, E)``."""
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
    return mm(ctx, p["out_proj_weight"].T, precision) + p["out_proj_bias"], a


def _project(x, w, b, precision) -> torch.Tensor:
    y = mm(x, w.T, precision) + b
    return y / (torch.linalg.vector_norm(y, dim=-1, keepdim=True) + NORM_EPS)


def loss(p: Dict[str, torch.Tensor], shards, *, temperature: float,
         precision: str, loss_rows: Optional[int] = None,
         local_negatives: bool = False):
    """``(global mean InfoNCE, [each shard's attention weights (B, M)])``
    over ``shards`` (``(kv (B, M, E), target (B, E))`` each).  Faults, for
    the readings that set the limits: ``loss_rows`` takes each shard's
    loss over its first rows alone; ``local_negatives`` gives each shard
    its own targets only."""
    zs, ts, weights = [], [], []
    for kv, target in shards:
        out, a = pool(p, kv.float(), precision)
        zs.append(_project(out, p["proj_w"], p["proj_b"], precision))
        ts.append(_project(target.float(), p["target_proj_w"],
                           p["target_proj_b"], precision))
        weights.append(a)
    t_all = torch.cat(ts)
    means = []
    for s, z in enumerate(zs):
        B = z.shape[0]
        negatives = ts[s] if local_negatives else t_all
        logits = mm(z, negatives.T, precision) / temperature
        labels = torch.arange(B, device=z.device)
        if not local_negatives:
            labels = labels + s * B
        rows = slice(0, loss_rows)
        means.append(F.cross_entropy(logits[rows], labels[rows]))
    return torch.stack(means).mean(), weights


def train(params: Dict[str, torch.Tensor], batches: Sequence[List], *, rng,
          precision: str, optimizer: Dict, temperature: float,
          mask_prob: float, min_active: int, loss_rows: Optional[int] = None,
          local_negatives: bool = False,
          unfolded_masks: bool = False) -> Dict:
    """Run the global steps of ``batches`` (step ``t``: a list over the
    shards of ``(kv (B, M, E), target (B, E))``) from ``params`` (left
    untouched).  ``unfolded_masks``: a fault, every shard's masks drawn
    from the step's words unfolded (the same on every rank).  Returns
    per-step ``losses`` (K,), ``weights`` and ``masks`` (K, S, B, M), the
    first and last steps' gradients (``grads_first``, ``grads_last``) and
    the parameters after the last step (``params``)."""
    p = {k: params[k].detach().clone().float().requires_grad_(True)
         for k in LEAVES}
    state = {k: (torch.zeros_like(p[k]), torch.zeros_like(p[k]))
             for k in LEAVES}
    losses, weights, masks = [], [], []
    grads_first = grads = None
    with matmul_mode(precision):
        for t, shards in enumerate(batches, start=1):
            value, ws = loss(p, shards, temperature=temperature,
                             precision=precision, loss_rows=loss_rows,
                             local_negatives=local_negatives)
            g = torch.autograd.grad(value, [p[k] for k in LEAVES])
            grads = dict(zip(LEAVES, (x.detach() for x in g)))
            if grads_first is None:
                grads_first = grads
            with torch.no_grad():
                step_words = philox.fold(rng, t - 1)
                drawn = []
                for s, a in enumerate(ws):
                    words = step_words if unfolded_masks else philox.fold(
                        step_words, s)
                    drawn.append(mask(a.detach(), words, mask_prob,
                                      min_active))
                weights.append(torch.stack([a.detach() for a in ws]))
                masks.append(torch.stack(drawn))
                for k in LEAVES:
                    adamw(p[k], grads[k], *state[k], t,
                          optimizer["lr"], optimizer["weight_decay"],
                          optimizer["betas"], optimizer["eps"])
            losses.append(value.detach())
    return {
        "losses": torch.stack(losses),
        "weights": torch.stack(weights),
        "masks": torch.stack(masks),
        "grads_first": grads_first,
        "grads_last": grads,
        "params": {k: p[k].detach() for k in LEAVES},
    }
