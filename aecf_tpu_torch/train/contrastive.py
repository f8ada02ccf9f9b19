"""Large-batch contrastive fusion (BASELINE config 5): the AECF pool's fused
embedding aligned with a held-out target projection of the same sample by
InfoNCE over the global batch, data-parallel.

Port of the JAX package's ``examples/train_contrastive.py`` ``local_step``:

* the pool trains with per-instance entropy gating (the curriculum mask,
  ``base_mask_prob``), the features frozen (``kv_grad=False``);
* ``z = proj(pooled)`` and ``t = target_proj(target)``, each normalised as
  ``x / (‖x‖ + 1e-8)``;
* every rank's ``t`` is gathered, so each rank's rows see the whole global
  batch's targets as negatives (CLIP's recipe): ``logits = z t_allᵀ / τ``,
  the label of local row ``b`` on shard ``s`` is ``s·B_local + b``, and the
  loss is the mean cross-entropy over the rows, scaled by ``1/axis_size``;
* the gradients of that scaled loss are summed over the axis with the loss
  and the info means (one all-reduce over one flat buffer), so they are
  the gradients of the global mean, and every rank takes the same
  optimizer update.

The gather is :func:`aecf_tpu_torch.parallel.collectives.all_gather_rows`:
an all-gather forward and a reduce-scatter of the cotangent backward, so
``t``'s gradient reaches the rank that owns the row.

The pool runs the two-pass kernels through the one-pass step's custom-loss
route (:func:`aecf_tpu_torch.kernels.fused_pool_train_step` with
``row_loss=``): the training forward (its mask drawn from seed words in
device memory), the projections and the gather in torch under autograd,
InfoNCE's loss and its gradient in one kernel
(:func:`aecf_tpu_torch.kernels.infonce_rows`, over the raw product ``z
t_allᵀ``, which it overwrites with the gradient), the products back to
``z`` and ``t_all`` in torch, autograd through the projections and the
gather, then the pool's backward kernel on ``d_out``.  The one-pass
chain's built-in losses are row-local, which InfoNCE over gathered targets
is not.  On the CPU every kernel runs its plain version.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.init import init_attention_pool_params, init_fusion_query
from ..kernels import (
    fused_pool_train_step,
    infonce_rows,
    shared_query_bwd,
    shared_query_fwd,
)
from ..models.layers import init_linear
from ..parallel.collectives import all_gather_rows
from .update import _axis, _graph_chunk, _make_step, _pool_streams

__all__ = [
    "init_contrastive_params",
    "make_contrastive_scan_train_step",
    "make_contrastive_train_step",
]

# z / (‖z‖ + eps), as the JAX example normalises
_NORM_EPS = 1e-8


def init_contrastive_params(
    generator: Optional[torch.Generator],
    embed_dim: int,
    proj_dim: int = 256,
    *,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, Any]:
    """``{'pool', 'query', 'proj', 'target_proj'}``: the attention pool and
    its fusion query, then two ``E → proj_dim`` linear layers
    (``nn.Linear``'s layout and initial distribution), drawn in that order
    from ``generator`` (on its device) and put on ``device``."""
    return {
        "pool": init_attention_pool_params(generator, embed_dim).to(device),
        "query": nn.Parameter(
            init_fusion_query(generator, embed_dim).to(device)),
        "proj": init_linear(generator, embed_dim, proj_dim).to(device),
        "target_proj": init_linear(generator, embed_dim, proj_dim).to(device),
    }


def _normalise(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + _NORM_EPS)


def _make_local_step(*, axis, temperature, precision, base_mask_prob,
                     entropy_target, min_active) -> Callable:
    """``(params, kv, target, generator, loss_scale, **staged) -> (loss,
    info, grads)``, grads in :func:`~.update.param_leaves` order;
    ``seed_words`` (a device tensor, the graph's) goes on to
    :func:`~aecf_tpu_torch.kernels.fused_pool_train_step`."""
    group = None if axis is None else axis.group
    shard = 0 if axis is None else axis.index

    def local_step(params, kv, target, generator, loss_scale, **staged):
        proj, tproj = params["proj"], params["target_proj"]
        leaves = list(proj.parameters()) + list(tproj.parameters())
        head_grads = []

        def infonce(out, tgt):
            # (row losses, d_out): the pool's backward kernel takes d_out
            B = out.shape[0]
            with torch.enable_grad():
                x = out.detach().requires_grad_(True)
                z = _normalise(F.linear(x, proj.weight, proj.bias))
                t = _normalise(F.linear(tgt, tproj.weight, tproj.bias))
                t_all = all_gather_rows(t, group)
            zd, td = z.detach(), t_all.detach()
            # infonce_rows overwrites the raw product with the gradient of
            # the losses with respect to it
            raw = zd @ td.T
            rows = infonce_rows(raw, label_offset=shard * B,
                                temperature=temperature, scale=loss_scale / B)
            grads = torch.autograd.grad([z, t_all], [x] + leaves,
                                        grad_outputs=[raw @ td, raw.T @ zd])
            head_grads.extend(grads[1:])
            return rows, grads[0]

        loss, d_pool, d_query, _, info = fused_pool_train_step(
            params["pool"], params["query"], kv, generator=generator,
            training=True, base_mask_prob=base_mask_prob,
            entropy_target=entropy_target, min_active=min_active,
            precision=precision, kv_grad=False, row_loss=infonce,
            row_extras=(target,), loss_scale=loss_scale, **staged)
        names = [n for n, _ in params["pool"].named_parameters()]
        grads = [d_pool[n] for n in names] + [d_query] + head_grads
        return loss, info, grads

    return local_step


def _axis_and_step(mesh, axis_name, **kw):
    axis = _axis(mesh, axis_name)
    return axis, _make_local_step(axis=axis, **kw)


def make_contrastive_train_step(
    *,
    temperature: float = 0.1,
    precision: str = "default",
    base_mask_prob: float = 0.15,
    entropy_target: float = 0.7,
    min_active: int = 1,
    mesh: Optional[Any] = None,
    axis_name: str = "data",
) -> Callable:
    """One contrastive update ``(state, kv (B, M, E), target (B, E),
    generator) -> (state, loss, info)``.

    ``state`` is a :class:`TrainState` over :func:`init_contrastive_params`'
    leaves (:func:`~.update.param_leaves`); ``generator`` is a CPU
    ``torch.Generator`` or a step's two seed words.  ``precision`` is the
    pool kernels' (``'default'``: TF32 products on the card) and the
    projections' matmul mode.  ``mesh=`` makes the step data-parallel over
    ``axis_name``: each rank passes its own rows and the same generator or
    seed words (its draw folds its axis index in), the targets are gathered
    across the axis, and loss and info come back as global means."""
    axis, local_step = _axis_and_step(
        mesh, axis_name, temperature=temperature, precision=precision,
        base_mask_prob=base_mask_prob, entropy_target=entropy_target,
        min_active=min_active)
    return _make_step(local_step, 1, axis)


def make_contrastive_scan_train_step(
    *,
    temperature: float = 0.1,
    precision: str = "default",
    base_mask_prob: float = 0.15,
    entropy_target: float = 0.7,
    min_active: int = 1,
    mesh: Optional[Any] = None,
    axis_name: str = "data",
) -> Callable:
    """K contrastive updates a call: ``(state, kv, target, rng) -> (state,
    losses (K,), infos)``, ``kv`` ``(K, B, M·E)`` (or ``(K, B, M, E)``) and
    ``target`` ``(K, B, E)``, this rank's rows under a mesh.  Step ``i`` of
    shard ``s`` draws from ``fold_seed_words(fold_seed_words(rng, state.step
    + i), s)``; ``infos`` holds each info entry's per-step (global) means.
    Keywords as :func:`make_contrastive_train_step`.

    On the card, without a mesh or over an NCCL group, the K updates are
    ONE CUDA graph a call, captured under the span ``contrastive.capture``
    (the graph route of :mod:`aecf_tpu_torch.train.update`, which says
    what is captured and what recaptures): the targets staged beside the
    features, and the all-gather, its reduce-scatter and the gradients'
    all-reduce captured with the kernels.  Each replay adds K to
    ``shared_query_fwd.launches``, ``shared_query_bwd.launches`` and
    ``infonce_rows.launches`` and,
    over a mesh, K of each collective to
    :data:`aecf_tpu_torch.parallel.collectives.counted`.  On the CPU and
    over gloo the K updates run eagerly."""
    axis, local_step = _axis_and_step(
        mesh, axis_name, temperature=temperature, precision=precision,
        base_mask_prob=base_mask_prob, entropy_target=entropy_target,
        min_active=min_active)
    return _graph_chunk(
        local_step, axis,
        chains=(shared_query_fwd, shared_query_bwd, infonce_rows),
        capture_span="contrastive.capture",
        streams=_pool_streams(("target", "width")))
