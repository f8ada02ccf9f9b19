"""Tensor parallelism: attention pools sharded by heads over a ``'model'``
mesh axis.

Port of :mod:`aecf_tpu.parallel.tensor_parallel`.  JAX states the
Megatron column → row split as shardings and lets GSPMD insert the
collectives; here each rank holds its heads of every pool
(:class:`HeadShardedPool`) and the pool's forward makes the collectives
itself:

* ``in_proj_weight (3E, E)``: each rank keeps rows ``[r·E/n, (r+1)·E/n)``
  of each of the Q, K and V sub-matrices (its own in-bias slices with
  them) — whole heads when ``n`` divides the head count, so the scores,
  the softmax and each head's context are local;
* ``out_proj_weight (E, E)``: the matching columns; each rank's partial
  output is all-reduced, and ``out_proj_bias`` (replicated) added once;
* the pool's entropy, mask and ``info`` read the head-averaged weights: the
  local heads' weights ``(B, T, S)`` are summed across ranks and divided by
  H.

The two collectives are Megatron's autograd functions: "f" (identity
forward, all-reduce backward) where the replicated query and features
enter the sharded region, so the gradient of every replicated leaf is the
whole one on every rank, and "g" (all-reduce forward, identity backward)
where its partial sums leave it.  Everything that is not an attention pool
(encoders, classifier, queries) stays replicated.  There is no kernel on
this route: the shared-query kernels need every head for the entropy.

Data × tensor parallelism runs on a 2-D ``('data', 'model')`` mesh
(:func:`~aecf_tpu_torch.parallel.data_model_mesh`): each data shard's rows
on every rank of its model group; gradients (of sharded and replicated
leaves alike) are reduced over ``data`` only.
"""

from __future__ import annotations

import copy
import functools
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn
from torch.distributed.tensor import Replicate, Shard

from ..core.attention import AttentionPoolParams, _merge_masks
from ..core.masking import curriculum_mask
from ..core.precision import run_at
from ..train.trainer import bce_with_logits_loss
from ..train.update import _eager_chunk
from .collectives import MeshAxis, all_reduce_, gather_rows
from .data_parallel import _mesh_step

__all__ = [
    "HeadShardedPool",
    "attention_pool_pspecs",
    "make_tp_scan_train_step",
    "make_tp_train_step",
    "shard_params_tp",
    "tp_param_specs",
]

_IN = ("in_proj_weight", "in_proj_bias")


def attention_pool_pspecs(
    params: Optional[AttentionPoolParams] = None,
) -> Dict[str, Any]:
    """Each pool parameter's placement along the model axis, by name:
    in-projection rows sharded (``Shard(0)``, per Q/K/V sub-matrix),
    out-projection columns sharded (``Shard(1)``), out bias replicated;
    ``None`` for a bias ``params`` lacks."""
    has_in = params is None or params.in_proj_bias is not None
    has_out = params is None or params.out_proj_bias is not None
    return {
        "in_proj_weight": Shard(0),
        "out_proj_weight": Shard(1),
        "in_proj_bias": Shard(0) if has_in else None,
        "out_proj_bias": Replicate() if has_out else None,
    }


def tp_param_specs(params: Any) -> Any:
    """The placements of ``params``, in its structure: for a module, one
    per ``named_parameters()`` name; for a ``{'pool', 'query'[, 'head']}``
    dict, the same dict of placements.  Attention pools are head-sharded
    (:func:`attention_pool_pspecs`), every other leaf replicated."""
    if isinstance(params, AttentionPoolParams):
        return attention_pool_pspecs(params)
    if isinstance(params, nn.Module):
        specs = {}
        for prefix, mod in params.named_modules():
            if isinstance(mod, AttentionPoolParams):
                for name, spec in attention_pool_pspecs(mod).items():
                    if spec is not None:
                        specs[f"{prefix}.{name}" if prefix else name] = spec
        return {name: specs.get(name, Replicate())
                for name, _ in params.named_parameters()}
    if isinstance(params, dict):
        return {k: tp_param_specs(v) for k, v in params.items()}
    return None if params is None else Replicate()


def _shard(name: str, full: torch.Tensor, n: int, r: int) -> torch.Tensor:
    """Rank ``r`` of ``n``'s slice of pool parameter ``name``."""
    if name in _IN:
        rows = full.shape[0] // 3 // n
        part = full.reshape((3, n, rows) + tuple(full.shape[1:]))[:, r]
        return part.reshape((3 * rows,) + tuple(full.shape[1:])).clone()
    if name == "out_proj_weight":
        cols = full.shape[1] // n
        return full[:, r * cols:(r + 1) * cols].clone()
    return full.clone()


def _unshard(name: str, parts: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_shard` over every rank's slice, stacked in rank
    order on a leading axis."""
    n, rest = parts.shape[0], tuple(parts.shape[2:])
    if name in _IN:
        return parts.reshape((n, 3, -1) + rest).transpose(0, 1).reshape(
            (-1,) + rest)
    if name == "out_proj_weight":
        return parts.transpose(0, 1).reshape(parts.shape[1], -1)
    return parts[0]


class HeadShardedPool(AttentionPoolParams):
    """This rank's heads of an attention pool (see the module docstring):
    the Q/K/V rows and out-projection columns of ``axis.index`` of
    ``axis.size``, the out bias whole.  :func:`aecf_tpu_torch.ops.
    fusion_pool` runs it through :func:`sharded_fusion_pool`."""

    def __init__(self, full: AttentionPoolParams, axis: MeshAxis):
        E = full.out_proj_weight.shape[0]
        if E % axis.size:
            raise ValueError(
                f"embed dim {E} not divisible by the model axis size "
                f"{axis.size}"
            )
        n, r = axis.size, axis.index
        sliced = {
            name: None if p is None else _shard(name, p.detach(), n, r)
            for name, p in (
                ("in_proj_weight", full.in_proj_weight),
                ("out_proj_weight", full.out_proj_weight),
                ("in_proj_bias", full.in_proj_bias),
                ("out_proj_bias", full.out_proj_bias),
            )
        }
        super().__init__(**sliced)
        self.axis = axis

    def gathered(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor of which ``local`` is this rank's slice laid out
        as parameter ``name`` (the parameter, or optimizer state of its
        shape); every rank of the model axis calls it."""
        if name == "out_proj_bias":
            return local.detach()
        return _unshard(name, gather_rows(local.detach()[None],
                                          self.axis.group))

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole tensor ``full`` of ``name``."""
        return _shard(name, full, self.axis.size, self.axis.index)


class _CopyToModel(torch.autograd.Function):
    """Megatron's "f": identity forward, all-reduce of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's "g": all-reduce forward, identity gradient (not
    ``torch.distributed.nn.functional.all_reduce``, whose backward
    all-reduces too and would multiply the replicated leaves' gradients by
    the axis size)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sharded_fusion_pool(
    params: HeadShardedPool,
    query: torch.Tensor,
    kv: torch.Tensor,
    *,
    num_heads: int,
    generator=None,
    training: bool = False,
    base_mask_prob: float = 0.15,
    entropy_target: float = 0.7,
    min_active: int = 1,
    key_padding_mask: Optional[torch.Tensor] = None,
    precision: str = "highest",
):
    """:func:`aecf_tpu_torch.ops.fusion_pool`'s torch route over this
    rank's heads: ``(out, weights, masked, info)`` equal on every rank of
    the model axis, and to the unsharded pool's up to the order of the
    sums."""
    group, n = params.axis.group, params.axis.size
    if num_heads % n:
        raise ValueError(
            f"num_heads {num_heads} not divisible by the model axis size {n}"
        )
    B, S, E = kv.shape
    heads, dh = num_heads // n, E // num_heads
    query = _CopyToModel.apply(query, group)
    q_in = query.expand(B, *query.shape[1:]) if query.shape[0] == 1 else query
    kv_in = _CopyToModel.apply(kv, group)
    T = q_in.shape[1]

    def proj(x, w, b):
        y = torch.einsum("bse,fe->bsf", x, w)
        return y if b is None else y + b

    def local_heads(qx, x, in_w, in_b, out_w):
        w_q, w_k, w_v = in_w.chunk(3, dim=0)
        b_q = b_k = b_v = None
        if in_b is not None:
            b_q, b_k, b_v = in_b.chunk(3, dim=0)
        q = proj(qx, w_q, b_q).reshape(B, T, heads, dh)
        k = proj(x, w_k, b_k).reshape(B, S, heads, dh)
        v = proj(x, w_v, b_v).reshape(B, S, heads, dh)
        scores = torch.einsum("bthd,bshd->bhts", q * float(dh) ** -0.5, k)
        attn = torch.softmax(_merge_masks(scores, key_padding_mask, None),
                             dim=-1)
        context = torch.einsum("bhts,bshd->bthd", attn, v).reshape(
            B, T, heads * dh)
        return torch.einsum("bte,fe->btf", context, out_w), attn

    # the collectives stay outside the block: only the heads' products
    # run (forward and backward) at precision's mode
    partial, attn = run_at(precision, local_heads, q_in, kv_in,
                           params.in_proj_weight, params.in_proj_bias,
                           params.out_proj_weight)
    out = _ReduceFromModel.apply(partial, group)
    if params.out_proj_bias is not None:
        out = out + params.out_proj_bias
    weights = _ReduceFromModel.apply(attn.sum(dim=1), group) / num_heads
    masked, info = curriculum_mask(
        weights,
        generator=generator,
        training=training,
        base_mask_prob=base_mask_prob,
        entropy_target=entropy_target,
        min_active=min_active,
    )
    return out, weights, masked.detach(), info


def shard_params_tp(mesh, params: Any, *, model_axis: str = "model") -> Any:
    """A copy of ``params`` (a module, a pool, or a ``{'pool', 'query'[,
    'head']}`` dict) with every attention pool replaced by this rank's
    :class:`HeadShardedPool` over ``model_axis``; every other leaf is
    copied whole.  Every rank must start from the same ``params``; the
    caller's stay as they are."""
    axis = MeshAxis(mesh, model_axis)
    if axis.group is None:
        raise ValueError(
            f"mesh axes {getattr(mesh, 'mesh_dim_names', None)} have no "
            f"{model_axis!r} axis"
        )
    params = copy.deepcopy(params)
    if isinstance(params, AttentionPoolParams):
        return HeadShardedPool(params, axis)
    if isinstance(params, dict):
        params["pool"] = HeadShardedPool(params["pool"], axis)
        return params
    for mod in list(params.modules()):
        for name, child in list(mod.named_children()):
            if isinstance(child, AttentionPoolParams):
                setattr(mod, name, HeadShardedPool(child, axis))
    return params


def sharded_pools(params: Any):
    """``(prefix, pool)`` of every :class:`HeadShardedPool` in ``params``:
    ``prefix`` names its entries in the checkpoint's parameter state
    (``('module', 'pool.')`` for a module's ``pool``, ``('pool', '')`` for
    a pool-classifier dict's)."""
    if isinstance(params, dict):
        pool = params["pool"]
        return [(("pool", ""), pool)] if isinstance(pool, HeadShardedPool) else []
    return [(("module", f"{name}." if name else ""), mod)
            for name, mod in params.named_modules()
            if isinstance(mod, HeadShardedPool)]


def make_tp_train_step(
    apply_fn: Callable[..., Any],
    mesh,
    *,
    data_axis: Optional[str] = "data",
    loss_fn: Callable[[torch.Tensor, torch.Tensor],
                      torch.Tensor] = bce_with_logits_loss,
    accum_steps: int = 1,
) -> Callable:
    """A TP (optionally data × TP) ``(state, images, texts, labels, rng)
    -> (state, loss, info)`` step.

    ``state.params`` come from :func:`shard_params_tp` (build the optimizer
    over their leaves after sharding).  Where ``data_axis`` names an axis
    of ``mesh``, ``images``, ``texts`` and ``labels`` are this data shard's
    rows (:func:`~aecf_tpu_torch.parallel.shard_batch`), the step folds the
    data index into the seed words and reduces the gradients over that
    axis, as :func:`~aecf_tpu_torch.parallel.make_dp_train_step` does;
    with ``data_axis=None`` (or a mesh without it) every rank sees the
    whole batch and the seed words as given.  Loss and info come back as
    global means; the optimizer is ``state.optimizer``."""
    return _mesh_step(apply_fn, MeshAxis(mesh, data_axis), loss_fn,
                      accum_steps)


def make_tp_scan_train_step(
    apply_fn: Callable[..., Any],
    mesh,
    *,
    data_axis: Optional[str] = "data",
    loss_fn: Callable[[torch.Tensor, torch.Tensor],
                      torch.Tensor] = bce_with_logits_loss,
    accum_steps: int = 1,
) -> Callable:
    """The K-step form of :func:`make_tp_train_step`, its batches staged
    ``(K, B, ...)`` and its K steps run eagerly in one call; step ``i``
    draws from ``fold_seed_words(rng, state.step + i)`` (then folded with
    the data index), so chunks chain and resume like single steps."""
    return functools.partial(_eager_chunk, make_tp_train_step(
        apply_fn, mesh, data_axis=data_axis, loss_fn=loss_fn,
        accum_steps=accum_steps))
