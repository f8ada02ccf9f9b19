"""Data-parallel training and inference over a mesh's ``'data'`` axis.

Port of :mod:`aecf_tpu.parallel.data_parallel` in PyTorch's SPMD idiom:
one process per device, each holding the whole parameters and its own
contiguous rows of the global batch.  A step computes this rank's
gradients of the local loss divided by the axis size (autograd here;
the one-pass step's direct gradients in
:func:`aecf_tpu_torch.train.make_pool_train_step`), sums them across the
axis in ONE all-reduce over one flat buffer that also carries the loss and
the info means, and runs the same optimizer update on every rank: the
global-batch-mean gradient, as JAX's ``psum`` of the ``1/axis_size``-scaled
loss gives it.  Each shard folds its axis index into the step's seed
words (:func:`~aecf_tpu_torch.kernels.draws.fold_seed_words`, JAX's
``fold_in(rng, axis_index)``), so draws are independent across shards and
the update stays identical on every rank.

Every rank calls these collectively, with the same arguments apart from
its own rows.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional, Union

import numpy as np
import torch
from torch import nn

from ..train.trainer import bce_with_logits_loss
from ..train.update import (
    TrainState,
    _data_axis,
    _eager_chunk,
    _fold_fresh,
    _loss_step,
    _make_step,
    _opt_tensors,
)
from .collectives import MeshAxis, broadcast_
from .mesh import default_device

__all__ = [
    "make_dp_eval_step",
    "make_dp_scan_train_step",
    "make_dp_train_step",
    "replicate",
    "shard_batch",
]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def shard_batch(
    mesh,
    batch: Any,
    *,
    axis_name: str = "data",
    device: Optional[Union[str, torch.device]] = None,
) -> Any:
    """This rank's contiguous rows of every array of ``batch`` (a tensor,
    numpy array, or a dict / tuple / list of them), on ``device`` (default
    :func:`~aecf_tpu_torch.parallel.mesh.default_device`).  ``batch`` is
    the global batch, the same on every rank (as ``fit``'s
    ``batch_fn(step)`` gives it); its rows must divide evenly over the
    axis.  A mesh without the axis (a pure tensor-parallel one) gives every
    rank the whole batch."""
    axis = MeshAxis(mesh, axis_name)
    device = default_device() if device is None else torch.device(device)

    def put(x):
        x = axis.rows(x)
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device)

    return _map(put, batch)


def _tensors(tree):
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, TrainState):
        return _tensors(tree.params) + _opt_tensors(tree.optimizer)
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return []


def replicate(mesh, tree: Any) -> Any:
    """Overwrite every tensor of ``tree`` (a tensor, a module's parameters
    and buffers, a :class:`TrainState`'s parameters and optimizer state, or
    a dict / tuple / list of these) with the mesh's first rank's, in place;
    returns ``tree``."""
    src = int(mesh.mesh.flatten()[0])
    for t in _tensors(tree):
        broadcast_(t, src)
    return tree


def make_dp_eval_step(
    apply_fn: Callable[..., Any], mesh, *, axis_name: str = "data"
) -> Callable:
    """A data-parallel inference step ``(params, batch) -> out``:
    ``apply_fn(params, batch)`` on this rank's rows (:func:`shard_batch`)
    under ``torch.inference_mode``, every rank's output rows then gathered
    (``all_gather_into_tensor``), so each rank returns the global batch's
    output, as fetching JAX's batch-sharded output gathers it.  The fusion
    forward is row-parallel: the gather is the only collective."""
    axis = _data_axis(mesh, axis_name)

    def eval_step(params, batch):
        with torch.inference_mode():
            return axis.gather(apply_fn(params, batch))

    return eval_step


def _mesh_step(apply_fn, axis: MeshAxis, loss_fn, accum_steps) -> Callable:
    """``(state, images, texts, labels, rng) -> (state, loss, info)`` over
    this rank's rows: the local loss divided by the axis size, the shard's
    folded seed words, one flat all-reduce over ``axis`` (none without a
    group), the optimizer's update.  Loss and info come back as global
    means."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def loss_on(params, images, texts, labels, generator):
        logits, info = apply_fn(params, images, texts, generator)
        return loss_fn(logits, labels), info

    return _make_step(_loss_step(loss_on), accum_steps, axis, _fold_fresh)


def make_dp_train_step(
    apply_fn: Callable[..., Any],
    mesh,
    *,
    axis_name: str = "data",
    loss_fn: Callable[[torch.Tensor, torch.Tensor],
                      torch.Tensor] = bce_with_logits_loss,
    accum_steps: int = 1,
) -> Callable:
    """A data-parallel ``(state, images, texts, labels, rng) -> (state,
    loss, info)`` step over ``axis_name``.

    ``apply_fn(params, images, texts, generator) -> (logits, info)`` sees
    this rank's rows; ``loss_fn(logits, labels)`` is a mean over them
    (default BCE-with-logits).  The returned loss and info are global
    means.  The JAX builder's optimizer is ``state.optimizer`` here, and
    ``donate`` has no counterpart.  ``state``'s parameters must be equal on
    every rank (:func:`replicate`).  ``accum_steps > 1`` microbatches each
    rank's rows before the one reduction and update."""
    return _mesh_step(apply_fn, _data_axis(mesh, axis_name), loss_fn,
                      accum_steps)


def make_dp_scan_train_step(
    apply_fn: Callable[..., Any],
    mesh,
    *,
    axis_name: str = "data",
    loss_fn: Callable[[torch.Tensor, torch.Tensor],
                      torch.Tensor] = bce_with_logits_loss,
    accum_steps: int = 1,
) -> Callable:
    """The K-step form of :func:`make_dp_train_step`: ``(state, images,
    texts, labels, rng) -> (state, losses (K,), infos)`` with this rank's
    rows staged ``(K, B_local, ...)``, the K steps run eagerly in one call.
    Step ``i`` of shard ``s`` draws from ``fold_seed_words(
    fold_seed_words(rng, state.step + i), s)`` — the global step, then the
    shard — so chunks chain and resume exactly like single steps fed
    ``fold_seed_words(rng, step)``."""
    return functools.partial(_eager_chunk, make_dp_train_step(
        apply_fn, mesh, axis_name=axis_name, loss_fn=loss_fn,
        accum_steps=accum_steps))
