"""Elastic training loop: periodic checkpoints and resume-from-latest.

Port of :mod:`aecf_tpu.train.fit`.  Every ``save_every`` steps the whole
:class:`~aecf_tpu_torch.train.TrainState` (parameters, optimizer state,
step) is checkpointed; a restarted process calls the same :func:`fit` and
continues from the latest checkpoint, with the batches and the seed words
re-derived from the step index, so the resumed run reproduces the
uninterrupted one.  Over a mesh (``mesh=``) every rank runs the loop on its
own rows of each batch.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..kernels.draws import fold_seed_words
from .checkpointing import CheckpointManager
from .staging import Stager
from .trainer import (
    TrainState,
    make_scan_train_step,
    make_train_step,
    param_leaves,
)

__all__ = ["fit", "make_epoch_batch_fn"]


def make_epoch_batch_fn(
    data: Dict[str, np.ndarray],
    batch_size: int,
    *,
    seed: int = 0,
    shuffle: bool = True,
) -> Callable[[int], Tuple[np.ndarray, ...]]:
    """Epoch-shuffled batching as a pure function of the step index — the
    JAX function's batches, row for row: step ``s`` belongs to epoch ``s //
    (n // batch_size)``, whose row order is ``default_rng(seed +
    epoch).permutation(n)`` (drop_last; the ragged tail never appears).
    ``data`` maps stream names to arrays sharing a row count; batches are
    tuples in dict order, ``{image, text, label}`` always in that order."""
    if not data:
        raise ValueError("data must contain at least one stream")
    names = list(data.keys())
    if set(names) == {"image", "text", "label"}:
        names = ["image", "text", "label"]
    arrays = [np.asarray(data[name]) for name in names]
    n = arrays[0].shape[0]
    for name, arr in zip(names, arrays):
        if arr.shape[0] != n:
            raise ValueError(
                f"row mismatch: {name} has {arr.shape[0]} rows, "
                f"{names[0]} has {n}"
            )
    per_epoch = n // batch_size
    if per_epoch < 1:
        raise ValueError(
            f"batch_size {batch_size} exceeds the {n} available rows"
        )
    # the current epoch's permutation, memoized: steps arrive in order
    cached: Tuple[Optional[int], Optional[np.ndarray]] = (None, None)

    def batch_fn(step: int) -> Tuple[np.ndarray, ...]:
        nonlocal cached
        epoch, pos = divmod(step, per_epoch)
        if cached[0] != epoch:
            idx = (np.random.default_rng(seed + epoch).permutation(n)
                   if shuffle else np.arange(n))
            cached = (epoch, idx)
        sel = cached[1][pos * batch_size : (pos + 1) * batch_size]
        return tuple(a[sel] for a in arrays)

    return batch_fn


def _make_state(optimizer, params) -> TrainState:
    """``optimizer`` is a built ``torch.optim.Optimizer`` over
    ``param_leaves(params)``, or a factory called with those leaves (JAX's
    optax transformation), e.g. ``functools.partial(torch.optim.AdamW,
    lr=1e-4, weight_decay=0.01)``."""
    if not isinstance(optimizer, torch.optim.Optimizer):
        optimizer = optimizer(param_leaves(params))
    return TrainState(params, optimizer)


def fit(
    apply_fn: Optional[Callable[..., Any]],
    optimizer: Union[torch.optim.Optimizer, Callable[..., torch.optim.Optimizer]],
    init_params: Any,
    batch_fn: Callable[[int], Tuple[np.ndarray, np.ndarray, np.ndarray]],
    *,
    num_steps: int,
    rng: Union[int, Tuple[int, int]],
    checkpoint_dir: Optional[str] = None,
    save_every: int = 100,
    log_every: int = 0,
    step_fn: Optional[Callable] = None,
    chunk_fn: Optional[Callable] = None,
    mesh: Optional[Any] = None,
    accum_steps: int = 1,
    scan_chunk: int = 1,
) -> Tuple[TrainState, Dict[str, list]]:
    """Train for ``num_steps`` with checkpoint/resume; returns the final
    state and a history dict.

    ``batch_fn(step) -> (images, texts, labels)`` (numpy) must be a pure
    function of the step index.  Batches go to the parameters' device, the
    card through pinned memory, images and texts side by side in one
    buffer (:class:`~aecf_tpu_torch.train.staging.Stager`): the step gets
    them as column views of the packed features.  ``rng`` is the run's seed (an int or two
    32-bit words): step ``s`` gets ``fold_seed_words(rng, s)``.  If
    ``checkpoint_dir`` holds a previous run's checkpoints, training resumes
    after its latest step; the last step is always checkpointed.

    The step is ``step_fn(state, images, texts, labels, words)`` (e.g.
    ``as_fit_step(make_pool_train_step(...))``) or, by default,
    :func:`make_train_step` over ``apply_fn`` with ``accum_steps``.
    ``scan_chunk=K > 1`` stages K batches at once and runs them as one
    chunk: ``chunk_fn(state, images, texts, labels, rng)`` with a leading K
    axis (e.g. ``as_fit_chunk(make_pool_scan_train_step(...))``, a CUDA
    graph on the card), or by default :func:`make_scan_train_step`.  Seed
    words fold the global step, so any chunking resumes into any other;
    checkpoints and history land at chunk boundaries, and a final partial
    chunk runs (or captures) its own shape.  ``scan_chunk > 1`` with a
    ``step_fn`` and no ``chunk_fn`` raises, as in JAX.

    ``mesh=`` (a ``DeviceMesh``, :mod:`aecf_tpu_torch.parallel`; every
    rank calls ``fit`` alike) trains data-parallel: the parameters are
    broadcast from the first rank, each rank stages only its rows of each
    global batch (``batch_fn`` is the same on every rank) and the default
    step and chunk are :func:`~aecf_tpu_torch.parallel.make_dp_train_step`
    / ``make_dp_scan_train_step`` (a custom ``step_fn`` / ``chunk_fn``
    gets the same rows, e.g. ``as_fit_step(make_pool_train_step(
    mesh=mesh))``).  A mesh with a ``'model'`` axis runs data × tensor
    parallelism: the parameters are head-sharded
    (:func:`~aecf_tpu_torch.parallel.shard_params_tp`) before the
    optimizer is built over them, and the steps are ``make_tp_train_step``
    / ``make_tp_scan_train_step``.  Rank 0 writes the checkpoints, with
    the sharded pools gathered whole, a barrier after each save; every
    rank restores.  Resume stays exact, since each shard's seed words
    derive from the run's seed, the step and the shard's index only.
    """
    if scan_chunk < 1:
        raise ValueError(f"scan_chunk must be >= 1, got {scan_chunk}")
    if scan_chunk > 1 and step_fn is not None and chunk_fn is None:
        raise ValueError(
            "scan_chunk > 1 builds its own multi-step chunk and cannot "
            "wrap a custom step_fn; pass scan_chunk=1, or a chunk_fn"
        )
    manager_type, rows = CheckpointManager, None
    make_step, make_chunk = make_train_step, make_scan_train_step
    if mesh is not None:
        from .. import parallel
        from ..parallel.checkpointing import MeshCheckpointManager
        from ..parallel.collectives import MeshAxis

        if "model" in (mesh.mesh_dim_names or ()):
            init_params = parallel.shard_params_tp(mesh, init_params)
            make_step = parallel.make_tp_train_step
            make_chunk = parallel.make_tp_scan_train_step
        else:
            parallel.replicate(mesh, init_params)
            make_step = parallel.make_dp_train_step
            make_chunk = parallel.make_dp_scan_train_step
        make_step = functools.partial(make_step, mesh=mesh)
        make_chunk = functools.partial(make_chunk, mesh=mesh)
        manager_type, rows = MeshCheckpointManager, MeshAxis(mesh, "data").rows
    state = _make_state(optimizer, init_params)
    stage = Stager(param_leaves(state.params)[0].device)
    manager = None
    start_step = 0
    if checkpoint_dir is not None:
        manager = manager_type(checkpoint_dir, save_interval_steps=save_every)
        if manager.restore(state) is not None:
            start_step = state.step

    if scan_chunk > 1 and chunk_fn is None:
        chunk_fn = make_chunk(apply_fn, accum_steps=accum_steps)
    if step_fn is None:
        step_fn = make_step(apply_fn, accum_steps=accum_steps)

    def batch(step_idx):
        arrays = batch_fn(step_idx)
        return arrays if rows is None else tuple(rows(a) for a in arrays)

    history: Dict[str, list] = {"loss": [], "step": []}

    def log(step_idx, loss, info):
        history["loss"].append(loss)
        history["step"].append(step_idx)
        for k, v in info.items():
            history.setdefault(k, []).append(v)
        print(f"step {step_idx}: loss={loss:.4f}", flush=True)

    if scan_chunk > 1:
        step_idx = start_step
        while step_idx < num_steps:
            k = min(scan_chunk, num_steps - step_idx)
            staged = stage((batch(s) for s in range(step_idx, step_idx + k)),
                           count=k)
            state, losses, infos = chunk_fn(state, *staged, rng)
            if manager is not None:
                manager.save(step_idx + k, state)
            hits = [j for j in range(k)
                    if log_every and (step_idx + j) % log_every == 0]
            if hits:
                losses_np = losses.float().cpu().numpy()
                infos_np = {kk: v.float().cpu().numpy()
                            for kk, v in (infos or {}).items()}
                for j in hits:
                    log(step_idx + j, float(losses_np[j]),
                        {kk: float(v[j]) for kk, v in infos_np.items()})
            step_idx += k
        return _finalize(manager, num_steps, state), history

    for step_idx in range(start_step, num_steps):
        images, texts, labels = stage([batch(step_idx)])
        state, loss, info = step_fn(state, images, texts, labels,
                                    fold_seed_words(rng, step_idx))
        if manager is not None:
            manager.save(step_idx + 1, state)
        if log_every and step_idx % log_every == 0:
            log(step_idx, float(loss),
                {k: float(v.detach().float().mean())
                 for k, v in (info or {}).items()})
    return _finalize(manager, num_steps, state), history


def _finalize(manager, num_steps, state):
    """The end of training, both loop shapes: a terminal checkpoint."""
    if manager is not None:
        if manager.latest_step() != num_steps:
            manager.save(num_steps, state, force=True)
        manager.wait()
        manager.close()
    return state
