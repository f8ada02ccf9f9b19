"""Checkpoints of a mesh run: rank 0 writes, every rank restores."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from ..train.checkpointing import CheckpointManager
from ..train.trainer import TrainState
from .tensor_parallel import sharded_pools

__all__ = ["MeshCheckpointManager"]


def _sharded_leaves(state: TrainState, blob: Dict[str, Any]):
    """``(pool, name, param, its entry in blob['params'] (dict, key), its
    optimizer state index)`` of every sharded leaf of ``state``'s
    head-sharded pools."""
    opt = state.optimizer
    index = {id(p): i
             for saved, group in zip(blob["optimizer"]["param_groups"],
                                     opt.param_groups)
             for i, p in zip(saved["params"], group["params"])}
    leaves = []
    for (part, prefix), pool in sharded_pools(state.params):
        for name, p in pool.named_parameters(recurse=False):
            if name != "out_proj_bias":
                leaves.append((pool, name, p, (blob["params"][part],
                                               prefix + name), index[id(p)]))
    return leaves


class MeshCheckpointManager(CheckpointManager):
    """:class:`~aecf_tpu_torch.train.CheckpointManager` for every rank of
    a job, each calling it alike: rank 0 writes, a barrier follows each
    save, every rank restores, and every rank takes rank 0's
    :meth:`latest_step` (a rank reading the directory itself could see a
    save that rank 0 is making and decide otherwise).  Head-sharded pools
    (:func:`~aecf_tpu_torch.parallel.shard_params_tp`) are saved whole —
    their parameters and the optimizer state of their shape, gathered
    across the model axis — so a checkpoint restores on any mesh, or
    none."""

    def latest_step(self) -> Optional[int]:
        latest = [super().latest_step()]
        dist.broadcast_object_list(latest, src=0)
        return latest[0]

    def _blob(self, state: TrainState) -> Dict[str, Any]:
        blob = super()._blob(state)
        opt_state = blob["optimizer"]["state"]
        for pool, name, p, (entries, key), i in _sharded_leaves(state, blob):
            entries[key] = pool.gathered(name, entries[key])
            if i in opt_state:  # a fresh dict: state_dict() shares its own
                opt_state[i] = {
                    k: pool.gathered(name, v)
                    if torch.is_tensor(v) and v.shape == p.shape else v
                    for k, v in opt_state[i].items()
                }
        return blob

    def _commit(self, step: int, blob: Dict[str, Any]) -> None:
        if dist.get_rank() == 0:
            super()._commit(step, blob)
        dist.barrier()

    def _apply(self, state: TrainState, blob: Dict[str, Any]) -> None:
        opt_state = blob["optimizer"]["state"]
        for pool, name, p, (entries, key), i in _sharded_leaves(state, blob):
            full = entries[key]
            entries[key] = pool.local(name, full)
            if i in opt_state:
                opt_state[i] = {
                    k: pool.local(name, v)
                    if torch.is_tensor(v) and v.shape == full.shape else v
                    for k, v in opt_state[i].items()
                }
        super()._apply(state, blob)
