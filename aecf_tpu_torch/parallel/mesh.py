"""Device meshes over the ranks of a ``torch.distributed`` job.

Port of :mod:`aecf_tpu.parallel.mesh`.  PyTorch's SPMD idiom is one process
per device: a mesh is a :class:`torch.distributed.device_mesh.DeviceMesh`
over the job's ranks (the counterpart of ``jax.sharding.Mesh`` over
devices), each of its axes a process group.  The collectives are NCCL on
the card and gloo where the caller asks for the CPU.
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = [
    "data_mesh",
    "data_model_mesh",
    "default_device",
    "make_mesh",
    "maybe_initialize_distributed",
]


def default_device() -> torch.device:
    """This rank's card: ``cuda:{LOCAL_RANK % device_count}`` (torchrun
    sets ``LOCAL_RANK``; 0 without it)."""
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def maybe_initialize_distributed(
    *,
    device_type: str = "cuda",
    timeout: Optional[datetime.timedelta] = None,
) -> None:
    """Join the job's default process group when launched under torchrun.

    A no-op without ``MASTER_ADDR`` in the environment.  Otherwise
    ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` (read by
    ``init_method='env://'``) name the store, the job's size and this
    rank; the backend is NCCL for ``device_type='cuda'`` and gloo for
    ``'cpu'``.  A group that is already initialized is tolerated, and
    nothing else: an unreachable or dead store raises, because swallowing
    it would leave every rank training alone on its own shard.
    """
    if not os.environ.get("MASTER_ADDR"):
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    try:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    except ValueError as e:
        # torch raises ValueError("trying to initialize the default process
        # group twice!") on re-initialization; a store error is a
        # RuntimeError and propagates.
        if "twice" not in str(e):
            raise


def make_mesh(
    axis_sizes: Sequence[int],
    axis_names: Sequence[str],
    *,
    device_type: str = "cuda",
) -> DeviceMesh:
    """A mesh of ``axis_sizes`` over ranks ``0 .. prod(axis_sizes) - 1`` of
    the default process group, row-major, with the given axis names."""
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs the default process group: call "
            "maybe_initialize_distributed() or init_process_group() first"
        )
    n = math.prod(axis_sizes)
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"mesh needs {n} devices, only {world} available")
    ranks = torch.arange(n).reshape(tuple(axis_sizes))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axis_names))


def data_mesh(
    num_devices: Optional[int] = None, *, device_type: str = "cuda"
) -> DeviceMesh:
    """1-D ``('data',)`` mesh over ``num_devices`` ranks (default: all) —
    the batch-parallel layout (BASELINE.json config #5)."""
    if num_devices is None:
        num_devices = _world()
    return make_mesh((num_devices,), ("data",), device_type=device_type)


def data_model_mesh(
    num_devices: Optional[int] = None,
    model_parallelism: int = 1,
    *,
    device_type: str = "cuda",
) -> DeviceMesh:
    """2-D ``('data', 'model')`` mesh for data × tensor parallelism; the
    ``model`` axis shards the attention pools' heads."""
    if num_devices is None:
        num_devices = _world()
    if num_devices % model_parallelism:
        raise ValueError(
            f"num_devices {num_devices} not divisible by model_parallelism "
            f"{model_parallelism}"
        )
    return make_mesh(
        (num_devices // model_parallelism, model_parallelism),
        ("data", "model"),
        device_type=device_type,
    )


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1
