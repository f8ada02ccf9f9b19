"""Meshes, data- and tensor-parallel steps: the port of
:mod:`aecf_tpu.parallel` on ``torch.distributed``.

One process per device; a mesh is a ``DeviceMesh`` over the job's ranks
(NCCL on the card, gloo on the CPU), every rank calling these collectively.
``mesh=`` on :func:`aecf_tpu_torch.train.make_pool_train_step`,
:func:`~aecf_tpu_torch.train.make_pool_scan_train_step`,
:func:`~aecf_tpu_torch.train.fit` and
:class:`~aecf_tpu_torch.serve.FusionPredictor` runs them over a mesh.
"""

from .data_parallel import (
    make_dp_eval_step,
    make_dp_scan_train_step,
    make_dp_train_step,
    replicate,
    shard_batch,
)
from .mesh import (
    data_mesh,
    data_model_mesh,
    make_mesh,
    maybe_initialize_distributed,
)
from .tensor_parallel import (
    attention_pool_pspecs,
    make_tp_scan_train_step,
    make_tp_train_step,
    shard_params_tp,
    tp_param_specs,
)

__all__ = [
    "make_dp_train_step",
    "make_dp_scan_train_step",
    "make_dp_eval_step",
    "replicate",
    "shard_batch",
    "data_mesh",
    "data_model_mesh",
    "make_mesh",
    "maybe_initialize_distributed",
    "attention_pool_pspecs",
    "tp_param_specs",
    "shard_params_tp",
    "make_tp_scan_train_step",
    "make_tp_train_step",
]
