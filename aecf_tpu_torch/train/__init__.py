"""Training: the pool-protocol train step and its state.

Port of the pool-step slice of :mod:`aecf_tpu.train`.  Not ported yet
(ROADMAP.md): ``make_pool_scan_train_step`` / ``as_fit_chunk`` (a K-step
chunk, to become a CUDA graph), ``fit``, checkpointing, metrics and the
experiment harness.
"""

from .pool_step import (
    as_fit_step,
    init_pool_classifier_params,
    make_pool_train_step,
)
from .trainer import TrainState, param_leaves

__all__ = [
    "TrainState",
    "as_fit_step",
    "init_pool_classifier_params",
    "make_pool_train_step",
    "param_leaves",
]
