"""Training: the elastic loop, the pool-protocol steps and chunks,
checkpoints, metrics and the experiment harness.

Port of :mod:`aecf_tpu.train`; ``mesh=`` runs the steps, the chunk and
``fit`` over a mesh (:mod:`aecf_tpu_torch.parallel`).
"""

from .checkpointing import CheckpointManager, load_params, save_params
from .fit import fit, make_epoch_batch_fn
from .metrics import (
    average_precision,
    brier_score,
    calculate_metrics,
    expected_calibration_error,
    macro_map,
    recall_at_k,
)
from .pool_step import (
    as_fit_chunk,
    as_fit_step,
    init_pool_classifier_params,
    make_pool_scan_train_step,
    make_pool_train_step,
)
from .sweeps import missing_modality_sweep, modality_subsets
from .trainer import (
    ExperimentConfig,
    TrainState,
    accumulate_grads,
    bce_with_logits_loss,
    evaluate_model,
    make_scan_train_step,
    make_train_step,
    mask_modality,
    param_leaves,
    train_parallel_experiment,
)

__all__ = [
    "fit",
    "make_epoch_batch_fn",
    "CheckpointManager",
    "load_params",
    "save_params",
    "average_precision",
    "calculate_metrics",
    "expected_calibration_error",
    "brier_score",
    "recall_at_k",
    "macro_map",
    "missing_modality_sweep",
    "modality_subsets",
    "init_pool_classifier_params",
    "make_pool_train_step",
    "make_pool_scan_train_step",
    "as_fit_step",
    "as_fit_chunk",
    "ExperimentConfig",
    "TrainState",
    "accumulate_grads",
    "bce_with_logits_loss",
    "evaluate_model",
    "make_scan_train_step",
    "make_train_step",
    "mask_modality",
    "param_leaves",
    "train_parallel_experiment",
]
