"""Pure-functional core: the correctness oracle for every other layer."""

from .attention import (
    AttentionPoolConfig,
    AttentionPoolParams,
    PoolTensors,
    apply_pooled_weights,
    attention_pool_core,
    scaled_dot_product_attention,
)
from .init import init_attention_pool_params, init_fusion_query
from .masking import (
    EPS,
    CurriculumMaskingConfig,
    compute_entropy,
    curriculum_mask,
    entropy_loss,
)
from .precision import PRECISIONS, matmul_precision, round_tf32, run_at

__all__ = [
    "AttentionPoolConfig",
    "AttentionPoolParams",
    "PoolTensors",
    "apply_pooled_weights",
    "attention_pool_core",
    "scaled_dot_product_attention",
    "init_attention_pool_params",
    "init_fusion_query",
    "EPS",
    "CurriculumMaskingConfig",
    "compute_entropy",
    "curriculum_mask",
    "entropy_loss",
    "PRECISIONS",
    "matmul_precision",
    "round_tf32",
    "run_at",
]
