"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

Kernels are compiled and loaded at first launch, never at import.  The
eval forwards are ``torch.library`` custom ops, registered at import —
``aecf_tpu_torch::shared_query_fwd``, ``::stream_mix`` and
``::fused_pool_fwd`` — so ``torch.export`` records each as one node and a
frozen program launches the kernel (``aecf_tpu_torch.serve``).
"""

from .fused_pool import (
    fused_fusion_pool,
    fused_pool_fwd,
    fused_pool_fwd_plain,
    prefers_fused,
    supports_fused,
)
from .shared_query import (
    fused_fusion_pool_shared,
    quantize_features,
    shared_query_bwd,
    shared_query_bwd_plain,
    shared_query_fwd,
    shared_query_fwd_plain,
    stream_bwd,
    stream_bwd_mh,
    stream_bwd_plain,
    stream_mix,
    stream_mix_plain,
)
from .train_step import (
    fused_pool_head_train_step,
    fused_pool_train_step,
    step_tile,
    supports_fused_step,
    train_step,
    train_step_plain,
)

__all__ = [
    "fused_fusion_pool",
    "fused_fusion_pool_shared",
    "fused_pool_fwd",
    "fused_pool_fwd_plain",
    "fused_pool_head_train_step",
    "fused_pool_train_step",
    "prefers_fused",
    "quantize_features",
    "shared_query_bwd",
    "shared_query_bwd_plain",
    "shared_query_fwd",
    "shared_query_fwd_plain",
    "step_tile",
    "stream_bwd",
    "stream_bwd_mh",
    "stream_bwd_plain",
    "stream_mix",
    "stream_mix_plain",
    "supports_fused",
    "supports_fused_step",
    "train_step",
    "train_step_plain",
]
