"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

Kernels are compiled and loaded at first launch, never at import.
"""

from .fused_pool import prefers_fused, supports_fused
from .shared_query import (
    fused_fusion_pool_shared,
    shared_query_fwd,
    shared_query_fwd_plain,
)

__all__ = [
    "fused_fusion_pool_shared",
    "shared_query_fwd",
    "shared_query_fwd_plain",
    "supports_fused",
    "prefers_fused",
]
