"""The module API: ``nn.Module``s over the pure core and the kernels."""

from .functional import create_fusion_pool, multimodal_attention_pool
from .modules import CurriculumMasking, MultimodalAttentionPool

__all__ = [
    "CurriculumMasking",
    "MultimodalAttentionPool",
    "multimodal_attention_pool",
    "create_fusion_pool",
]
