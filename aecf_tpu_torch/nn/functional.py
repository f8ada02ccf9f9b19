"""Functional entry points: ``multimodal_attention_pool`` and
``create_fusion_pool``.

Port of :mod:`aecf_tpu.nn.functional`, which mirrors reference
aecf/AECFLayer.py:584-727 including the fast/slow dispatch (:637-640) and
the Q3 quirk: the slow path builds a *fresh, randomly initialised* module
per call (:643-652), so its outputs are untrained — kept for parity, with
``init_generator=`` to pin the init.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..core.attention import scaled_dot_product_attention
from ..core.init import init_fusion_query
from .modules import CurriculumMasking, MultimodalAttentionPool, _default_generator

__all__ = ["multimodal_attention_pool", "create_fusion_pool"]


def multimodal_attention_pool(
    query: torch.Tensor,
    key: torch.Tensor,
    value: Optional[torch.Tensor] = None,
    embed_dim: Optional[int] = None,
    num_heads: int = 1,
    dropout: float = 0.0,
    curriculum_masking: Optional[CurriculumMasking] = None,
    training: bool = False,
    *,
    init_generator: Optional[torch.Generator] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Functional multimodal attention pooling with a projection-free fast
    path.

    Fast path (eval, no masking, no dropout, one head — reference
    AECFLayer.py:637-640): plain scaled dot-product attention, no
    projections.  Anything else builds a fresh ``MultimodalAttentionPool``
    per call (reference quirk Q3) on the query's device; ``init_generator``
    pins its random init and ``generator`` draws its training randomness.

    >>> import torch
    >>> q, kv = torch.ones(2, 1, 64), torch.ones(2, 3, 64)
    >>> tuple(multimodal_attention_pool(q, kv).shape)          # fast path
    (2, 1, 64)
    >>> out = multimodal_attention_pool(
    ...     q, kv, training=True,
    ...     init_generator=torch.Generator().manual_seed(0),
    ...     generator=torch.Generator().manual_seed(1))       # fresh module
    >>> tuple(out.shape)
    (2, 1, 64)
    """
    if embed_dim is None:
        embed_dim = query.shape[-1]
    if value is None:
        value = key

    if (
        not training
        and curriculum_masking is None
        and dropout == 0.0
        and num_heads == 1
    ):
        return scaled_dot_product_attention(query, key, value)

    pool = MultimodalAttentionPool(
        embed_dim=embed_dim,
        num_heads=num_heads,
        dropout=dropout,
        curriculum_masking=curriculum_masking,
        batch_first=True,
        generator=init_generator,
        device=query.device,
    )
    pool.train(training)
    return pool(query, key, value, generator=generator)


def create_fusion_pool(
    embed_dim: int,
    num_modalities: int,
    mask_prob: float = 0.15,
    *,
    generator: Optional[torch.Generator] = None,
    **kwargs,
) -> Tuple[nn.Parameter, MultimodalAttentionPool]:
    """Factory for ``(fusion_query, attention_pool)`` (reference
    AECFLayer.py:655-727).

    ``fusion_query`` is an ``nn.Parameter`` ``(1, 1, E)`` drawn from
    ``N(0, √(2/E))`` — register it with your model.  ``num_modalities`` is
    validation-only, as in the reference (:708).  ``kwargs`` go to
    :class:`MultimodalAttentionPool`, and the query goes where the pool's
    parameters go: ``'cuda'`` unless ``device=`` (or ``params=``) says
    otherwise.  Both draws come from ``generator`` (a CPU
    ``torch.Generator``), the query's first.

    >>> import torch
    >>> g = torch.Generator().manual_seed(0)
    >>> query, pool = create_fusion_pool(64, 3, generator=g, device="cpu")
    >>> tuple(query.shape)
    (1, 1, 64)
    >>> kv = torch.ones(2, 3, 64)
    >>> q = query.expand(2, 1, 64)
    >>> out, info = pool.eval()(q, kv, return_info=True)
    >>> sorted(info)                    # eval: no target_entropy key
    ['attention_weights', 'entropy', 'mask_rate', 'masked_attention_weights']
    >>> out, info = pool.train()(q, kv, generator=g, return_info=True)
    >>> sorted(info)                    # training adds target_entropy
    ['attention_weights', 'entropy', 'mask_rate', 'masked_attention_weights', 'target_entropy']
    """
    if not isinstance(embed_dim, int) or embed_dim <= 0:
        raise ValueError(
            f"embed_dim must be a positive integer, got {embed_dim}"
        )
    if not isinstance(num_modalities, int) or num_modalities <= 0:
        raise ValueError(
            f"num_modalities must be a positive integer, got {num_modalities}"
        )
    if not isinstance(mask_prob, (int, float)) or not 0.0 < mask_prob <= 1.0:
        raise ValueError(f"mask_prob must be in (0, 1], got {mask_prob}")

    if generator is None:
        generator = _default_generator()
    query = init_fusion_query(generator, embed_dim)
    attention_pool = MultimodalAttentionPool(
        embed_dim=embed_dim,
        curriculum_masking=CurriculumMasking(base_mask_prob=mask_prob),
        generator=generator,
        **kwargs,
    )
    query = query.to(attention_pool.params.in_proj_weight.device)
    return nn.Parameter(query), attention_pool
