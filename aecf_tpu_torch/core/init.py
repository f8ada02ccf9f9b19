"""Parameter initializers matching the reference's distributions.

Port of :mod:`aecf_tpu.core.init`: xavier-uniform packed ``in_proj_weight``,
zero in-proj bias, uniform ``±1/√E`` out-projection weight, zero out-proj
bias, and the fusion query drawn from ``N(0, √(2/E))``.  Draws come from an
explicit ``torch.Generator``; tensors land on the generator's device.
Bitstreams differ from ``jax.random``; distributions and shapes match.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .attention import AttentionPoolParams

__all__ = ["init_attention_pool_params", "init_fusion_query"]


def _uniform(generator, shape, bound, dtype):
    device = generator.device if generator is not None else None
    out = torch.empty(shape, dtype=dtype, device=device)
    return out.uniform_(-bound, bound, generator=generator)


def init_attention_pool_params(
    generator: Optional[torch.Generator],
    embed_dim: int,
    bias: bool = True,
    dtype: torch.dtype = torch.float32,
) -> AttentionPoolParams:
    """Initialize packed-projection attention params, torch-style."""
    # xavier_uniform_ on (3E, E): fan_in=E, fan_out=3E.
    bound_in = math.sqrt(6.0 / (embed_dim + 3 * embed_dim))
    in_proj_weight = _uniform(
        generator, (3 * embed_dim, embed_dim), bound_in, dtype
    )
    # torch Linear default: kaiming_uniform(a=√5) ⇒ uniform(±1/√fan_in).
    out_proj_weight = _uniform(
        generator, (embed_dim, embed_dim), 1.0 / math.sqrt(embed_dim), dtype
    )
    zeros = lambda n: torch.zeros(  # noqa: E731
        n, dtype=dtype, device=in_proj_weight.device
    )
    return AttentionPoolParams(
        in_proj_weight=in_proj_weight,
        out_proj_weight=out_proj_weight,
        in_proj_bias=zeros(3 * embed_dim) if bias else None,
        out_proj_bias=zeros(embed_dim) if bias else None,
    )


def init_fusion_query(
    generator: Optional[torch.Generator],
    embed_dim: int,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Learnable fusion query ``(1, 1, E) ~ N(0, √(2/E))``."""
    device = generator.device if generator is not None else None
    query = torch.randn(
        (1, 1, embed_dim), generator=generator, dtype=dtype, device=device
    )
    return math.sqrt(2.0 / embed_dim) * query
