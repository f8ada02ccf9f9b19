"""Small building blocks shared by the model families.

Port of :mod:`aecf_tpu.models.layers`: ``LinearParams`` is an
``nn.Linear`` (weight ``(out, in)``, bias ``(out,)``, the same state-dict
keys) initialised the JAX package's way, uniform ``±1/√in_dim`` for both,
from an explicit ``torch.Generator``.  ``dropout`` and ``mlp_encoder`` are
not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

__all__ = ["LinearParams", "init_linear", "linear"]


class LinearParams(nn.Linear):
    """``nn.Linear`` under the JAX package's name."""


def init_linear(
    generator: Optional[torch.Generator],
    in_dim: int,
    out_dim: int,
    bias: bool = True,
    dtype: torch.dtype = torch.float32,
) -> LinearParams:
    """torch nn.Linear default init: uniform ``±1/√in_dim`` for both, drawn
    from ``generator`` (on its device)."""
    device = generator.device if generator is not None else None
    layer = LinearParams(in_dim, out_dim, bias=bias, device="meta", dtype=dtype)
    layer = layer.to_empty(device=device or "cpu")
    bound = 1.0 / math.sqrt(in_dim)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        if bias:
            layer.bias.uniform_(-bound, bound, generator=generator)
    return layer


def linear(params: LinearParams, x: torch.Tensor) -> torch.Tensor:
    y = x @ params.weight.T
    return y if params.bias is None else y + params.bias
