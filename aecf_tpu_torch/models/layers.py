"""Small building blocks shared by the model families.

Port of :mod:`aecf_tpu.models.layers`: ``LinearParams`` is an
``nn.Linear`` (weight ``(out, in)``, bias ``(out,)``, the same state-dict
keys) initialised the JAX package's way, uniform ``±1/√in_dim`` for both,
from an explicit ``torch.Generator``.  ``dropout`` is inverted dropout
drawn from a CPU generator (on a card, from a generator there seeded from
two words drawn from it), and ``mlp_encoder`` the per-modality
``Linear → ReLU → Dropout`` encoder of every model family.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..kernels.draws import device_generator, draw_seed_words, generator_on

__all__ = [
    "LinearParams",
    "dropout",
    "fork_generator",
    "init_linear",
    "linear",
    "mlp_encoder",
]


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


def fork_generator(
    generator: Optional[torch.Generator],
) -> Optional[torch.Generator]:
    """A CPU generator seeded from two words drawn from ``generator`` (None
    for None), as ``jax.random.split`` gives a sub-key: the fusion pool
    draws from it, so the caller's stream advances by two words whichever
    path (kernel or torch, CPU or card) the pool takes."""
    if generator is None:
        return None
    return device_generator(draw_seed_words(generator), "cpu")


def dropout(
    x: torch.Tensor,
    rate: float,
    generator: Optional[torch.Generator],
    training: bool,
) -> torch.Tensor:
    """Inverted dropout; identity in eval, at rate 0 or when no generator
    is supplied (the JAX package's no-key rule)."""
    if not training or rate <= 0.0 or generator is None:
        return x
    keep = torch.bernoulli(
        torch.full_like(x, 1.0 - rate),
        generator=generator_on(generator, x.device),
    )
    return torch.where(keep.bool(), x / (1.0 - rate), 0.0)


def mlp_encoder(
    params: LinearParams,
    x: torch.Tensor,
    *,
    drop_rate: float = 0.1,
    generator: Optional[torch.Generator] = None,
    training: bool = False,
) -> torch.Tensor:
    """``Linear → ReLU → Dropout``, the per-modality encoder of every model
    family."""
    return dropout(torch.relu(linear(params, x)), drop_rate, generator,
                   training)
