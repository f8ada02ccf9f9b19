"""Small building blocks shared by the model families.

Port of :mod:`aecf_tpu.models.layers`: ``LinearParams`` is an
``nn.Linear`` (weight ``(out, in)``, bias ``(out,)``, the same state-dict
keys) initialised the JAX package's way, uniform ``±1/√in_dim`` for both,
from an explicit ``torch.Generator``.  ``dropout`` is inverted dropout
keyed by the step's seed words (the next site of a forward's
:class:`~aecf_tpu_torch.kernels.draws.Draws`, ``docs/prng.md``; on the
card one Philox launch that reads the words where they lie),
``fork_generator`` the pool's mask key, and ``mlp_encoder`` the
per-modality ``Linear → ReLU → Dropout`` encoder of every model family.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..kernels.draws import Draws

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


def fork_generator(draws):
    """The pool's mask key: the next site of the forward's draws
    (:class:`~aecf_tpu_torch.kernels.draws.Draws`), the step's seed words
    folded with the site's tag — host words for host words, two words on
    the card for words there.  None for None."""
    draws = Draws.of(draws)
    return None if draws is None else draws.fork()


def dropout(
    x: torch.Tensor,
    rate: float,
    draws,
    training: bool,
) -> torch.Tensor:
    """Inverted dropout at the next site of ``draws`` (a
    :class:`~aecf_tpu_torch.kernels.draws.Draws`, or what
    :meth:`Draws.of` takes): element ``(r, c)`` of ``x`` flattened to rows
    of its last axis is kept where its uniform is below ``1 - rate``.
    Identity in eval, at rate 0 or without draws (the JAX package's no-key
    rule)."""
    if not training or rate <= 0.0 or draws is None:
        return x
    keep = 1.0 - rate
    cols = x.shape[-1]
    u = Draws.of(draws).uniforms(x.numel() // max(cols, 1), cols, x.device)
    return torch.where(u.reshape(x.shape) < keep, x / keep, 0.0)


def mlp_encoder(
    params: LinearParams,
    x: torch.Tensor,
    *,
    drop_rate: float = 0.1,
    generator=None,
    training: bool = False,
) -> torch.Tensor:
    """``Linear → ReLU → Dropout``, the per-modality encoder of every model
    family (``generator``: the forward's draws)."""
    return dropout(torch.relu(linear(params, x)), drop_rate, generator,
                   training)
