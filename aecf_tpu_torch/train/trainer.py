"""Training state of the port.

Port of :class:`aecf_tpu.train.trainer.TrainState`.  JAX keeps the
optimizer state beside immutable parameters and returns a new state from
every step; here the parameters are tensors that a ``torch.optim``
optimizer updates in place, so the state holds the parameters, the
optimizer over their leaves, and the step count.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch

__all__ = ["TrainState", "param_leaves"]


def param_leaves(params: Dict[str, Any]) -> List[torch.Tensor]:
    """The trainable tensors of a ``{'pool', 'query'[, 'head']}`` parameter
    dict in a fixed order: the pool's parameters (``named_parameters``
    order), the query, then the head's ``w`` and ``b``."""
    leaves = list(params["pool"].parameters()) + [params["query"]]
    head = params.get("head")
    if head is not None:
        leaves += [head[k] for k in ("w", "b") if head.get(k) is not None]
    return leaves


@dataclasses.dataclass
class TrainState:
    """``params`` (see :func:`param_leaves`), ``optimizer`` over their
    leaves, e.g. ``torch.optim.AdamW(param_leaves(params), lr=1e-4,
    weight_decay=0.01)`` (pass the decay: torch's default is 1e-2,
    optax's 1e-4), and ``step``, the number of updates taken."""

    params: Dict[str, Any]
    optimizer: torch.optim.Optimizer
    step: int = 0
