"""Load parameters of the JAX package into a port module.

The caller flattens a JAX parameter pytree to numpy, for example::

    flat = {
        jax.tree_util.keystr(path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
    }
    params_from_numpy(model, flat)

and this module only ever sees numpy arrays: the port imports no JAX.
The pool classifier of the training slice is a parameter dict rather than
a module: :func:`pool_classifier_params_from_numpy` builds it from the same
flat form of JAX's ``init_pool_classifier_params`` pytree, and
:func:`pool_classifier_params_to_numpy` gives that form back.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Union

import numpy as np
import torch
from torch import nn

from .core.attention import AttentionPoolParams

__all__ = [
    "attention_pool_from_numpy",
    "params_from_numpy",
    "pool_classifier_params_from_numpy",
    "pool_classifier_params_to_numpy",
]

_POOL = ("in_proj_weight", "out_proj_weight", "in_proj_bias", "out_proj_bias")
# AttentionPoolParams field -> MultimodalAttentionPool.attention state key
# (nn.MultiheadAttention's names)
_MHA_KEYS = {
    "in_proj_weight": "in_proj_weight",
    "in_proj_bias": "in_proj_bias",
    "out_proj_weight": "out_proj.weight",
    "out_proj_bias": "out_proj.bias",
}


def params_from_numpy(model: nn.Module, flat: Dict[str, np.ndarray]) -> nn.Module:
    """Copy ``flat`` (parameter path → array) into ``model`` and return it.

    Paths are ``jax.tree_util.keystr`` strings (``.pool.in_proj_weight``,
    ``.pools[1].in_proj_weight`` for a list of pools) or state-dict keys
    (``pool.in_proj_weight``, ``pools.1.in_proj_weight``); they must name
    exactly the model's parameters, with equal shapes
    (``load_state_dict(strict=True)``).
    Arrays are copied to each parameter's dtype and device.
    """
    state = {
        _dotted(key): torch.from_numpy(np.array(value))
        for key, value in flat.items()
    }
    model.load_state_dict(state, strict=True)
    return model


def attention_pool_from_numpy(pool: nn.Module, flat: Dict[str, np.ndarray]) -> nn.Module:
    """Load JAX ``AttentionPoolParams``, flattened with ``keystr``
    (``.in_proj_weight``, ``.out_proj_bias``, …), into a
    :class:`~aecf_tpu_torch.MultimodalAttentionPool` and return it.  The
    arrays must name exactly the pool's parameters (a ``bias=False`` pool
    has no biases), with equal shapes."""
    unknown = sorted(k for k in flat if k.lstrip(".") not in _MHA_KEYS)
    if unknown:
        raise KeyError(f"unknown parameter paths: {unknown}")
    state = {
        _MHA_KEYS[k.lstrip(".")]: torch.from_numpy(np.array(v))
        for k, v in flat.items()
    }
    pool.attention.load_state_dict(state, strict=True)
    return pool


def _dotted(key: str) -> str:
    """``['pool'].in_proj_weight`` / ``['head']['w']`` / ``.queries[0]``
    (keystr) or ``pool.in_proj_weight`` → ``pool.in_proj_weight`` /
    ``head.w`` / ``queries.0`` (a list index is a ``ModuleList`` /
    ``ParameterList`` entry)."""
    key = re.sub(r"\['([^']*)'\]", r".\1", key)
    return re.sub(r"\[(\d+)\]", r".\1", key).lstrip(".")


def pool_classifier_params_from_numpy(
    flat: Dict[str, np.ndarray], device: Union[str, torch.device] = "cuda"
) -> Dict[str, Any]:
    """The port's ``{'pool', 'query'[, 'head']}`` parameters from the flat
    numpy form of JAX's ``init_pool_classifier_params`` pytree (keystr or
    dotted paths), on ``device`` (the card unless the caller asks for
    another).  The head weight keeps JAX's ``(E, C)`` layout, which the
    step kernel takes as it is.  Biases absent from ``flat`` stay absent;
    every other key must be known."""
    arrays = {_dotted(k): v for k, v in flat.items()}

    def param(key):
        value = torch.from_numpy(np.array(arrays.pop(key), dtype=np.float32))
        return nn.Parameter(value.to(device))

    pool = {n: param(f"pool.{n}") for n in _POOL if f"pool.{n}" in arrays}
    params: Dict[str, Any] = {
        "pool": AttentionPoolParams(**pool),
        "query": param("query"),
    }
    head = {k: param(f"head.{k}") for k in ("w", "b") if f"head.{k}" in arrays}
    if head:
        params["head"] = head
    if arrays:
        raise KeyError(f"unknown parameter paths: {sorted(arrays)}")
    return params


def pool_classifier_params_to_numpy(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Inverse of :func:`pool_classifier_params_from_numpy`: keystr paths
    (``['pool'].in_proj_weight``, ``['query']``, ``['head']['w']``) to
    numpy arrays."""
    to_np = lambda t: t.detach().cpu().numpy()  # noqa: E731
    flat = {
        f"['pool'].{n}": to_np(t) for n, t in params["pool"].named_parameters()
    }
    flat["['query']"] = to_np(params["query"])
    for k, t in (params.get("head") or {}).items():
        flat[f"['head']['{k}']"] = to_np(t)
    return flat
