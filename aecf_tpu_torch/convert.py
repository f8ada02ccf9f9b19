"""Load parameters of the JAX package into a port module.

The caller flattens a JAX parameter pytree to numpy, for example::

    flat = {
        jax.tree_util.keystr(path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
    }
    params_from_numpy(model, flat)

and this module only ever sees numpy arrays: the port imports no JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

__all__ = ["params_from_numpy"]


def params_from_numpy(model: nn.Module, flat: Dict[str, np.ndarray]) -> nn.Module:
    """Copy ``flat`` (parameter path → array) into ``model`` and return it.

    Paths are ``jax.tree_util.keystr`` strings (``.pool.in_proj_weight``)
    or state-dict keys (``pool.in_proj_weight``); they must name exactly the
    model's parameters, with equal shapes (``load_state_dict(strict=True)``).
    Arrays are copied to each parameter's dtype and device.
    """
    state = {
        key.lstrip("."): torch.from_numpy(np.array(value))
        for key, value in flat.items()
    }
    model.load_state_dict(state, strict=True)
    return model
