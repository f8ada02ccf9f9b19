"""MultiScaleFusion — one fusion pool per feature scale, in PyTorch.

Port of :mod:`aecf_tpu.models.multiscale`: each scale (256, 512 and 1024
wide by default) has its own learnable query and pool, H = 1, fused with
:func:`aecf_tpu_torch.ops.fusion_pool` (the shared-query kernel on the
card) with per-scale curriculum masking and info dicts.  The parameters
are ``queries.<i>`` and ``pools.<i>.*``, the JAX ``queries[i]`` /
``pools[i]`` lists, which :func:`aecf_tpu_torch.convert.params_from_numpy`
maps across.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..core.init import init_attention_pool_params, init_fusion_query
from ..ops import fusion_pool
from ..kernels.draws import Draws
from .layers import fork_generator

__all__ = ["MultiScaleFusion"]


class MultiScaleFusion(nn.Module):
    """Per-scale fusion pools.

    Parameters are drawn on the CPU from ``generator`` (a fresh seed-0
    generator by default), query then pool scale by scale, and moved to
    ``device`` (the card unless the caller asks for another).  Training
    (``self.training``) keys every scale's mask by the ``generator``
    passed to ``forward`` (a CPU generator, a step's seed words or a
    ``(2,)`` int32 words tensor on the card), scale by scale (a fold of the
    words a scale, :func:`.layers.fork_generator`), and needs it.
    """

    def __init__(
        self,
        dims: Sequence[int] = (256, 512, 1024),
        mask_prob: float = 0.15,
        entropy_target: float = 0.7,
        min_active: int = 1,
        *,
        generator: Optional[torch.Generator] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__()
        self.dims = tuple(dims)
        self.mask_prob = mask_prob
        self.entropy_target = entropy_target
        self.min_active = min_active
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        queries, pools = [], []
        for dim in self.dims:
            queries.append(nn.Parameter(init_fusion_query(g, dim)))
            pools.append(init_attention_pool_params(g, dim))
        self.queries = nn.ParameterList(queries)
        self.pools = nn.ModuleList(pools)
        self.to(device)

    def forward(
        self,
        scale_modalities: Sequence[torch.Tensor],  # each (B, M, dim_i)
        *,
        generator=None,
        return_info: bool = False,
    ) -> Union[List[torch.Tensor],
               Tuple[List[torch.Tensor], List[Dict[str, Any]]]]:
        """Per-scale pooled features ``[(B, dim_i), ...]``; with
        ``return_info=True`` also a per-scale list of info dicts (the
        module's key contract: ``entropy``/``mask_rate`` (+
        ``target_entropy`` in training), ``attention_weights`` and the
        detached ``masked_attention_weights``).  Masking follows quirk Q1:
        it leaves the outputs unchanged."""
        if len(scale_modalities) != len(self.dims):
            raise ValueError(
                f"expected {len(self.dims)} scales, got {len(scale_modalities)}"
            )
        if self.training and generator is None:
            raise ValueError(
                "training-mode curriculum masking needs a `generator=`"
            )
        draws = Draws.of(generator)
        outs: List[torch.Tensor] = []
        infos: List[Dict[str, Any]] = []
        for query, pool, mods in zip(self.queries, self.pools,
                                     scale_modalities):
            pooled, weights, masked_weights, mask_info = fusion_pool(
                pool,
                query,
                mods,
                num_heads=1,
                generator=fork_generator(draws),
                training=self.training,
                base_mask_prob=self.mask_prob,
                entropy_target=self.entropy_target,
                min_active=self.min_active,
            )
            outs.append(pooled.squeeze(1))
            if return_info:
                info: Dict[str, Any] = dict(mask_info)
                info["attention_weights"] = weights
                info["masked_attention_weights"] = masked_weights
                infos.append(info)
        if return_info:
            return outs, infos
        return outs
