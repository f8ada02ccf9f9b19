"""VisionLanguageModel — the canonical integration pattern, in PyTorch.

Port of :mod:`aecf_tpu.models.vision_language`: project each modality to a
shared space, stack on axis 1, pool with the learnable fusion query,
squeeze, classify.  The attribute names equal the JAX parameter dataclass
fields, so ``state_dict()`` keys equal the JAX parameter paths
(``img_proj.weight``, ``pool.in_proj_weight``, ``fusion_query``, ...) and
:func:`aecf_tpu_torch.convert.params_from_numpy` maps one onto the other.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.utils.checkpoint
from torch import nn

from ..core.init import init_attention_pool_params, init_fusion_query
from ..ops import fusion_pool
from .layers import fork_generator, init_linear, linear

__all__ = ["VisionLanguageModel"]


class VisionLanguageModel(nn.Module):
    """img(2048) + txt(768) → hidden(512) fusion + classifier (BASELINE
    config #4 defaults).

    Parameters are drawn on the CPU from ``generator`` (a fresh seed-0
    generator by default) and then moved to ``device`` (the card unless
    the caller asks for another).  ``forward`` runs in eval or training
    mode after ``self.training``; training keys its curriculum mask by a
    fold of the seed words of the ``generator`` passed to ``forward`` (a
    CPU generator, a step's seed words or a ``(2,)`` int32 words tensor on
    the card; :func:`.layers.fork_generator`).
    """

    def __init__(
        self,
        img_dim: int = 2048,
        txt_dim: int = 768,
        hidden_dim: int = 512,
        num_classes: int = 1000,
        mask_prob: float = 0.15,
        num_heads: int = 1,
        entropy_target: float = 0.7,
        min_active: int = 1,
        *,
        generator: Optional[torch.Generator] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__()
        self.img_dim = img_dim
        self.txt_dim = txt_dim
        self.hidden_dim = hidden_dim
        self.num_classes = num_classes
        self.mask_prob = mask_prob
        self.num_heads = num_heads
        self.entropy_target = entropy_target
        self.min_active = min_active
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.img_proj = init_linear(generator, img_dim, hidden_dim)
        self.txt_proj = init_linear(generator, txt_dim, hidden_dim)
        self.fusion_query = nn.Parameter(init_fusion_query(generator, hidden_dim))
        self.pool = init_attention_pool_params(generator, hidden_dim)
        self.classifier = init_linear(generator, hidden_dim, num_classes)
        self.to(device)

    def forward(
        self,
        image_feats: torch.Tensor,  # (B, img_dim)
        text_feats: torch.Tensor,  # (B, txt_dim)
        *,
        generator=None,
        return_info: bool = False,
        use_checkpoint: bool = False,
    ) -> Union[torch.Tensor, Tuple[torch.Tensor, Dict[str, Any]]]:
        """``use_checkpoint=True`` recomputes the fusion pool in the
        backward (``torch.utils.checkpoint``, training only), as the JAX
        model's ``jax.checkpoint``.  The pool's mask key is taken from
        ``generator`` (:func:`.layers.fork_generator`) before it runs, so
        the recompute leaves ``generator`` alone and both settings give the
        same outputs, gradients and generator state."""
        img = linear(self.img_proj, image_feats)
        txt = linear(self.txt_proj, text_feats)
        modalities = torch.stack([img, txt], dim=1)  # (B, 2, hidden)
        pool_gen = fork_generator(generator)

        # The unexpanded (1, 1, E) query reaches the shared-query kernel on
        # CUDA (aecf_tpu_torch.ops.fusion_pool dispatch).
        def fuse(query, kv):
            return fusion_pool(
                self.pool,
                query,
                kv,
                num_heads=self.num_heads,
                generator=pool_gen,
                training=self.training,
                base_mask_prob=self.mask_prob,
                entropy_target=self.entropy_target,
                min_active=self.min_active,
            )

        if use_checkpoint and self.training:
            pooled, weights, masked_weights, mask_info = (
                torch.utils.checkpoint.checkpoint(
                    fuse, self.fusion_query, modalities, use_reentrant=False
                )
            )
        else:
            pooled, weights, masked_weights, mask_info = fuse(
                self.fusion_query, modalities
            )
        logits = linear(self.classifier, pooled.squeeze(1))
        if return_info:
            info: Dict[str, Any] = dict(mask_info)
            info["attention_weights"] = weights
            info["masked_attention_weights"] = masked_weights
            return logits, info
        return logits
