"""MedicalDiagnosisModel — the three-modality integration pattern, in PyTorch.

Port of :mod:`aecf_tpu.models.medical`: image (1024), lab (50) and
clinical (200) encoders to 512, AECF fusion with ``mask_prob=0.25`` and
eight heads, a 10-class head.  All three slots are always stacked and an
absent modality is a zero slot padded out of the attention with
``key_padding_mask``, so the weights renormalise over the modalities
given, with static shapes.  Attribute names equal the JAX parameter
dataclass fields (``image_encoder.weight``, ``pool.in_proj_weight``, …),
so :func:`aecf_tpu_torch.convert.params_from_numpy` loads a flattened JAX
pytree.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..core.init import init_attention_pool_params, init_fusion_query
from ..ops import fusion_pool
from ..kernels.draws import Draws
from .layers import fork_generator, init_linear, linear, mlp_encoder

__all__ = ["MedicalDiagnosisModel"]


class MedicalDiagnosisModel(nn.Module):
    """Image + lab + clinical → 512-wide eight-head fusion → 10 classes.

    Parameters are drawn on the CPU from ``generator`` (a fresh seed-0
    generator by default), then moved to ``device`` (the card unless the
    caller asks for another).  ``forward`` trains after ``self.training``:
    the encoders' dropout and the curriculum mask (keyed by a fold of the
    words, :func:`.layers.fork_generator`) are keyed by the ``generator``
    passed to it (a CPU generator, a step's seed words or a ``(2,)`` int32
    words tensor on the card; :meth:`Draws.of`), site by site in that
    order.  The pool is
    :func:`aecf_tpu_torch.ops.fusion_pool` with ``'auto'`` dispatch (the
    torch path at H = 8).
    """

    def __init__(
        self,
        image_dim: int = 1024,
        lab_dim: int = 50,
        clinical_dim: int = 200,
        hidden_dim: int = 512,
        num_classes: int = 10,
        mask_prob: float = 0.25,
        num_heads: int = 8,
        entropy_target: float = 0.7,
        min_active: int = 1,
        *,
        generator: Optional[torch.Generator] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_classes = num_classes
        self.mask_prob = mask_prob
        self.num_heads = num_heads
        self.entropy_target = entropy_target
        self.min_active = min_active
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.image_encoder = init_linear(g, image_dim, hidden_dim)
        self.lab_encoder = init_linear(g, lab_dim, hidden_dim)
        self.clinical_encoder = init_linear(g, clinical_dim, hidden_dim)
        self.fusion_query = nn.Parameter(init_fusion_query(g, hidden_dim))
        self.pool = init_attention_pool_params(g, hidden_dim)
        self.classifier = init_linear(g, hidden_dim, num_classes)
        self.to(device)

    def forward(
        self,
        image: Optional[torch.Tensor] = None,  # (B, image_dim)
        lab: Optional[torch.Tensor] = None,  # (B, lab_dim)
        clinical: Optional[torch.Tensor] = None,  # (B, clinical_dim)
        *,
        generator=None,
        return_info: bool = False,
    ) -> Union[torch.Tensor, Tuple[torch.Tensor, Dict[str, Any]]]:
        provided = [x for x in (image, lab, clinical) if x is not None]
        if not provided:
            raise ValueError("At least one modality must be provided")
        B = provided[0].shape[0]
        device = provided[0].device
        draws = Draws.of(generator) if self.training else None
        slots, padding = [], []
        for x, enc in ((image, self.image_encoder), (lab, self.lab_encoder),
                       (clinical, self.clinical_encoder)):
            if x is None:
                slots.append(torch.zeros((B, self.hidden_dim), device=device))
                padding.append(torch.ones((B,), dtype=torch.bool, device=device))
            else:
                slots.append(mlp_encoder(enc, x, generator=draws,
                                         training=self.training))
                padding.append(torch.zeros((B,), dtype=torch.bool,
                                           device=device))
        modalities = torch.stack(slots, dim=1)  # (B, 3, hidden)
        key_padding_mask = torch.stack(padding, dim=1)  # (B, 3)

        pooled, weights, masked_weights, mask_info = fusion_pool(
            self.pool,
            self.fusion_query,
            modalities,
            num_heads=self.num_heads,
            generator=fork_generator(draws),
            # masking runs whenever training, like the reference module
            training=self.training,
            base_mask_prob=self.mask_prob,
            entropy_target=self.entropy_target,
            min_active=self.min_active,
            key_padding_mask=key_padding_mask,
        )
        logits = linear(self.classifier, pooled.squeeze(1))
        if return_info:
            info: Dict[str, Any] = dict(mask_info)
            info["attention_weights"] = weights
            info["masked_attention_weights"] = masked_weights
            return logits, info
        return logits
