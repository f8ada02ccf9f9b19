"""X-ray experiment models, in PyTorch: concat-fusion baseline and AECF.

Port of :mod:`aecf_tpu.models.xray`.  Every row flows through all three
routes (both modalities, image only, text only) and the result is chosen
per row with presence masks through ``torch.where`` — never boolean
indexing — so shapes stay static.  Missing-modality simulation keeps the
reference's semantics (independent drops at ``missing_prob`` per
modality, a coin flip rescues one of the two where both would drop).
``curriculum_enabled`` and ``missing_modality_training`` are per-call
flags of ``forward``.  Attribute names equal the JAX parameter dataclass
fields, so :func:`aecf_tpu_torch.convert.params_from_numpy` loads a
flattened JAX pytree.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..core.init import init_attention_pool_params
from ..kernels.draws import generator_on
from ..ops import fusion_pool
from .layers import dropout, fork_generator, init_linear, linear, mlp_encoder

__all__ = ["PRESENCE_EPS", "XrayAECFModel", "XrayBaselineModel"]

# Presence = ‖features‖ > 1e-6 (the reference's rule).
PRESENCE_EPS = 1e-6


def _presence(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=1) > PRESENCE_EPS


def _route(fused, img_only, txt_only, both, only_img, only_txt):
    """Per row: ``fused`` where both modalities are present, else the
    present one's route, else zeros."""
    return torch.where(
        both[:, None],
        fused,
        torch.where(
            only_img[:, None],
            img_only,
            torch.where(only_txt[:, None], txt_only, 0.0),
        ),
    )


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


class XrayBaselineModel(nn.Module):
    """Concat-fusion control model: 512 / 512 → 256 encoders, 80 classes.

    Parameters are drawn on the CPU from ``generator`` and moved to
    ``device`` (the card unless the caller asks for another); training
    (``self.training``) draws its dropout from the CPU ``generator`` passed
    to ``forward``."""

    name = "Concat_Baseline"

    def __init__(
        self,
        image_dim: int = 512,
        text_dim: int = 512,
        num_classes: int = 80,
        hidden_dim: int = 256,
        *,
        generator: Optional[torch.Generator] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__()
        g = _generator(generator)
        h = hidden_dim
        self.hidden_dim = h
        self.num_classes = num_classes
        self.image_encoder = init_linear(g, image_dim, h)
        self.text_encoder = init_linear(g, text_dim, h)
        self.image_proj = init_linear(g, h, 2 * h)
        self.text_proj = init_linear(g, h, 2 * h)
        self.classifier_hidden = init_linear(g, 2 * h, h)
        self.classifier_out = init_linear(g, h, num_classes)
        self.to(device)

    def forward(
        self,
        image_features: torch.Tensor,  # (B, image_dim)
        text_features: torch.Tensor,  # (B, text_dim)
        *,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        img = mlp_encoder(self.image_encoder, image_features,
                          generator=generator, training=self.training)
        txt = mlp_encoder(self.text_encoder, text_features,
                          generator=generator, training=self.training)
        img_present = _presence(image_features)
        txt_present = _presence(text_features)
        fused = _route(
            torch.cat([img, txt], dim=-1),
            linear(self.image_proj, img),
            linear(self.text_proj, txt),
            img_present & txt_present,
            img_present & ~txt_present,
            ~img_present & txt_present,
        )
        hidden = torch.relu(linear(self.classifier_hidden, fused))
        hidden = dropout(hidden, 0.1, generator, self.training)
        return linear(self.classifier_out, hidden)


class XrayAECFModel(nn.Module):
    """AECF model with controllable curriculum masking: 512 / 512 → 256
    encoders, four-head fusion, 80 classes.

    Parameters are drawn on the CPU from ``generator`` (the fusion query
    from ``0.02·N(0, 1)``, the reference's) and moved to ``device`` (the
    card unless the caller asks for another).  Training (``self.training``)
    draws from the CPU ``generator`` passed to ``forward``, in this order:
    the missing-modality simulation, the encoders' dropout, the curriculum
    mask (from a generator forked off it, :func:`.layers.fork_generator`),
    the classifier's dropout.  The pool is
    :func:`aecf_tpu_torch.ops.fusion_pool` with ``'auto'`` dispatch (the
    torch path at H = 4).
    """

    name = "AECF_Model"

    def __init__(
        self,
        image_dim: int = 512,
        text_dim: int = 512,
        num_classes: int = 80,
        hidden_dim: int = 256,
        num_heads: int = 4,
        base_mask_prob: float = 0.15,
        entropy_target: float = 0.7,
        min_active: int = 1,
        missing_prob: float = 0.3,
        *,
        generator: Optional[torch.Generator] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__()
        g = _generator(generator)
        h = hidden_dim
        self.hidden_dim = h
        self.num_classes = num_classes
        self.num_heads = num_heads
        self.base_mask_prob = base_mask_prob
        self.entropy_target = entropy_target
        self.min_active = min_active
        self.missing_prob = missing_prob
        self.image_encoder = init_linear(g, image_dim, h)
        self.text_encoder = init_linear(g, text_dim, h)
        self.pool = init_attention_pool_params(g, h)
        self.fusion_query = nn.Parameter(
            0.02 * torch.randn((1, 1, h), generator=g)
        )
        self.image_proj = init_linear(g, h, 2 * h)
        self.text_proj = init_linear(g, h, 2 * h)
        self.fusion_proj = init_linear(g, h, 2 * h)
        self.classifier_hidden = init_linear(g, 2 * h, h)
        self.classifier_out = init_linear(g, h, num_classes)
        self.to(device)

    def simulate_missing_modalities(
        self,
        generator: torch.Generator,
        image_features: torch.Tensor,
        text_features: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Drop each modality of a row with probability ``missing_prob``;
        where both would drop, a coin flip keeps one of them."""
        B = image_features.shape[0]
        g = generator_on(generator, image_features.device)
        dev = image_features.device
        mask_image = torch.rand(B, generator=g, device=dev) < self.missing_prob
        mask_text = torch.rand(B, generator=g, device=dev) < self.missing_prob
        both_masked = mask_image & mask_text
        keep_image = torch.rand(B, generator=g, device=dev) > 0.5
        mask_image = torch.where(both_masked, ~keep_image, mask_image)
        mask_text = torch.where(both_masked, keep_image, mask_text)
        image_features = torch.where(mask_image[:, None], 0.0, image_features)
        text_features = torch.where(mask_text[:, None], 0.0, text_features)
        return image_features, text_features

    def forward(
        self,
        image_features: torch.Tensor,  # (B, image_dim)
        text_features: torch.Tensor,  # (B, text_dim)
        *,
        generator: Optional[torch.Generator] = None,
        curriculum_enabled: bool = False,
        missing_modality_training: bool = False,
        return_info: bool = False,
    ) -> Union[torch.Tensor, Tuple[torch.Tensor, Dict[str, Any]]]:
        training = self.training
        info: Dict[str, Any] = {}
        if training and missing_modality_training:
            if generator is None:
                raise ValueError(
                    "missing_modality_training needs a `generator=`"
                )
            image_features, text_features = self.simulate_missing_modalities(
                generator, image_features, text_features
            )
        img = mlp_encoder(self.image_encoder, image_features,
                          generator=generator, training=training)
        txt = mlp_encoder(self.text_encoder, text_features,
                          generator=generator, training=training)
        img_present = _presence(image_features)
        txt_present = _presence(text_features)
        both = img_present & txt_present

        # The attention route runs densely for every row; masking only when
        # the curriculum is enabled.
        modalities = torch.stack([img, txt], dim=1)  # (B, 2, hidden)
        attn_out, weights, masked_weights, mask_info = fusion_pool(
            self.pool,
            self.fusion_query,
            modalities,
            num_heads=self.num_heads,
            generator=fork_generator(generator),
            training=training and curriculum_enabled,
            base_mask_prob=self.base_mask_prob,
            entropy_target=self.entropy_target,
            min_active=self.min_active,
        )
        if curriculum_enabled:
            info.update(mask_info)
            info["attention_weights"] = weights
            if return_info:
                info["masked_attention_weights"] = masked_weights
        elif return_info:
            info["attention_weights"] = weights
        if return_info:
            # the reference's fusion statistics cover the both-present rows
            info["fusion_row_mask"] = both

        fused = _route(
            linear(self.fusion_proj, attn_out.squeeze(1)),
            linear(self.image_proj, img),
            linear(self.text_proj, txt),
            both,
            img_present & ~txt_present,
            ~img_present & txt_present,
        )
        hidden = torch.relu(linear(self.classifier_hidden, fused))
        hidden = dropout(hidden, 0.1, generator, training)
        logits = linear(self.classifier_out, hidden)
        return (logits, info) if return_info else logits
