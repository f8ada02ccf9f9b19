"""Entropy-driven curriculum masking — pure-functional core, in PyTorch.

Port of :mod:`aecf_tpu.core.masking` with the same 11-step semantics
contract (branchless ``where`` chains, xlogy entropy clamped to
``[0, log L]``, one Bernoulli draw, whole-row ``min_active`` replacement,
renormalisation with the ``<= 1e-8`` fallback).  The Bernoulli draw is
``uniform < keep`` with the kernels' uniforms: Philox keyed by the call's
seed words at counter ``(row, slot // 4, 0, 0)``
(:func:`aecf_tpu_torch.kernels.draws.uniforms`), so the torch training
path (``implementation='torch'``) draws the mask the kernels draw for the
same words, on the card from one launch that reads words held there.
``mask_override`` injects a pre-drawn mask, which is how tests hold this
module to the JAX package and to the goldens.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from ..kernels.draws import draw_key, uniforms

__all__ = [
    "CurriculumMaskingConfig",
    "compute_entropy",
    "curriculum_mask",
    "entropy_loss",
    "EPS",
]

# Matches the reference's registered `_eps` buffer (AECFLayer.py:96).
EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class CurriculumMaskingConfig:
    """Static curriculum-masking configuration with the reference's
    constructor validation (AECFLayer.py:84-89)."""

    base_mask_prob: float = 0.15
    entropy_target: float = 0.7
    min_active: int = 1

    def __post_init__(self):
        if not 0.0 < self.base_mask_prob <= 1.0:
            raise ValueError(
                f"base_mask_prob must be in (0, 1], got {self.base_mask_prob}"
            )
        if not 0.0 < self.entropy_target <= 1.0:
            raise ValueError(
                f"entropy_target must be in (0, 1], got {self.entropy_target}"
            )
        if self.min_active < 1:
            raise ValueError(f"min_active must be >= 1, got {self.min_active}")


class _NegSumXlogy(torch.autograd.Function):
    """``-Σ xlogy(w, w)`` over the last axis with an analytic gradient.

    d/dw[-w·log w] = -(log w + 1), thresholded at 1e-30 (a NORMAL f32):
    autograd of ``xlogy`` at an exact-zero weight (a padded slot) gives an
    infinite derivative, and ``0·inf = NaN`` would poison every upstream
    gradient even under a zero cotangent.
    """

    @staticmethod
    def forward(ctx, weights):
        ctx.save_for_backward(weights)
        return -torch.xlogy(weights, weights).sum(dim=-1)

    @staticmethod
    def backward(ctx, grad):
        (weights,) = ctx.saved_tensors
        g = -(torch.log(weights.clamp_min(1e-30)) + 1.0)
        return g * grad.unsqueeze(-1)


def compute_entropy(weights: torch.Tensor) -> torch.Tensor:
    """Shannon entropy over the last axis, clamped to ``[0, log L]``
    (``0 · log 0 == 0``; gradient analytic and finite at ``w == 0``)."""
    entropy = _NegSumXlogy.apply(weights)
    return entropy.clamp(0.0, math.log(weights.shape[-1]))


def _top_k_indicator(weights: torch.Tensor, k: int) -> torch.Tensor:
    """One-hot union of the top-``k`` elements per row, ties to the lowest
    index (a stable descending sort keeps first-occurrence order, as
    ``lax.top_k`` does)."""
    top_idx = torch.sort(weights, dim=-1, descending=True, stable=True).indices
    indicator = torch.zeros_like(weights)
    return indicator.scatter(-1, top_idx[..., :k], 1.0)


def curriculum_mask(
    weights: torch.Tensor,
    *,
    generator=None,
    training: bool = False,
    base_mask_prob: float = 0.15,
    entropy_target: float = 0.7,
    min_active: int = 1,
    mask_override: Optional[torch.Tensor] = None,
    detach_info: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Apply entropy-driven curriculum masking to ``(..., L)`` weights.

    Eval returns the weights untouched with ``{entropy, mask_rate=0}``.
    Training draws one Bernoulli keep-mask keyed by ``generator`` — a
    ``torch.Generator`` (two seed words drawn from it), seed words, or a
    ``(2,)`` int32 words tensor on the weights' device
    (:func:`aecf_tpu_torch.kernels.draws.draw_key`); required unless
    ``mask_override``, a pre-drawn mask of ``weights.shape``, is given —
    and returns ``(masked_weights, {entropy, mask_rate,
    target_entropy})``.  Row ``r`` of the weights flattened to ``(rows,
    L)`` keeps slot ``l`` where ``uniforms(key, rows, L)[r, l] < keep``.  ``detach_info=False`` lets the entropy carry
    gradient (the opt-in extension; the reference detaches, quirk Q2).
    """
    seq_len = weights.shape[-1]
    dtype = weights.dtype
    batch_shape = weights.shape[:-1]

    if not training:
        return weights, {
            "entropy": compute_entropy(weights),
            "mask_rate": weights.new_zeros(batch_shape),
        }

    if seq_len <= 1:
        zeros = weights.new_zeros(batch_shape)
        return weights, {
            "entropy": zeros,
            "mask_rate": zeros,
            "target_entropy": zeros,
        }

    # Step 2: scrub non-finite values (identity when finite).
    weights = torch.where(torch.isfinite(weights), weights, 0.0)

    # Step 3: normalize, with uniform fallback for degenerate rows.
    weight_sums = weights.sum(dim=-1, keepdim=True)
    needs_norm = weight_sums < EPS
    safe_sums = torch.where(needs_norm, 1.0, weight_sums)
    weights = torch.where(needs_norm, 1.0 / seq_len, weights / safe_sums)

    # Steps 4-5: entropy → adaptive mask probability.
    entropy = compute_entropy(weights)
    max_entropy = math.log(float(seq_len))
    norm_entropy = (entropy / max_entropy).clamp(0.0, 1.0)
    keep_prob = (1.0 - base_mask_prob * norm_entropy[..., None]).clamp(0.0, 1.0)

    # Step 6: the single Bernoulli draw.
    if mask_override is not None:
        mask = mask_override.to(dtype)
    else:
        if generator is None:
            raise ValueError(
                "curriculum_mask(training=True) needs a torch.Generator "
                "(or a `mask_override`)."
            )
        rows = math.prod(batch_shape)
        u = uniforms(draw_key(generator), rows, seq_len,
                     device=weights.device).reshape(weights.shape)
        mask = (u < keep_prob.detach()).to(dtype)

    # Step 7: min_active constraint — whole-row replacement.
    effective_min_active = min(int(min_active), seq_len)
    needs_more = mask.sum(dim=-1) < effective_min_active
    min_mask = _top_k_indicator(weights, effective_min_active)
    mask = torch.where(needs_more[..., None], min_mask, mask)

    # Step 8: mask, renormalize, degenerate-row fallback.
    masked_weights = weights * mask
    weight_sum = masked_weights.sum(dim=-1, keepdim=True)
    valid = weight_sum > EPS
    safe_weight_sum = torch.where(valid, weight_sum, 1.0)
    final_weights = torch.where(valid, masked_weights / safe_weight_sum, weights)

    # Steps 9-10: info assembly.
    mask_rate = 1.0 - mask.mean(dim=-1)
    info = {
        "entropy": entropy.detach() if detach_info else entropy,
        "mask_rate": mask_rate.detach(),
        "target_entropy": torch.full_like(
            entropy, max_entropy * entropy_target
        ).detach(),
    }
    return final_weights, info


def entropy_loss(
    entropy: torch.Tensor,
    seq_len: int = 2,
    entropy_target: float = 0.7,
) -> torch.Tensor:
    """MSE between observed entropy and ``log(seq_len) * entropy_target``;
    non-finite entropies are scrubbed ``nan→0, +inf→1, -inf→0``."""
    entropy = torch.nan_to_num(entropy, nan=0.0, posinf=1.0, neginf=0.0)
    max_entropy = math.log(float(seq_len)) if seq_len > 1 else 0.0
    diff = entropy - max_entropy * entropy_target
    return (diff * diff).mean().clamp_min(0.0)
