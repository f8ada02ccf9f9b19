"""Cross-attention pooling — pure-functional core, in PyTorch.

Port of :mod:`aecf_tpu.core.attention`.  The parameterization keeps torch's
``nn.MultiheadAttention`` packed layout — ``in_proj_weight`` ``(3E, E)``,
``out_proj_weight`` ``(E, E)`` — and every projection computes
``x @ W.T + b``, so parameters move between the two packages 1:1.

Shapes are batch-first: query ``(B, T, E)``, key/value ``(B, S, E)``; the
returned attention weights are head-averaged ``(B, T, S)``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

__all__ = [
    "AttentionPoolConfig",
    "AttentionPoolParams",
    "PoolTensors",
    "apply_pooled_weights",
    "attention_pool_core",
    "scaled_dot_product_attention",
]


@dataclasses.dataclass(frozen=True)
class AttentionPoolConfig:
    """Static attention-pool configuration, validated as the JAX one
    (reference AECFLayer.py:371-391)."""

    embed_dim: int
    num_heads: int = 1
    dropout: float = 0.0
    bias: bool = True
    batch_first: bool = True

    def __post_init__(self):
        if self.embed_dim <= 0:
            raise ValueError(f"embed_dim must be positive, got {self.embed_dim}")
        if self.num_heads <= 0:
            raise ValueError(f"num_heads must be positive, got {self.num_heads}")
        if self.embed_dim % self.num_heads != 0:
            raise ValueError(
                f"embed_dim ({self.embed_dim}) must be divisible by "
                f"num_heads ({self.num_heads})"
            )
        if not 0.0 <= self.dropout <= 1.0:
            raise ValueError(f"dropout must be in [0, 1], got {self.dropout}")

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


class AttentionPoolParams(nn.Module):
    """Parameters in torch ``nn.MultiheadAttention`` packed layout.

    ``in_proj_weight`` rows ``[0:E]``/``[E:2E]``/``[2E:3E]`` are the Q/K/V
    projections.  The biases may be ``None`` (``bias=False`` pools).
    """

    def __init__(
        self,
        in_proj_weight: torch.Tensor,  # (3E, E)
        out_proj_weight: torch.Tensor,  # (E, E)
        in_proj_bias: Optional[torch.Tensor] = None,  # (3E,)
        out_proj_bias: Optional[torch.Tensor] = None,  # (E,)
    ):
        super().__init__()
        self.in_proj_weight = nn.Parameter(in_proj_weight)
        self.out_proj_weight = nn.Parameter(out_proj_weight)
        for name, value in (
            ("in_proj_bias", in_proj_bias),
            ("out_proj_bias", out_proj_bias),
        ):
            self.register_parameter(
                name, None if value is None else nn.Parameter(value)
            )


class PoolTensors(NamedTuple):
    """A pool's four tensors as a tuple that reads like
    :class:`AttentionPoolParams`: what a block run through
    :func:`aecf_tpu_torch.core.run_at` takes as its inputs."""

    in_proj_weight: torch.Tensor
    in_proj_bias: Optional[torch.Tensor]
    out_proj_weight: torch.Tensor
    out_proj_bias: Optional[torch.Tensor]

    @classmethod
    def of(cls, params) -> "PoolTensors":
        """The four tensors of any object that has them (a pool, a module's
        parameters, this rank's heads)."""
        return cls(params.in_proj_weight, params.in_proj_bias,
                   params.out_proj_weight, params.out_proj_bias)


def _merge_masks(
    scores: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor],
    attn_mask: Optional[torch.Tensor],
) -> torch.Tensor:
    """Apply torch-style masks to ``(B, H, T, S)`` scores.

    Boolean masks: ``True`` means *disallow*.  Float masks are added to the
    scores.  ``attn_mask`` may be ``(T, S)`` or ``(B, T, S)``;
    ``key_padding_mask`` is ``(B, S)`` with ``True`` marking padding.  A
    fully padded row gets all ``-inf`` scores and so NaN weights — the
    oracle's semantics (the kernel path's ``-1e30`` bias gives uniform
    weights instead; each path keeps its own).
    """
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype, device=scores.device)
    if attn_mask is not None:
        if attn_mask.ndim == 2:
            am = attn_mask[None, None, :, :]
        elif attn_mask.ndim == 3:
            am = attn_mask[:, None, :, :]
        else:
            raise ValueError(f"attn_mask must be 2D or 3D, got {attn_mask.ndim}D")
        if am.dtype == torch.bool:
            scores = torch.where(am, neg_inf, scores)
        else:
            scores = scores + am.to(scores.dtype)
    if key_padding_mask is not None:
        kpm = key_padding_mask[:, None, None, :]  # (B,1,1,S)
        if kpm.dtype == torch.bool:
            scores = torch.where(kpm, neg_inf, scores)
        else:
            scores = scores + kpm.to(scores.dtype)
    return scores


def attention_pool_core(
    params: AttentionPoolParams,
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    *,
    num_heads: int,
    key_padding_mask: Optional[torch.Tensor] = None,
    attn_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_generator: Optional[torch.Generator] = None,
    need_weights: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Multi-head cross-attention with packed projections, batch-first.

    Computes ``softmax(QKᵀ/√d)V`` through the in/out projection GEMMs and
    returns ``(output (B,T,E), head-averaged weights (B,T,S) | None)``.
    Attention dropout draws from ``dropout_generator`` and is skipped when
    no generator is given (the JAX oracle's ``dropout_key=None`` rule).
    """
    B, T, E = query.shape
    S = key.shape[1]
    H = num_heads
    Dh = E // H

    w_q, w_k, w_v = params.in_proj_weight.chunk(3, dim=0)
    if params.in_proj_bias is not None:
        b_q, b_k, b_v = params.in_proj_bias.chunk(3, dim=0)
    else:
        b_q = b_k = b_v = None

    def proj(x, w, b):
        y = torch.einsum("bse,fe->bsf", x, w)
        return y if b is None else y + b

    q = proj(query, w_q, b_q).reshape(B, T, H, Dh)
    k = proj(key, w_k, b_k).reshape(B, S, H, Dh)
    v = proj(value, w_v, b_v).reshape(B, S, H, Dh)

    scale = float(Dh) ** -0.5
    scores = torch.einsum("bthd,bshd->bhts", q * scale, k)
    scores = _merge_masks(scores, key_padding_mask, attn_mask)
    attn = torch.softmax(scores, dim=-1)

    if dropout_rate > 0.0 and dropout_generator is not None:
        keep = torch.bernoulli(
            torch.full_like(attn, 1.0 - dropout_rate),
            generator=dropout_generator,
        ).bool()
        attn = torch.where(keep, attn / (1.0 - dropout_rate), 0.0)

    context = torch.einsum("bhts,bshd->bthd", attn, v).reshape(B, T, E)
    out = torch.einsum("bte,fe->btf", context, params.out_proj_weight)
    if params.out_proj_bias is not None:
        out = out + params.out_proj_bias

    if need_weights:
        return out, attn.mean(dim=1)  # (B, T, S), average_attn_weights=True
    return out, None


def apply_pooled_weights(
    params: AttentionPoolParams,
    weights: torch.Tensor,  # (B, T, S) — e.g. masked head-averaged weights
    value: torch.Tensor,  # (B, S, E)
    *,
    num_heads: int,
) -> torch.Tensor:
    """The pool output from externally supplied attention weights,
    ``(weights · V_proj) @ out_proj``: the opt-in
    ``apply_masking_to_output`` extension (the reference never applies
    masked weights, quirk Q1).  Exact for one head; for several heads the
    head-averaged weights apply to every head."""
    B, T, E = weights.shape[0], weights.shape[1], value.shape[2]
    H = num_heads
    Dh = E // H
    w_v = params.in_proj_weight[2 * E :]
    v = torch.einsum("bse,fe->bsf", value, w_v)
    if params.in_proj_bias is not None:
        v = v + params.in_proj_bias[2 * E :]
    v = v.reshape(B, -1, H, Dh)
    context = torch.einsum("bts,bshd->bthd", weights, v).reshape(B, T, E)
    out = torch.einsum("bte,fe->btf", context, params.out_proj_weight)
    if params.out_proj_bias is not None:
        out = out + params.out_proj_bias
    return out


def scaled_dot_product_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Projection-free single-head attention, ``softmax(q kᵀ · scale) v``
    with ``scale = E^-1/2`` by default (no projections — intentionally not
    equivalent to the module path, reference quirk Q3)."""
    if scale is None:
        scale = query.shape[-1] ** -0.5
    scores = torch.einsum("bte,bse->bts", query, key) * scale
    attn = torch.softmax(scores, dim=-1)
    return torch.einsum("bts,bse->bte", attn, value)
