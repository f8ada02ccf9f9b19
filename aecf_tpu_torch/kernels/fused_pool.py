"""Capability and preference gates of the fused fusion-pool kernels.

Port of the gates in :mod:`aecf_tpu.kernels.fused_pool`.  The per-row-query
kernel itself (``_fusion_kernel``) is not ported yet (ROADMAP.md).  Both
gates encode the JAX package's TPU measurements; re-deriving them on the
H100 is open work.
"""

from __future__ import annotations

from .shared_query import _RESIDENT_E_CAP, _STREAMED_E_CAP

__all__ = ["supports_fused", "prefers_fused"]


def supports_fused(
    *,
    tgt_len: int,
    num_heads: int,
    embed_dim: int,
    dropout: float = 0.0,
    has_masks: bool = False,
    shared_query: bool = False,
) -> bool:
    """Config gate for the fused kernels; unsupported configs take the
    torch path.  Query length 1, no dropout, no attention masks, heads
    dividing E, and E under the resident cap — or, for a shared query with
    H ≤ 2, under the streamed-split cap."""
    e_cap = (
        _STREAMED_E_CAP
        if shared_query and num_heads <= 2
        else _RESIDENT_E_CAP
    )
    return (
        tgt_len == 1
        and dropout == 0.0
        and not has_masks
        and embed_dim % num_heads == 0
        and embed_dim <= e_cap
    )


def prefers_fused(*, num_heads: int) -> bool:
    """Performance preference (vs capability — :func:`supports_fused`): the
    fused kernels for H ≤ 2.  On the TPU the per-head GEMMs lost to XLA's
    batched heads from H=4 up; the boundary has not been measured on the
    H100."""
    return num_heads <= 2
