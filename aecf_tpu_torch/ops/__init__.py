"""Op-level API: device-dispatched building blocks.

``fusion_pool`` is the one-call fusion op used by the models — it picks the
CUDA kernel when the config qualifies and takes the torch oracle path
otherwise, so model code stays device-agnostic.  The lower layers remain
importable: :mod:`aecf_tpu_torch.core` (pure math) and
:mod:`aecf_tpu_torch.kernels` (CUDA kernels).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core.attention import (
    AttentionPoolParams,
    PoolTensors,
    attention_pool_core,
)
from ..core.masking import curriculum_mask
from ..core.precision import run_at
from ..kernels import (
    fused_fusion_pool,
    fused_fusion_pool_shared,
    prefers_fused,
    supports_fused,
)
from ..kernels.fused_pool import _kernel_takes
from ..kernels.shared_query import (
    _MAX_M,
    _check_kv_scales,
    _dequant,
    _shared_takes,
)
from ..kernels.draws import generator_on

__all__ = ["fusion_pool"]


def _wants_kernel(params, query, kv, *, num_heads, precision):
    """Static gate of ``implementation='auto'``: the kernels run only where
    they are ported, cannot change the call's meaning and are preferred.
    Training and gradients take them too — for a shared ``(1, 1, E)``
    query (E up to the streamed-split cap) the resident or streamed
    forward kernel with in-kernel masking and their backward kernels, f32,
    bf16 or int8 features; for a per-row ``(B, 1, E)`` query the per-row
    forward kernel, f32 or bf16.  H > 2 takes the torch path here although
    the resident kernels take any H dividing E (``implementation=
    'kernel'``): ``prefers_fused`` keeps the JAX package's rule until the
    card's H > 2 times decide it (PERF.md §6, ROADMAP.md queue 2, item
    7)."""
    E = query.shape[-1]
    shared = query.shape[0] == 1
    dtypes = (torch.float32, torch.bfloat16) + ((torch.int8,) if shared else ())
    return (
        kv.is_cuda
        and supports_fused(
            tgt_len=query.shape[1], num_heads=num_heads, embed_dim=E,
            shared_query=shared,
        )
        and prefers_fused(num_heads=num_heads)
        and (
            _shared_takes(num_heads, E)
            if shared
            else _kernel_takes(kv.shape[1], E, num_heads)
        )
        and query.dtype == torch.float32
        and kv.dtype in dtypes
        # the kernel implements "highest"/"default" only
        and precision != "high"
        # M <= 1 masking is a no-op that the oracle handles; M above the
        # kernel's register arrays goes there too
        and 1 < kv.shape[1] <= _MAX_M
    )


def fusion_pool(
    params: AttentionPoolParams,
    query: torch.Tensor,  # (1, 1, E) shared or (B, 1, E) per-row
    kv: torch.Tensor,  # (B, M, E)
    *,
    num_heads: int = 1,
    generator: Optional[torch.Generator] = None,
    training: bool = False,
    base_mask_prob: float = 0.15,
    entropy_target: float = 0.7,
    min_active: int = 1,
    key_padding_mask: Optional[torch.Tensor] = None,
    implementation: str = "auto",
    precision: str = "highest",
    kv_grad: bool = True,
    kv_scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Attention pool + curriculum masking with device dispatch.

    Returns ``(out (B,1,E), weights (B,1,M), masked (B,1,M), info)``.
    ``implementation='auto'`` runs a CUDA kernel where
    :func:`_wants_kernel` allows it — the shared-query kernels for a
    ``(1, 1, E)`` query, the per-row kernel for a ``(B, 1, E)`` one;
    ``'torch'`` forces the oracle path; ``'kernel'`` forces the kernel
    (its plain version for CPU tensors).  A head-sharded pool
    (:func:`aecf_tpu_torch.parallel.shard_params_tp`) runs the torch path
    over this rank's heads (``tensor_parallel.sharded_fusion_pool``).
    ``generator`` (a CPU ``torch.Generator``) draws the training mask: the
    kernel takes two seed words from it, the torch path draws
    ``torch.bernoulli`` from it or, for features on a card, from a
    generator there seeded from two words drawn from it
    (:func:`aecf_tpu_torch.kernels.draws.generator_on`; a generator on
    ``kv``'s device is used as it is).  ``kv_grad=False`` detaches the
    features.  The torch path runs under the float32 matmul mode
    ``precision`` names (:func:`aecf_tpu_torch.core.matmul_precision`:
    ``'highest'`` is IEEE f32 whatever the process set), its backward
    too (:func:`aecf_tpu_torch.core.run_at`), and leaves the process's
    mode as it found it.

    int8 features: pass ``kv`` as int8 with ``kv_scales (B, M)`` (see
    :func:`aecf_tpu_torch.kernels.quantize_features`); they are frozen
    (gradients reach the parameters and the query only).  The shared-query
    kernels read them as int8; the per-row kernel and the torch path take
    the dequantized features, detached.
    """
    if implementation not in ("auto", "torch", "kernel"):
        raise ValueError(
            f"unknown implementation {implementation!r} "
            "(expected 'auto', 'torch', or 'kernel')"
        )
    _check_kv_scales(kv, kv_scales)
    from ..parallel.tensor_parallel import HeadShardedPool, sharded_fusion_pool

    sharded = isinstance(params, HeadShardedPool)
    if sharded and implementation == "kernel":
        raise ValueError(
            "a head-sharded pool runs the torch route (its entropy reads "
            "every head's weights); implementation='kernel' does not apply"
        )
    q8 = kv.dtype == torch.int8
    if not kv_grad:
        kv = kv.detach()
    impl = implementation
    if impl == "auto":
        impl = (
            "kernel"
            if not sharded and _wants_kernel(
                params, query, kv, num_heads=num_heads, precision=precision
            )
            else "torch"
        )

    if q8 and (impl == "torch" or query.shape[0] != 1):
        # no per-row int8 kernel, and the torch path computes in f32:
        # the dequantized features, frozen
        kv = _dequant(kv, kv_scales).detach()
        kv_scales = None

    if impl == "kernel":
        kwargs = dict(
            num_heads=num_heads,
            generator=generator,
            training=training,
            base_mask_prob=base_mask_prob,
            entropy_target=entropy_target,
            min_active=min_active,
            key_padding_mask=key_padding_mask,
        )
        if query.shape[0] == 1:
            return fused_fusion_pool_shared(
                params, query, kv, precision=precision, kv_scales=kv_scales,
                **kwargs
            )
        return fused_fusion_pool(params, query, kv, **kwargs)

    if sharded:
        return sharded_fusion_pool(
            params, query, kv, num_heads=num_heads, generator=generator,
            training=training, base_mask_prob=base_mask_prob,
            entropy_target=entropy_target, min_active=min_active,
            key_padding_mask=key_padding_mask, precision=precision,
        )
    B = kv.shape[0]
    q_full = query.expand(B, *query.shape[1:]) if query.shape[0] == 1 else query

    def pool(q, x, *tensors):
        return attention_pool_core(
            PoolTensors(*tensors),
            q,
            x,
            x,
            num_heads=num_heads,
            key_padding_mask=key_padding_mask,
            need_weights=True,
        )

    out, weights = run_at(precision, pool, q_full, kv, *PoolTensors.of(params))
    masked, info = curriculum_mask(
        weights,
        generator=generator_on(generator, kv.device),
        training=training,
        base_mask_prob=base_mask_prob,
        entropy_target=entropy_target,
        min_active=min_active,
    )
    return out, weights, masked.detach(), info
