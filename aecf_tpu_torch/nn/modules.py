"""Module-level API mirroring the reference's public surface, in PyTorch.

Port of :mod:`aecf_tpu.nn.modules`: ``CurriculumMasking`` and
``MultimodalAttentionPool`` as ``nn.Module``s over the pure functions of
:mod:`aecf_tpu_torch.core` and the fused kernels of
:mod:`aecf_tpu_torch.kernels`, with the reference's constructor
validation, train/eval behaviour, info-dict key sets and quirks (Q1: the
masked weights are not applied to the output by default; Q2: the info
entropy is detached in training).

The pool keeps its parameters under ``attention.`` with
``nn.MultiheadAttention``'s names (``attention.in_proj_weight``,
``attention.in_proj_bias``, ``attention.out_proj.weight``,
``attention.out_proj.bias``) and the masking's ``_eps`` buffer, so a
reference checkpoint loads with ``load_state_dict(strict=True)``.

Randomness: one CPU ``torch.Generator`` stands where JAX takes ``rng=``.
The kernels take two seed words from it; the torch path draws from it on
the CPU and, on a card, from a generator on the card seeded from two words
drawn from it (:func:`aecf_tpu_torch.kernels.draws.generator_on`).
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
import torch.utils.checkpoint
from torch import nn

from ..core.attention import (
    AttentionPoolConfig,
    PoolTensors,
    apply_pooled_weights,
    attention_pool_core,
)
from ..core.init import init_attention_pool_params
from ..core.masking import (
    EPS,
    CurriculumMaskingConfig,
    compute_entropy,
    curriculum_mask,
    entropy_loss,
)
from ..core.precision import PRECISIONS, run_at
from ..kernels import (
    fused_fusion_pool,
    fused_fusion_pool_shared,
    supports_fused,
)
from ..kernels.draws import device_generator, draw_seed_words, generator_on
from ..ops import _wants_kernel

__all__ = ["CurriculumMasking", "MultimodalAttentionPool"]

# Deterministic per-process default seeds for modules built without an
# explicit generator (drop-in ergonomics; serious use passes `generator=`).
_DEFAULT_SEEDS = itertools.count()


def _default_generator() -> torch.Generator:
    return torch.Generator().manual_seed(next(_DEFAULT_SEEDS))


class CurriculumMasking(nn.Module):
    """Entropy-driven curriculum masking (reference AECFLayer.py:33-319).

    Stateless apart from train/eval mode, the ``_last_seq_len`` cache the
    reference keeps for :meth:`entropy_loss` (AECFLayer.py:99, :187) and
    the reference's ``_eps`` buffer.  ``base_mask_prob`` and
    ``entropy_target`` are read at call time, so the reference's
    mutate-per-step subclass pattern works; ``schedule=`` (a callable
    ``step -> prob``) with ``step=`` at call time is the first-class form.

    >>> import torch
    >>> masking = CurriculumMasking(base_mask_prob=0.15)
    >>> w = torch.full((4, 3), 1 / 3)               # uniform: max entropy
    >>> masked, info = masking(w, generator=torch.Generator().manual_seed(0))
    >>> tuple(masked.shape), sorted(info)
    ((4, 3), ['entropy', 'mask_rate', 'target_entropy'])
    >>> bool(torch.allclose(masked.sum(-1), torch.ones(4)))
    True
    """

    def __init__(
        self,
        base_mask_prob: float = 0.15,
        entropy_target: float = 0.7,
        min_active: int = 1,
        *,
        detach_info: bool = True,
        schedule: Optional[Callable[[Any], Any]] = None,
    ):
        super().__init__()
        CurriculumMaskingConfig(base_mask_prob, entropy_target, min_active)
        self.base_mask_prob = base_mask_prob
        self.entropy_target = entropy_target
        self.min_active = min_active
        # Extension: detach_info=False makes info['entropy'] differentiable
        # so the entropy regularizer trains; the reference detaches (Q2).
        self.detach_info = detach_info
        self.schedule = schedule
        self._last_seq_len = 2  # reference default (AECFLayer.py:99)
        self.register_buffer("_eps", torch.tensor(EPS))

    def mask_prob_at(self, step: Optional[Any] = None) -> Any:
        """Effective mask prob: ``schedule(step)`` when scheduled, else
        ``base_mask_prob``.  Eval ignores the mask prob, so a scheduled
        module needs no ``step=`` there."""
        if self.schedule is None:
            return self.base_mask_prob
        if step is None:
            if not self.training:
                return self.base_mask_prob  # unused on the eval path
            raise ValueError(
                "this CurriculumMasking has a schedule= — pass the current "
                "`step=` at call time"
            )
        return self.schedule(step)

    def forward(
        self,
        weights: torch.Tensor,
        *,
        generator: Optional[torch.Generator] = None,
        mask_override: Optional[torch.Tensor] = None,
        step: Optional[Any] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if self.training and weights.shape[-1] > 1:
            self._last_seq_len = int(weights.shape[-1])
        return curriculum_mask(
            weights,
            generator=generator_on(generator, weights.device),
            training=self.training,
            base_mask_prob=self.mask_prob_at(step),
            entropy_target=self.entropy_target,
            min_active=self.min_active,
            mask_override=mask_override,
            detach_info=self.detach_info,
        )

    def compute_entropy(self, weights: torch.Tensor) -> torch.Tensor:
        return compute_entropy(weights)

    # Alias kept for reference API parity (AECFLayer.py:113).
    compute_entropy_fused = compute_entropy

    def entropy_loss(self, entropy: torch.Tensor) -> torch.Tensor:
        return entropy_loss(
            entropy,
            seq_len=self._last_seq_len,
            entropy_target=self.entropy_target,
        )

    def extra_repr(self) -> str:
        return (
            f"base_mask_prob={self.base_mask_prob}, "
            f"entropy_target={self.entropy_target}, "
            f"min_active={self.min_active}"
        )


def _param(t: Optional[torch.Tensor]) -> Optional[nn.Parameter]:
    if t is None or isinstance(t, nn.Parameter):
        return t
    return nn.Parameter(t)


class _OutProj(nn.Module):
    """``nn.MultiheadAttention.out_proj``'s parameter names."""

    def __init__(self, weight, bias):
        super().__init__()
        self.weight = _param(weight)
        self.register_parameter("bias", _param(bias))


class _AttentionParams(nn.Module):
    """The pool's parameters under ``nn.MultiheadAttention``'s names; it
    also reads as :class:`~aecf_tpu_torch.core.AttentionPoolParams`
    (``out_proj_weight``/``out_proj_bias``), so the core functions and
    kernels take it as it is.  Parameters of ``params`` are shared, not
    copied."""

    def __init__(self, params):
        super().__init__()
        self.in_proj_weight = _param(params.in_proj_weight)
        self.register_parameter("in_proj_bias", _param(params.in_proj_bias))
        self.out_proj = _OutProj(params.out_proj_weight, params.out_proj_bias)

    @property
    def out_proj_weight(self) -> nn.Parameter:
        return self.out_proj.weight

    @property
    def out_proj_bias(self) -> Optional[nn.Parameter]:
        return self.out_proj.bias


class MultimodalAttentionPool(nn.Module):
    """Cross-attention pooling with optional curriculum masking.

    Mirrors reference ``MultimodalAttentionPool`` (AECFLayer.py:322-552)
    and the JAX module.  Differences from the JAX module forced by
    PyTorch: parameters are the module's own (``attention.*``, see the
    module docstring); ``generator=`` (a CPU ``torch.Generator``) replaces
    ``key=`` at construction and ``rng=`` at call time; ``use_checkpoint``
    maps to ``torch.utils.checkpoint``.

    ``implementation``: ``'torch'`` (the oracle path), ``'kernel'`` (the
    fused kernels: the shared-query kernels for a ``(1, 1, E)`` query, the
    per-row kernel for a ``(B, 1, E)`` one; their plain versions on CPU
    tensors) or ``'auto'`` (the kernels for CUDA features when H ≤ 2).
    Configurations the kernels do not cover take the torch path either way.
    ``precision``: the torch path runs under
    :func:`~aecf_tpu_torch.core.matmul_precision` (``'highest'``, the
    default, is IEEE f32 whatever the process set; ``'default'`` TF32 on
    the card), its backward too (:func:`~aecf_tpu_torch.core.run_at`),
    and restores the process's mode; the shared-query kernels
    run their products on TF32 tensor cores at ``'default'`` on the card,
    the per-row kernel IEEE f32 at every setting, as the JAX package's.
    ``device``: where the parameters go, ``'cuda'`` unless given; with
    ``params=`` and no ``device``, they stay where ``params`` are.

    >>> import torch
    >>> g = torch.Generator().manual_seed(0)
    >>> pool = MultimodalAttentionPool(
    ...     64, curriculum_masking=CurriculumMasking(), generator=g,
    ...     device="cpu")
    >>> q, kv = torch.ones(2, 1, 64), torch.ones(2, 3, 64)
    >>> out, info = pool.train()(q, kv, generator=g, return_info=True)
    >>> tuple(out.shape), tuple(info["attention_weights"].shape)
    ((2, 1, 64), (2, 1, 3))
    >>> tuple(pool.eval()(q, kv).shape)              # eval: no generator
    (2, 1, 64)
    """

    def __init__(
        self,
        embed_dim: int,
        num_heads: int = 1,
        dropout: float = 0.0,
        bias: bool = True,
        curriculum_masking: Optional[CurriculumMasking] = None,
        batch_first: bool = True,
        dtype: torch.dtype = torch.float32,
        *,
        generator: Optional[torch.Generator] = None,
        params: Optional[Any] = None,
        implementation: str = "auto",
        apply_masking_to_output: bool = False,
        precision: str = "highest",
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__()
        self.config = AttentionPoolConfig(
            embed_dim=embed_dim,
            num_heads=num_heads,
            dropout=dropout,
            bias=bias,
            batch_first=batch_first,
        )
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.batch_first = batch_first
        self.curriculum_masking = curriculum_masking
        # Extension: when True the output is recomputed from the masked
        # weights.  The reference never does this (quirk Q1).
        self.apply_masking_to_output = apply_masking_to_output
        if implementation not in ("auto", "torch", "kernel"):
            raise ValueError(f"unknown implementation {implementation!r}")
        self.implementation = implementation
        # The torch path runs under core.matmul_precision(precision),
        # forward and backward ('highest' is IEEE f32, 'default' TF32 on
        # the card), the shared-query kernels take it too.  'high' keeps
        # the call on the torch path (the JAX kernels implement 'default'
        # and 'highest' only).
        if precision not in PRECISIONS:
            raise ValueError(
                f"precision must be 'default', 'high', or 'highest', "
                f"got {precision!r}"
            )
        self.precision = precision
        if params is None:
            params = init_attention_pool_params(
                generator if generator is not None else _default_generator(),
                embed_dim, bias=bias, dtype=dtype,
            )
            if device is None:
                device = "cuda"
        self.attention = _AttentionParams(params)
        if device is not None:
            self.to(device)

    @property
    def params(self) -> _AttentionParams:
        """The pool's parameters, in the form the core functions take."""
        return self.attention

    # -- validation (reference AECFLayer.py:449-498) --------------------------
    def _validate(self, query, key, value):
        for name, t in (("query", query), ("key", key), ("value", value)):
            if not isinstance(t, torch.Tensor):
                raise TypeError(f"Expected {name} to be a tensor, got {type(t)}")
            if t.ndim != 3:
                raise ValueError(
                    f"Expected 3D {name} tensor with "
                    f"batch_first={self.batch_first}, got {t.ndim}D"
                )
        if self.batch_first:
            batch_size, _, embed_dim = query.shape
            src_len = key.shape[1]
            if src_len == 0:
                raise ValueError("Key sequence length cannot be zero")
            # Extension over the reference: a batch-1 query broadcasts over
            # the key batch (the shared fusion query, the shared-query
            # kernels' fast path).
            if (
                key.shape[0] != batch_size and batch_size != 1
            ) or key.shape[2] != embed_dim:
                raise ValueError(
                    f"Key shape {tuple(key.shape)} incompatible with query "
                    f"shape {tuple(query.shape)}"
                )
            if (
                value.shape[0] != key.shape[0]
                or value.shape[1] != key.shape[1]
                or value.shape[2] != embed_dim
            ):
                raise ValueError(
                    f"Value shape {tuple(value.shape)} incompatible with key "
                    f"shape {tuple(key.shape)}"
                )
        else:
            _, batch_size, embed_dim = query.shape
            src_len = key.shape[0]
            if src_len == 0:
                raise ValueError("Key sequence length cannot be zero")
            if key.shape[1] != batch_size or key.shape[2] != embed_dim:
                raise ValueError(
                    f"Shape mismatch: query {tuple(query.shape)}, key "
                    f"{tuple(key.shape)}"
                )
            if (
                value.shape[0] != src_len
                or value.shape[1] != batch_size
                or value.shape[2] != embed_dim
            ):
                raise ValueError(
                    f"Value shape {tuple(value.shape)} incompatible with key "
                    f"shape {tuple(key.shape)}"
                )

    # -- forward --------------------------------------------------------------
    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: Optional[torch.Tensor] = None,
        key_padding_mask: Optional[torch.Tensor] = None,
        attn_mask: Optional[torch.Tensor] = None,
        return_info: bool = False,
        use_checkpoint: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
        mask_override: Optional[torch.Tensor] = None,
        params: Optional[Any] = None,
        step: Optional[Any] = None,
    ) -> Union[torch.Tensor, Tuple[torch.Tensor, Dict[str, Any]]]:
        # Functional override: any object with the four pool tensors.
        if params is None:
            params = self.attention
        if value is None:
            value = key
        self._validate(query, key, value)
        # Before any layout change: transposes make `value is key` False.
        shared_kv = value is key
        if not self.batch_first:
            query, key, value = (t.transpose(0, 1) for t in (query, key, value))

        dropout_active = self.training and self.config.dropout > 0.0
        if dropout_active and generator is None:
            raise ValueError(
                "Training-mode dropout needs an explicit `generator=`."
            )

        impl = self.implementation
        if impl == "auto":
            # ops.fusion_pool's gate, so the two cannot drift: CUDA features,
            # the kernels' widths, and H <= 2 — the kernels take H > 2 when
            # forced, but 'auto' keeps JAX's rule (H > 2 to XLA) until the
            # card's times decide it (PERF.md §6; ROADMAP.md queue 2, item 7)
            impl = (
                "kernel"
                if _wants_kernel(params, query, key, num_heads=self.num_heads,
                                 precision=self.precision)
                else "torch"
            )
        if impl == "kernel" and self._kernel_supported(
            query, shared_kv, attn_mask, dropout_active, mask_override
        ):
            out, info = self._kernel_forward(
                params, query, key, return_info=return_info,
                generator=generator, step=step,
                key_padding_mask=key_padding_mask,
            )
        else:
            out, info = self._torch_forward(
                params, query, key, value, key_padding_mask, attn_mask,
                return_info=return_info, use_checkpoint=use_checkpoint,
                generator=generator, mask_override=mask_override, step=step,
                dropout_active=dropout_active,
            )
        if not self.batch_first:
            out = out.transpose(0, 1)
        if return_info:
            return out, info
        return out

    def _torch_forward(
        self, params, query, key, value, key_padding_mask, attn_mask, *,
        return_info, use_checkpoint, generator, mask_override, step,
        dropout_active,
    ):
        cm = self.curriculum_masking
        need_weights = cm is not None or return_info
        if query.shape[0] == 1 and key.shape[0] > 1:
            # the batch-1 query _validate admits (the JAX XLA path fails
            # on it: its core does not broadcast)
            query = query.expand(key.shape[0], *query.shape[1:])
        # dropout draws from its own generator, made afresh inside attend()
        # so a checkpoint's recompute draws the same mask
        drop_seed = draw_seed_words(generator) if dropout_active else None

        def attend(q, k, v, *tensors):
            drop_gen = (
                device_generator(drop_seed, q.device) if dropout_active
                else None
            )
            return attention_pool_core(
                PoolTensors(*tensors),
                q,
                k,
                v,
                num_heads=self.num_heads,
                key_padding_mask=key_padding_mask,
                attn_mask=attn_mask,
                dropout_rate=self.config.dropout if dropout_active else 0.0,
                dropout_generator=drop_gen,
                need_weights=need_weights,
            )

        body = attend
        if use_checkpoint and self.training:
            # inside run_at's block, so the recompute runs at its mode too
            def body(*args):
                return torch.utils.checkpoint.checkpoint(
                    attend, *args, use_reentrant=False
                )

        tensors = PoolTensors.of(params)
        out, weights = run_at(self.precision, body, query, key, value,
                              *tensors)

        info: Dict[str, Any] = {}
        if cm is not None and weights is not None:
            if (
                cm.training
                and weights.shape[-1] > 1
                and generator is None
                and mask_override is None
            ):
                raise ValueError(
                    "Training-mode curriculum masking needs an explicit "
                    "`generator=` (or a `mask_override`)."
                )
            masked, mask_info = cm(
                weights, generator=generator, mask_override=mask_override,
                step=step,
            )
            if self.apply_masking_to_output:
                out = run_at(
                    self.precision,
                    lambda w, v, *t: apply_pooled_weights(
                        PoolTensors(*t), w, v, num_heads=self.num_heads
                    ),
                    masked, value, *tensors,
                )
            info.update(mask_info)
            # Grad-carrying raw weights (reference AECFLayer.py:538).
            info["attention_weights"] = weights
            if return_info:
                # Quirk Q1: observability only, detached, never applied.
                info["masked_attention_weights"] = masked.detach()
        elif return_info and weights is not None:
            info["attention_weights"] = weights
        return out, info

    # -- fused-kernel path -----------------------------------------------------
    def _kernel_supported(
        self, query, shared_kv, attn_mask, dropout_active, mask_override
    ) -> bool:
        """Config gate: unsupported configurations take the torch path."""
        return (
            query.shape[1] == 1
            and attn_mask is None
            and not dropout_active
            and mask_override is None
            and shared_kv
            and query.dtype == torch.float32
            and supports_fused(
                tgt_len=1,
                num_heads=self.num_heads,
                embed_dim=self.embed_dim,
                shared_query=query.shape[0] == 1,
            )
            and self.precision != "high"
            and not self.apply_masking_to_output
            # detach_info=False (trainable entropy) needs the torch path:
            # the kernels detach their training entropy
            and (
                self.curriculum_masking is None
                or self.curriculum_masking.detach_info
            )
        )

    def _kernel_forward(
        self, params, query, kv, *, return_info, generator, step,
        key_padding_mask,
    ):
        """Forward through the fused kernels; the torch path's info
        contract.  ``use_checkpoint`` is moot: the kernels' backward
        recomputes instead of saving activations."""
        cm = self.curriculum_masking
        masking_training = cm is not None and cm.training
        M = kv.shape[1]
        if masking_training and M > 1 and generator is None:
            raise ValueError(
                "Training-mode curriculum masking needs an explicit "
                "`generator=` (or a `mask_override`)."
            )
        kwargs = dict(
            num_heads=self.num_heads,
            generator=generator,
            training=masking_training,
            base_mask_prob=cm.mask_prob_at(step) if cm else 0.15,
            entropy_target=cm.entropy_target if cm else 0.7,
            min_active=cm.min_active if cm else 1,
            key_padding_mask=key_padding_mask,
        )
        kv = kv.contiguous()  # batch_first=False hands over a transpose
        if query.shape[0] == 1:
            out, weights, masked, mask_info = fused_fusion_pool_shared(
                params, query, kv, precision=self.precision, **kwargs
            )
        else:
            out, weights, masked, mask_info = fused_fusion_pool(
                params, query, kv, **kwargs
            )
        if masking_training and M > 1:
            cm._last_seq_len = int(M)

        info: Dict[str, Any] = {}
        if cm is not None:
            info.update(mask_info)
            info["attention_weights"] = weights
            if return_info:
                info["masked_attention_weights"] = masked
        elif return_info:
            info["attention_weights"] = weights
        return out, info

    def extra_repr(self) -> str:
        return (
            f"embed_dim={self.embed_dim}, num_heads={self.num_heads}, "
            f"batch_first={self.batch_first}, "
            f"curriculum_masking={self.curriculum_masking is not None}"
        )
