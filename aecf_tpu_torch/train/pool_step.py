"""Pool-protocol train-step builder: the product path to the one-pass
train-step kernel.

Port of :mod:`aecf_tpu.train.pool_step` (one step a call; the K-step chunk
is a later item).  The reference's headline training protocol (X3) is
frozen pre-extracted features → fusion pool → linear classifier → BCE.
For H == 1 resident configs on the card that whole step is one pass over
the features (:func:`aecf_tpu_torch.kernels.fused_pool_train_step`);
:func:`make_pool_train_step` makes it the path a library user's training
runs, and autodiffs through :func:`aecf_tpu_torch.ops.fusion_pool`
everywhere else.  All paths run the same protocol and give the same
parameter trajectory to f32 tolerance.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.init import init_attention_pool_params, init_fusion_query
from ..core.masking import entropy_loss
from ..kernels import (
    fused_pool_head_train_step,
    fused_pool_train_step,
    supports_fused_step,
)
from ..kernels.draws import device_generator, draw_seed_words
from .trainer import TrainState, param_leaves

__all__ = [
    "as_fit_step",
    "init_pool_classifier_params",
    "make_pool_train_step",
]

_IMPLS = ("auto", "fused-step", "kernel", "torch")


def init_pool_classifier_params(
    generator: Optional[torch.Generator],
    embed_dim: int,
    num_classes: Optional[int] = None,
    *,
    bias: bool = True,
    head_bias: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, Any]:
    """``{'pool', 'query'[, 'head']}`` parameters for the pool protocol —
    the shape :func:`make_pool_train_step` trains.

    The head keeps the JAX layout: ``w`` is ``(E, C)`` (logits =
    pooled @ w + b), not ``nn.Linear``'s ``(C, E)``; it follows torch's
    ``nn.Linear`` default init (uniform ``±1/√E``).  ``num_classes=None``
    omits it (pool-only training, the benchmark protocol).  The draws are
    made on the generator's device, so a seed gives the same numbers
    wherever the tensors go; they land on ``device`` (the card unless the
    caller asks for another)."""
    params: Dict[str, Any] = {
        "pool": init_attention_pool_params(
            generator, embed_dim, bias=bias
        ).to(device),
        "query": nn.Parameter(
            init_fusion_query(generator, embed_dim).to(device)
        ),
    }
    if num_classes is not None:
        bound = 1.0 / math.sqrt(embed_dim)
        draw_on = generator.device if generator is not None else None

        def uniform(shape):
            t = torch.empty(shape, dtype=torch.float32, device=draw_on)
            t.uniform_(-bound, bound, generator=generator)
            return nn.Parameter(t.to(device))

        head = {"w": uniform((embed_dim, num_classes))}
        if head_bias:
            head["b"] = uniform((num_classes,))
        params["head"] = head
    return params


def _resolve_impl(impl, num_heads, params, kv, precision):
    """``'auto'``: the one-pass step on CUDA tensors where
    :func:`supports_fused_step` holds; else ``ops.fusion_pool``'s own gate
    (the two-pass kernels on CUDA, the torch path on the CPU)."""
    if impl != "auto":
        return impl
    E = params["query"].shape[-1]
    if kv.is_cuda and supports_fused_step(num_heads, E):
        return "fused-step"
    from ..ops import _wants_kernel

    wants = _wants_kernel(
        params["pool"], params["query"], kv, num_heads=num_heads,
        precision=precision,
    )
    return "kernel" if wants else "torch"


def _flat_grads(grads: Dict[str, Any], params: Dict[str, Any]):
    """The fused step's gradient dict in :func:`param_leaves` order."""
    names = [n for n, _ in params["pool"].named_parameters()]
    flat = [grads["pool"][n] for n in names] + [grads["query"]]
    head = params.get("head")
    if head is not None:
        flat += [grads["head"][k] for k in ("w", "b") if head.get(k) is not None]
    return flat


def _make_local_step(
    *,
    num_heads,
    impl,
    precision,
    base_mask_prob,
    entropy_target,
    min_active,
    entropy_coeff,
    training,
):
    """``(params, kv, labels, generator, loss_scale) -> (loss, info,
    grads)`` with ``grads`` in :func:`param_leaves` order — the
    impl-dispatched core of the builder."""

    def local_step(params, kv, labels, generator, loss_scale):
        M = kv.shape[1]
        use = _resolve_impl(impl, num_heads, params, kv, precision)
        head = params.get("head")
        if use == "fused-step":
            if num_heads != 1:
                raise ValueError("impl='fused-step' covers num_heads=1 only")
            kwargs = dict(
                generator=generator,
                training=training,
                base_mask_prob=base_mask_prob,
                entropy_target=entropy_target,
                min_active=min_active,
                precision=precision,
                kv_grad=False,
                loss_scale=loss_scale,
            )
            if head is not None:
                loss, grads, _, info = fused_pool_head_train_step(
                    params["pool"], params["query"], head, kv, labels,
                    **kwargs,
                )
            else:
                loss, d_pool, d_query, _, info = fused_pool_train_step(
                    params["pool"], params["query"], kv, **kwargs
                )
                grads = {"pool": d_pool, "query": d_query}
            if entropy_coeff and "entropy" in info:
                # a detached VALUE (quirk Q2): no gradient to add
                loss = loss + entropy_coeff * loss_scale * entropy_loss(
                    info["entropy"], seq_len=M
                )
            return loss, info, _flat_grads(grads, params)

        from ..ops import fusion_pool

        if use == "torch" and training and generator is not None:
            generator = device_generator(
                draw_seed_words(generator), kv.device
            )
        out, w, mw, info = fusion_pool(
            params["pool"], params["query"], kv,
            num_heads=num_heads,
            generator=generator,
            training=training,
            base_mask_prob=base_mask_prob,
            entropy_target=entropy_target,
            min_active=min_active,
            implementation=use,
            precision=precision,
            kv_grad=False,
        )
        pooled = out[:, 0, :]
        if head is not None:
            logits = pooled @ head["w"]
            if head.get("b") is not None:
                logits = logits + head["b"]
            loss = F.binary_cross_entropy_with_logits(
                logits, labels.to(logits.dtype)
            ) * loss_scale
        else:
            loss = (pooled * pooled).mean() * loss_scale
        if entropy_coeff and "entropy" in info:
            loss = loss + entropy_coeff * loss_scale * entropy_loss(
                info["entropy"], seq_len=M
            )
        info = dict(info)
        info["attention_weights"] = w
        info["masked_attention_weights"] = mw
        leaves = param_leaves(params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), info, list(grads)

    return local_step


def _accumulate(local_step, params, kv, labels, generator, loss_scale,
                accum_steps):
    """Microbatch the local step over ``accum_steps`` equal slices and mean
    the loss and gradients (equal microbatches of a mean loss give the
    full-batch mean).  Each slice draws its own seed words from
    ``generator`` (i.i.d. draws)."""
    B = kv.shape[0]
    if B % accum_steps:
        raise ValueError(
            f"batch size {B} is not divisible by accum_steps={accum_steps}"
        )
    micro = B // accum_steps
    losses, infos, gsum = [], [], None
    for i in range(accum_steps):
        rows = slice(i * micro, (i + 1) * micro)
        loss, info, grads = local_step(
            params, kv[rows], None if labels is None else labels[rows],
            generator, loss_scale,
        )
        losses.append(loss)
        infos.append(info)
        gsum = grads if gsum is None else [
            None if a is None else a + b for a, b in zip(gsum, grads)
        ]
    grads = [None if g is None else g / accum_steps for g in gsum]
    info = {
        k: torch.cat([d[k] for d in infos]) if infos[0][k].ndim
        else torch.stack([d[k] for d in infos])
        for k in infos[0]
    }
    return torch.stack(losses).mean(), info, grads


def make_pool_train_step(
    *,
    num_heads: int = 1,
    impl: str = "auto",
    precision: str = "highest",
    base_mask_prob: float = 0.15,
    entropy_target: float = 0.7,
    min_active: int = 1,
    entropy_coeff: float = 0.0,
    training: bool = True,
    accum_steps: int = 1,
    mesh: Optional[Any] = None,
) -> Callable:
    """Build a pool-protocol training step ``(state, kv, labels,
    generator) -> (state, loss, info)``.

    ``state`` is a :class:`TrainState` whose ``params`` come from
    :func:`init_pool_classifier_params` and whose optimizer the JAX
    builder took as its first argument.  With a ``'head'`` the loss is
    mean BCE-with-logits on the classifier (the X3 protocol — pass
    ``labels (B, C)``); without one it is the benchmark protocol's
    quadratic ``(out²).mean()`` (pass ``labels=None``).  ``entropy_coeff``
    adds the (detached in training, quirk Q2) entropy regularizer.
    ``generator`` is a CPU ``torch.Generator``: each step takes the two
    seed words of its mask draw from it.

    ``impl``: ``'fused-step'`` — the one-pass train-step kernel (H == 1,
    E ≤ 1024): loss, gradients and info in one read of the features;
    ``'kernel'`` (JAX's ``'pallas'``) — autodiff through the two-pass
    kernels (training forward + backward); ``'torch'`` (JAX's ``'xla'``)
    — autodiff through the plain torch oracle, its mask drawn by
    ``torch.bernoulli`` from a generator on ``kv``'s device seeded with
    the step's seed words; ``'auto'`` — the one-pass step on CUDA tensors
    where the config qualifies, else ``ops.fusion_pool``'s own gate (the
    torch path on the CPU, as the JAX builder takes XLA off the TPU).
    On CPU tensors the kernel paths run their plain versions.

    The step sets every leaf's ``.grad`` from the path's gradients and
    calls ``optimizer.step()``.  ``accum_steps`` microbatches the batch.
    ``mesh=`` (data parallelism) is not ported yet.
    """
    if impl not in _IMPLS:
        raise ValueError(
            f"unknown impl {impl!r} (expected one of {', '.join(_IMPLS)})"
        )
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if mesh is not None:
        raise NotImplementedError(
            "mesh= data-parallel training is not ported yet (ROADMAP.md, "
            "queue 1, item 6: parallel/)"
        )
    local_step = _make_local_step(
        num_heads=num_heads, impl=impl, precision=precision,
        base_mask_prob=base_mask_prob, entropy_target=entropy_target,
        min_active=min_active, entropy_coeff=entropy_coeff,
        training=training,
    )

    def step(state: TrainState, kv, labels, generator):
        if accum_steps == 1:
            loss, info, grads = local_step(
                state.params, kv, labels, generator, 1.0
            )
        else:
            loss, info, grads = _accumulate(
                local_step, state.params, kv, labels, generator, 1.0,
                accum_steps,
            )
        _set_grads(param_leaves(state.params), grads)
        state.optimizer.step()
        state.step += 1
        return state, loss, info

    return step


def _set_grads(leaves: List[torch.Tensor], grads) -> None:
    for p, g in zip(leaves, grads):
        p.grad = None if g is None else g.detach().to(p.dtype)


def as_fit_step(pool_step: Callable) -> Callable:
    """Adapt a :func:`make_pool_train_step` step to the ``(state, images,
    texts, labels, generator)`` batch protocol of ``fit``: the two
    ``(B, E)`` feature streams stack into the ``(B, 2, E)`` kv (the X3
    shape — image and text features)."""

    def step(state, images, texts, labels, generator):
        return pool_step(
            state, torch.stack([images, texts], dim=1), labels, generator
        )

    return step
