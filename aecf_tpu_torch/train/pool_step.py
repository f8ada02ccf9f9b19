"""Pool-protocol train-step builders: the product path to the one-pass
train-step kernel, one step a call or K steps a call.

Port of :mod:`aecf_tpu.train.pool_step`.  The reference's headline
training protocol (X3) is frozen pre-extracted features → fusion pool →
linear classifier → BCE.
For H == 1 resident configs on the card that whole step is one pass over
the features (:func:`aecf_tpu_torch.kernels.fused_pool_train_step`);
:func:`make_pool_train_step` makes it the path a library user's training
runs, and autodiffs through :func:`aecf_tpu_torch.ops.fusion_pool`
everywhere else.  All paths run the same protocol and give the same
parameter trajectory to f32 tolerance.

:func:`make_pool_scan_train_step` runs K updates a call (JAX's
``lax.scan`` chunk).  On the one-pass route and on the streamed split on
the card the K steps are one CUDA graph — the steps' kernels, torch ops
and optimizer updates captured once and replayed — so the host launches
one graph where it launched tens of kernels a step; elsewhere the K steps
run eagerly in one call.

``mesh=`` on either builder makes it data-parallel over ``axis_name``:
each rank steps on its own rows with the ``1/axis_size``-scaled loss
(``loss_scale=``, so the one-pass kernel's direct gradients are those of
the global mean), then one all-reduce over a flat buffer of gradients,
loss and info means, and the same optimizer update on every rank — the
direct-gradient form of :func:`aecf_tpu_torch.parallel.make_dp_train_step`.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.init import init_attention_pool_params, init_fusion_query
from ..core.masking import entropy_loss
from ..kernels import (
    fused_pool_head_train_step,
    fused_pool_train_step,
    stream_bwd,
    stream_bwd_mh,
    stream_mix,
    supports_fused_step,
    train_step as _step_kernel,
)
from ..kernels._plan import _pick_grid, dtype_name
from ..kernels.draws import draw_seed_words
from ..kernels.shared_query import _vjp_wants_streamed
from ..kernels.train_step import step_plan
from .update import (
    TrainState,
    _axis,
    _flat_grads,
    _graph_chunk,
    _make_step,
    _pool_streams,
    param_leaves,
)

__all__ = [
    "as_fit_chunk",
    "as_fit_step",
    "init_pool_classifier_params",
    "make_pool_scan_train_step",
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
    :func:`supports_fused_step` holds (H == 1, E <= 1024: the chain takes
    every such width); else ``ops.fusion_pool``'s own gate (the two-pass
    kernels on CUDA, the torch path on the CPU)."""
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
    impl-dispatched core of the builders.  ``generator`` is a CPU
    ``torch.Generator`` or a step's two seed words; ``seed_words`` (a
    ``(2,)`` int32 device tensor, the graph's) replaces it: the one-pass
    route passes it on to :func:`fused_pool_train_step`, the others to
    ``ops.fusion_pool`` as the mask's key."""

    def local_step(params, kv, labels, generator, loss_scale, **staged):
        E = params["query"].shape[-1]
        M = kv.shape[1] if kv.ndim == 3 else kv.shape[1] // E
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
                **staged,
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
            generator = draw_seed_words(generator)
        if staged.get("seed_words") is not None:
            generator = staged["seed_words"]
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
    axis_name: str = "data",
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
    — autodiff through the plain torch oracle, its mask keyed by the
    step's seed words by the kernels' Philox rule (the mask the kernel
    routes draw for the same words); ``'auto'`` — the one-pass step on CUDA tensors
    where the config qualifies, else ``ops.fusion_pool``'s own gate (the
    torch path on the CPU, as the JAX builder takes XLA off the TPU).
    On CPU tensors the kernel paths run their plain versions.

    The step sets every leaf's ``.grad`` from the path's gradients and
    updates the optimizer (``train.update._optimizer_step``: the one-pass
    Adam/AdamW kernel on the card where the optimizer qualifies, else
    ``optimizer.step()``).  ``accum_steps`` microbatches the batch:
    microbatch ``i`` takes the generator's next seed words, or the step's
    seed words folded with ``i``.

    ``mesh=`` (a ``DeviceMesh``, :mod:`aecf_tpu_torch.parallel`) makes the
    step data-parallel over ``axis_name``: every rank calls it with its
    own rows (``parallel.shard_batch``) and equal parameters, draws from
    its generator's seed words folded with its axis index
    (``fold_seed_words(words, index)``, JAX's ``fold_in(rng,
    axis_index)``; pass the same generator or seed words on every rank),
    and gets the global-mean loss and the info entries' global means.
    ``accum_steps`` then microbatches each rank's rows.
    """
    _validate(impl, accum_steps)
    local_step = _make_local_step(
        num_heads=num_heads, impl=impl, precision=precision,
        base_mask_prob=base_mask_prob, entropy_target=entropy_target,
        min_active=min_active, entropy_coeff=entropy_coeff,
        training=training,
    )
    return _make_step(local_step, accum_steps, _axis(mesh, axis_name))


def _validate(impl, accum_steps) -> None:
    if impl not in _IMPLS:
        raise ValueError(
            f"unknown impl {impl!r} (expected one of {', '.join(_IMPLS)})"
        )
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")


def _side_by_side(a: torch.Tensor, b: torch.Tensor) -> Optional[torch.Tensor]:
    """The contiguous ``(…, Ea + Eb)`` tensor whose column blocks ``a`` and
    ``b`` are, when they are such views of one buffer (as ``fit`` stages
    them), else None."""
    if (a.dtype != b.dtype or a.device != b.device or a.ndim < 1
            or a.shape[:-1] != b.shape[:-1] or a.stride() != b.stride()
            or a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr()
            or b.storage_offset() != a.storage_offset() + a.shape[-1]):
        return None
    whole = a.as_strided(a.shape[:-1] + (a.shape[-1] + b.shape[-1],),
                         a.stride())
    return whole if whole.is_contiguous() else None


def as_fit_step(pool_step: Callable) -> Callable:
    """Adapt a :func:`make_pool_train_step` step to the ``(state, images,
    texts, labels, generator)`` batch protocol of ``fit``: the two
    ``(B, E)`` feature streams stack into the ``(B, 2, E)`` kv (the X3
    shape — image and text features) — a view when they lie side by side
    in one buffer, as ``fit`` stages them."""

    def step(state, images, texts, labels, generator):
        packed = _side_by_side(images, texts)
        kv = (packed.unflatten(-1, (2, -1))
              if packed is not None and images.shape == texts.shape
              else torch.stack([images, texts], dim=1))
        return pool_step(state, kv, labels, generator)

    return step


def as_fit_chunk(pool_chunk: Callable) -> Callable:
    """:func:`as_fit_step` for the chunk form (leading K axis): the two
    ``(K, B, E)`` streams concatenate on the last axis into the packed
    ``(K, B, 2·E)`` staging — the bytes of stacked modalities, and what
    the CUDA-graph chunk stages; no copy when they lie side by side in one
    buffer, as ``fit`` stages them."""

    def chunk(state, images, texts, labels, rng):
        packed = _side_by_side(images, texts)
        if packed is None:
            packed = torch.cat([images, texts], dim=-1)
        return pool_chunk(state, packed, labels, rng)

    return chunk


def make_pool_scan_train_step(
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
    axis_name: str = "data",
) -> Callable:
    """Multi-step pool-protocol chunk: ``(state, kv, labels, rng) ->
    (state, losses (K,), infos)`` — K updates a call.

    ``kv`` is ``(K, B, M, E)`` or packed ``(K, B, M·E)`` (modalities side
    by side: the two give the same steps), ``labels`` ``(K, B, C)`` (or
    None without a head).  Step ``i`` draws its mask from
    :func:`~aecf_tpu_torch.kernels.draws.fold_seed_words` of ``rng`` (an
    int or two 32-bit words) and the global ``state.step + i`` — JAX's
    ``fold_in(rng, state.step)`` — so chunks chain, and resume, like single
    steps fed those words.  ``infos`` holds per-step means ``(K,)`` of every
    info entry.  The builder's keywords are :func:`make_pool_train_step`'s.

    Where the route on CUDA tensors is the one-pass step (``'fused-step'``,
    or ``'auto'`` at H == 1, E <= 1024) or the streamed split
    (``'kernel'``, or ``'auto'``, where ``_vjp_wants_streamed`` holds: H ≤
    2 above E = 1024, H == 2 from E = 512), and ``accum_steps == 1``,
    without a mesh or over an NCCL group, the K steps run as ONE CUDA
    graph captured under the span ``chunk.capture`` (the graph route of
    :mod:`aecf_tpu_torch.train.update`, which says what is captured and
    what recaptures): the forward kernel reads each step's seed words from
    the graph's buffer, and a change of the plan the route's kernels
    resolve (:mod:`aecf_tpu_torch.kernels.tiles`: the step's products, or
    the streamed kernels' grids) recaptures.  Each replay adds K to
    ``train_step.launches`` — on the streamed split to
    ``stream_mix.launches`` and to ``stream_bwd.launches`` (H == 1) or
    ``stream_bwd_mh.launches`` (H == 2) — each with its ``launches_q8``,
    and, over a mesh, K all-reduces to
    :data:`aecf_tpu_torch.parallel.collectives.counted`.  Every other
    route — the resident two-pass kernels, the torch path,
    ``accum_steps > 1``, CPU tensors, a gloo group — runs its K steps
    eagerly in one call, as JAX's general per-step path does.

    ``mesh=`` makes each step data-parallel as in
    :func:`make_pool_train_step`: ``kv`` and ``labels`` hold this rank's
    rows ``(K, B_local, ...)``, and step ``i`` of shard ``s`` draws from
    ``fold_seed_words(fold_seed_words(rng, state.step + i), s)``.
    """
    _validate(impl, accum_steps)
    local_step = _make_local_step(
        num_heads=num_heads, impl=impl, precision=precision,
        base_mask_prob=base_mask_prob, entropy_target=entropy_target,
        min_active=min_active, entropy_coeff=entropy_coeff,
        training=training,
    )

    def route(state: TrainState, kv4) -> Optional[str]:
        """``'fused-step'`` or ``'streamed'`` where the chunk's steps can
        be one graph, else None."""
        # a step's rows (B, M, E): the route the local step takes
        use = _resolve_impl(impl, num_heads, state.params, kv4[0], precision)
        if use == "fused-step":
            return use
        streamed = use == "kernel" and _vjp_wants_streamed(num_heads,
                                                           kv4.shape[-1])
        return "streamed" if streamed else None

    def chains(state: TrainState, kv4) -> tuple:
        if route(state, kv4) == "fused-step":
            return (_step_kernel,)
        return (stream_mix, stream_bwd if num_heads == 1 else stream_bwd_mh)

    def plan_key(state: TrainState, kv4) -> tuple:
        if route(state, kv4) == "fused-step":
            return _step_plan_key(state, kv4)
        return _stream_plan_key(num_heads, kv4)

    return _graph_chunk(
        local_step, _axis(mesh, axis_name), accum_steps=accum_steps,
        capturable=lambda state, kv4: route(state, kv4) is not None,
        chains=chains, plan_key=plan_key, capture_span="chunk.capture",
        streams=_pool_streams(("labels", "C")))


def _step_plan_key(state: TrainState, kv4: torch.Tensor) -> tuple:
    """The plan the one-pass step's kernels resolve for the chunk's
    ``(K, B, M, E)`` staging (:mod:`..kernels.tiles`)."""
    head = state.params.get("head")
    _, B, M, E = kv4.shape
    return tuple((t.bn, t.splits) for t in step_plan(
        B, M, E, 0 if head is None else head["w"].shape[1], kv4.dtype,
        False, kv4.device, record=False))


def _stream_plan_key(num_heads: int, kv4: torch.Tensor) -> tuple:
    """The grids the streamed kernels resolve for the chunk's ``(K, B,
    M, E)`` staging (:mod:`..kernels.tiles`): the forward's at kv's dtype,
    the backward's at the f32 key without ``d_kv``, as the wrappers
    resolve them."""
    _, _, M, E = kv4.shape
    return (_pick_grid("fwd_streamed", M=M, E=E, H=num_heads,
                       kv_dtype=dtype_name(kv4.dtype), record=False),
            _pick_grid("bwd_streamed", M=M, E=E, H=num_heads,
                       kv_dtype="float32", want_dkv=False, record=False))
