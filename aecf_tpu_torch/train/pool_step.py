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
``lax.scan`` chunk).  On the one-pass route on the card the K steps are one
CUDA graph — the steps' kernels, torch ops and optimizer updates captured
once and replayed — so the host launches one graph where it launched tens
of kernels a step; elsewhere the K steps run eagerly in one call.

``mesh=`` on either builder makes it data-parallel over ``axis_name``:
each rank steps on its own rows with the ``1/axis_size``-scaled loss
(``loss_scale=``, so the one-pass kernel's direct gradients are those of
the global mean), then one all-reduce over a flat buffer of gradients,
loss and info means, and the same optimizer update on every rank — the
direct-gradient form of :func:`aecf_tpu_torch.parallel.make_dp_train_step`.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.init import init_attention_pool_params, init_fusion_query
from ..core.masking import entropy_loss
from ..kernels import (
    fused_pool_head_train_step,
    fused_pool_train_step,
    supports_fused_step,
    train_step as _step_kernel,
)
from ..kernels.draws import device_generator, draw_seed_words, fold_seed_words
from ..kernels.train_step import step_plan
from .trainer import TrainState, param_leaves

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
    impl-dispatched core of the builders.  ``generator`` is a CPU
    ``torch.Generator`` or a step's two seed words; the one-pass route
    also takes ``seed_words`` (a device tensor) and the staged addressing
    of :func:`fused_pool_train_step` (``row_offset``, ``batch_rows``, with
    ``kv`` and ``labels`` holding the staged rows)."""

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
    ``generator``, or folds its index into the step's seed words (i.i.d.
    draws)."""
    B = kv.shape[0]
    if B % accum_steps:
        raise ValueError(
            f"batch size {B} is not divisible by accum_steps={accum_steps}"
        )
    micro = B // accum_steps
    losses, infos, gsum = [], [], None
    for i in range(accum_steps):
        rows = slice(i * micro, (i + 1) * micro)
        # seed words fold the microbatch index in (JAX's fold_in(rng, i))
        gen = fold_seed_words(generator, i) if isinstance(generator, tuple) \
            else generator
        loss, info, grads = local_step(
            params, kv[rows], None if labels is None else labels[rows],
            gen, loss_scale,
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
    — autodiff through the plain torch oracle, its mask drawn by
    ``torch.bernoulli`` from a generator on ``kv``'s device seeded with
    the step's seed words; ``'auto'`` — the one-pass step on CUDA tensors
    where the config qualifies, else ``ops.fusion_pool``'s own gate (the
    torch path on the CPU, as the JAX builder takes XLA off the TPU).
    On CPU tensors the kernel paths run their plain versions.

    The step sets every leaf's ``.grad`` from the path's gradients and
    calls ``optimizer.step()``.  ``accum_steps`` microbatches the batch.

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


def _axis(mesh, axis_name):
    """The data axis of ``mesh`` (None without a mesh)."""
    if mesh is None:
        return None
    from ..parallel.data_parallel import _data_axis

    return _data_axis(mesh, axis_name)


def _make_step(local_step, accum_steps, axis=None):
    """``(state, kv, labels, generator) -> (state, loss, info)``: one
    update (microbatched when ``accum_steps > 1``; over a mesh axis, the
    shard's seed words, the scaled loss and the flat all-reduce)."""
    scale = 1.0 if axis is None else 1.0 / axis.size

    def step(state: TrainState, kv, labels, generator):
        if axis is not None:
            generator = axis.fold(generator)
        if accum_steps == 1:
            loss, info, grads = local_step(
                state.params, kv, labels, generator, scale
            )
        else:
            loss, info, grads = _accumulate(
                local_step, state.params, kv, labels, generator, scale,
                accum_steps,
            )
        if axis is not None:
            loss, info, grads = axis.reduce(loss, info, grads)
        _set_grads(param_leaves(state.params), grads)
        state.optimizer.step()
        state.step += 1
        return state, loss, info

    return step


def _set_grads(leaves: List[torch.Tensor], grads) -> None:
    for p, g in zip(leaves, grads):
        p.grad = None if g is None else g.detach().to(p.dtype)


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

    Where the route is the one-pass step on CUDA tensors (``'fused-step'``,
    or ``'auto'`` at H == 1, E <= 1024) and ``accum_steps == 1``, the K
    steps run as ONE CUDA graph: static buffers for the staged kv and
    labels, step ``i`` reading its rows at ``row_offset = i·B``; a
    ``(K, 2)`` seed-word buffer that the host refills through
    pinned memory before each replay, read by the kernel; the optimizer's
    update inside the graph.  The graph is captured at the first call for
    a shape (after one warm-up step on a side stream, whose effect on the
    parameters and optimizer state is undone) and replayed after that; a
    final partial chunk captures its own, as a partial JAX chunk compiles a
    second program.  A call with other parameter or optimizer-state
    tensors than the captured ones captures anew, and so does a call after
    any param group's hyperparameters changed (an ``LRScheduler`` step, a
    ``param_groups`` edit): the optimizer passes them to its kernels as
    Python numbers, which the capture bakes in.  The graph needs an
    optimizer that can update inside it: ``torch.optim.Adam`` / ``AdamW``
    built with ``capturable=True``, or ``torch.optim.SGD``; any other
    raises a ``ValueError``.  Each
    replay adds to ``train_step.launches`` what the capture counted: K
    chains, or the capture raises.

    Every other route — two-pass kernels, the torch path, H == 2, the
    streamed split, ``accum_steps > 1``, CPU tensors — runs its K steps
    eagerly in one call, as JAX's general per-step path does.

    ``mesh=`` makes each step data-parallel as in
    :func:`make_pool_train_step`: ``kv`` and ``labels`` hold this rank's
    rows ``(K, B_local, ...)``, and step ``i`` of shard ``s`` draws from
    ``fold_seed_words(fold_seed_words(rng, state.step + i), s)``.  On an
    NCCL group the graph captures each step's all-reduce with the rest
    (the warm-up step's eager all-reduce creates the communicator first)
    and the host writes the shards' seed words before each replay.  A
    gloo group cannot be captured: its chunk runs the K steps eagerly,
    whatever the route.
    """
    _validate(impl, accum_steps)
    local_step = _make_local_step(
        num_heads=num_heads, impl=impl, precision=precision,
        base_mask_prob=base_mask_prob, entropy_target=entropy_target,
        min_active=min_active, entropy_coeff=entropy_coeff,
        training=training,
    )
    axis = _axis(mesh, axis_name)
    single = _make_step(local_step, accum_steps, axis)
    graphs: Dict[tuple, _ChunkGraph] = {}

    def chunk(state: TrainState, kv, labels, rng):
        kv4 = _steps_view(kv, state.params["query"].shape[-1])
        K, B = kv4.shape[:2]
        if labels is not None and tuple(labels.shape[:2]) != (K, B):
            raise ValueError(
                f"labels must be (K={K}, B={B}, C), got {tuple(labels.shape)}"
            )
        use = _resolve_impl(impl, num_heads, state.params, kv4, precision)
        if (use == "fused-step" and accum_steps == 1 and kv4.is_cuda
                and (axis is None or axis.backend == "nccl")):
            key = (tuple(kv4.shape), kv4.dtype,
                   None if labels is None else labels.shape[-1])
            graph = graphs.get(key)
            if graph is None or graph.signature != _signature(state, kv4):
                graph = graphs[key] = _ChunkGraph(
                    local_step, state, kv4, labels, axis)
            return graph.run(state, kv4, labels, rng)
        losses, infos = [], {}
        for i in range(K):
            state, loss, info = single(
                state, kv4[i], None if labels is None else labels[i],
                fold_seed_words(rng, state.step),
            )
            losses.append(loss.detach().float())
            for k, v in info.items():
                infos.setdefault(k, []).append(v.detach().float().mean())
        return (state, torch.stack(losses),
                {k: torch.stack(v) for k, v in infos.items()})

    chunk._graphs = graphs  # the captured graphs, for the card's checks
    return chunk


def _steps_view(kv: torch.Tensor, E: int) -> torch.Tensor:
    """``(K, B, M, E)`` of a 4-D or packed ``(K, B, M·E)`` staging (a view
    where the layout allows)."""
    if kv.ndim == 3:
        if kv.shape[2] % E:
            raise ValueError(
                f"packed kv columns {kv.shape[2]} not a multiple of embed "
                f"dim {E}"
            )
        return kv.reshape(kv.shape[0], kv.shape[1], kv.shape[2] // E, E)
    if kv.ndim != 4 or kv.shape[3] != E:
        raise ValueError(
            f"chunk kv must be (K, B, M, {E}) or (K, B, M*{E}), got "
            f"{tuple(kv.shape)}"
        )
    return kv


def _opt_tensors(optimizer) -> List[torch.Tensor]:
    return [v for st in optimizer.state.values() for v in st.values()
            if torch.is_tensor(v)]


def _signature(state: TrainState,
               kv4: Optional[torch.Tensor] = None) -> tuple:
    """What a captured graph holds fixed: the tensors it reads and writes,
    by address, every param group's non-tensor hyperparameters (all keys
    but ``params``), by value, and — given the chunk's ``(K, B, M, E)``
    staging — the plan its step kernels resolve (:mod:`..kernels.tiles`:
    an env or table change recaptures)."""
    opt = state.optimizer
    plan = ()
    if kv4 is not None:
        head = state.params.get("head")
        _, B, M, E = kv4.shape
        plan = tuple((t.bn, t.splits) for t in step_plan(
            B, M, E, 0 if head is None else head["w"].shape[1], kv4.dtype,
            False, kv4.device, record=False))
    return (id(opt), plan,
            tuple(p.data_ptr() for p in param_leaves(state.params)),
            tuple(t.data_ptr() for t in _opt_tensors(opt)),
            tuple(tuple((k, v) for k, v in sorted(g.items())
                        if k != "params" and not torch.is_tensor(v))
                  for g in opt.param_groups))


def _check_graph_optimizer(optimizer) -> None:
    """The optimizers whose ``step()`` can run inside a CUDA graph."""
    if isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        if all(g.get("capturable") for g in optimizer.param_groups):
            return
    elif type(optimizer) is torch.optim.SGD:
        for g in optimizer.param_groups:
            fresh = any("momentum_buffer" not in optimizer.state.get(p, {})
                        for p in g["params"])
            if g["momentum"] and g["dampening"] and fresh:
                # torch's first momentum step copies the gradient; a graph
                # starts from a zero buffer, which equals it only without
                # dampening
                raise ValueError(
                    "the CUDA-graph chunk takes SGD with momentum and "
                    "dampening only once its momentum buffers exist"
                )
        return
    raise ValueError(
        "the CUDA-graph chunk runs optimizer.step() inside the graph: pass "
        "torch.optim.Adam or AdamW built with capturable=True, or "
        f"torch.optim.SGD (got {type(optimizer).__name__}"
        + (" without capturable=True" if isinstance(
            optimizer, (torch.optim.Adam, torch.optim.AdamW)) else "")
        + ")"
    )


class _ChunkGraph:
    """K one-pass steps captured as one CUDA graph, for one shape.

    ``step_info[i]`` is step ``i``'s info dict as the graph writes it: the
    per-step entries of the last replay, whose means the chunk returns
    (over a mesh ``axis``: the global means).  ``replays`` counts the
    graph's replays."""

    def __init__(self, local_step, state: TrainState, kv4: torch.Tensor,
                 labels: Optional[torch.Tensor], axis=None):
        dev = kv4.device
        K, B, M, E = kv4.shape
        self.local_step, self.K, self.B = local_step, K, B
        self.axis, self.replays = axis, 0
        self.kv = torch.empty((K * B, M * E), dtype=kv4.dtype, device=dev)
        self.labels = None if labels is None else torch.empty(
            (K * B, labels.shape[-1]), dtype=torch.float32, device=dev)
        self.seeds = torch.zeros((K, 2), dtype=torch.int32, device=dev)
        self.host_seeds = torch.zeros((K, 2), dtype=torch.int32).pin_memory()
        self.copied: Optional[torch.cuda.Event] = None
        self.losses = torch.empty((K,), dtype=torch.float32, device=dev)
        self.info: Dict[str, torch.Tensor] = {}
        self.step_info: List[Dict[str, torch.Tensor]] = []
        self.launched = (0, 0)
        self.graph = torch.cuda.CUDAGraph()
        self._capture(state, kv4, labels)
        self.signature = _signature(state, kv4)

    def _step(self, state: TrainState, i: int) -> Dict[str, torch.Tensor]:
        scale = 1.0 if self.axis is None else 1.0 / self.axis.size
        loss, info, grads = self.local_step(
            state.params, self.kv, self.labels, None, scale,
            seed_words=self.seeds[i], row_offset=i * self.B,
            batch_rows=self.B,
        )
        if self.axis is not None:
            loss, info, grads = self.axis.reduce(loss, info, grads)
        _set_grads(param_leaves(state.params), grads)
        state.optimizer.step()
        if self.info:
            self.losses[i].copy_(loss)
            for k, v in info.items():
                self.info[k][i].copy_(v.float().mean())
        return info

    def _capture(self, state: TrainState, kv4, labels) -> None:
        opt = state.optimizer
        leaves = param_leaves(state.params)
        _check_graph_optimizer(opt)
        self._stage(kv4, labels)
        dev = self.kv.device
        # One warm-up step on a side stream (lazy initialisation: the
        # optimizer's state, the libraries, the kernels' modules), then the
        # parameters and the optimizer's state are put back as they were:
        # the graph's first replay is the run's next step.  A state the
        # optimizer did not have yet goes back to zeros, the value torch
        # initialises it to (Adam's moments and step; SGD's buffer, see
        # _check_graph_optimizer).
        params0 = [p.detach().clone() for p in leaves]
        state0 = {p: {k: v.clone() for k, v in opt.state[p].items()
                      if torch.is_tensor(v)} for p in leaves if p in opt.state}
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            info = self._step(state, 0)
        current.wait_stream(side)
        with torch.no_grad():
            for p, p0 in zip(leaves, params0):
                p.copy_(p0)
                for k, v in opt.state.get(p, {}).items():
                    if torch.is_tensor(v):
                        saved = state0.get(p, {}).get(k)
                        v.copy_(saved) if saved is not None else v.zero_()
        self.info = {
            k: torch.empty((self.K,), dtype=torch.float32, device=dev)
            for k in info
        }
        # Capturing launches nothing: what the wrapper counted meanwhile is
        # what each replay launches, and it must be K step chains.
        counts = (_step_kernel.launches, _step_kernel.launches_q8)
        with torch.cuda.graph(self.graph):
            self.step_info = [self._step(state, i) for i in range(self.K)]
        self.launched = (_step_kernel.launches - counts[0],
                         _step_kernel.launches_q8 - counts[1])
        _step_kernel.launches, _step_kernel.launches_q8 = counts
        if sum(self.launched) != self.K:
            raise RuntimeError(
                f"the chunk's capture counted {self.launched} train_step "
                f"chains (f32/bf16, int8), not one a step of {self.K}"
            )

    def _stage(self, kv4, labels) -> None:
        src = kv4.reshape(self.kv.shape)
        if src.data_ptr() != self.kv.data_ptr():
            self.kv.copy_(src, non_blocking=True)
        if labels is not None:
            self.labels.copy_(labels.reshape(self.labels.shape),
                              non_blocking=True)

    def run(self, state: TrainState, kv4, labels, rng):
        self._stage(kv4, labels)
        if self.copied is not None:
            self.copied.synchronize()  # the last replay's words are read
        words = [fold_seed_words(rng, state.step + i) for i in range(self.K)]
        if self.axis is not None:
            words = [self.axis.fold(w) for w in words]
        self.host_seeds.numpy()[:] = np.asarray(
            words, dtype=np.uint32).view(np.int32)
        self.seeds.copy_(self.host_seeds, non_blocking=True)
        self.copied = torch.cuda.Event()
        self.copied.record()
        self.graph.replay()
        self.replays += 1
        _step_kernel.launches += self.launched[0]
        _step_kernel.launches_q8 += self.launched[1]
        state.step += self.K
        return (state, self.losses.clone(),
                {k: v.clone() for k, v in self.info.items()})
