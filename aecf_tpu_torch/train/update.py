"""The update engine under every train-step factory: one update body, one
microbatch accumulator, one eager K-step loop and one CUDA-graph chunk.

A factory supplies its local step, ``local_step(params, *batch, rng,
loss_scale, **staged) -> (loss, info, grads)``: this rank's loss scaled by
``loss_scale`` (``1/axis_size`` over a mesh axis), its info and the
gradients in :func:`param_leaves` order; how ``rng`` becomes its draws is
its own.  The model families give a loss instead (:func:`_loss_step`),
whose draws are keyed by the step's seed words
(:class:`~aecf_tpu_torch.kernels.draws.Draws`).
The update body (:func:`_update`) folds the shard's axis index into the
seed words, takes the local step (over microbatches where asked), sums
loss, info means and gradients over the axis in one all-reduce, sets every
``.grad`` and steps the optimizer (:func:`_optimizer_step`: on the card an
``Adam``/``AdamW`` that :func:`~aecf_tpu_torch.kernels.adam.supports_adam`
takes runs the one-pass kernel on its own state, anything else
``optimizer.step()``; :data:`optimizer_routes` counts the updates by
route).  :func:`_eager_chunk` runs K
steps a call, step ``i`` fed ``fold_seed_words(rng, state.step)`` (JAX's
``fold_in``), so chunks chain and resume like single steps.

The graph route (:func:`_graph_chunk`): where the factory's route can be
captured, ``accum_steps == 1``, the tensors are on the card and any mesh
axis is an NCCL group, a chunk's K steps are ONE CUDA graph
(:class:`_ChunkGraph`) — the batch streams (features and the rows beside
them: labels, targets; the model families' images, texts and labels) in
static buffers, step ``i`` given its rows as views of them, the seed
words refilled through pinned memory
before each replay, and each step's draws, collectives and optimizer
update inside the graph.  It is
captured at the first call for a shape, after a warm-up step on a side
stream that is undone (over NCCL it creates the communicator), and
replayed after that; a final partial chunk captures its own.  Other
parameter or optimizer-state tensors, a changed param-group
hyperparameter (an ``LRScheduler`` step: the optimizer passes them to its
kernels as Python numbers) or a changed kernel plan, where the factory
names one, recapture.  The optimizer must update inside a graph:
``Adam``/``AdamW`` with ``capturable=True``, or ``SGD``; any other raises
a ``ValueError``.  Each replay adds to the factory's chains' launch
counters what the capture counted — K a chain, or the capture raises —
and to the draw kernels' (:data:`aecf_tpu_torch.kernels.draws.counted`),
the optimizer kernel's (``adam_step.launches``), the pool routes'
(:data:`aecf_tpu_torch.ops.routes`), the optimizer routes'
(:data:`optimizer_routes`) and, over a mesh,
each collective's counters
(:data:`aecf_tpu_torch.parallel.collectives.counted`).  Every other case
(a gloo group included) runs the K steps eagerly, under ``chunk.eager``.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..kernels import draws as _draws
from ..kernels.adam import adam_optimizer_step, adam_step, supports_adam
from ..kernels.draws import fold_seed_words, seed_words_of
from ..utils.profiling import ReplayCounts, span

RngLike = Union[int, Tuple[int, int], torch.Generator, None]

# optimizer updates by route: the one-pass kernel or ``optimizer.step()``
# (a CUDA graph's replay adds its capture's)
optimizer_routes = types.SimpleNamespace(kernel=0, torch=0)


def param_leaves(params: Any) -> List[torch.Tensor]:
    """The trainable tensors of ``params`` in a fixed order: a module's
    ``parameters()``, or for a ``{'pool', 'query'[, 'head']}`` dict the
    pool's parameters (``named_parameters`` order), the query, then the
    head's ``w`` and ``b``; a contrastive ``{'pool', 'query', 'proj',
    'target_proj'}`` dict ends with the two projections' parameters."""
    if isinstance(params, nn.Module):
        return list(params.parameters())
    leaves = list(params["pool"].parameters()) + [params["query"]]
    head = params.get("head")
    if head is not None:
        leaves += [head[k] for k in ("w", "b") if head.get(k) is not None]
    for name in ("proj", "target_proj"):
        if params.get(name) is not None:
            leaves += list(params[name].parameters())
    return leaves


@dataclasses.dataclass
class TrainState:
    """``params`` (see :func:`param_leaves`), ``optimizer`` over their
    leaves, e.g. ``torch.optim.AdamW(param_leaves(params), lr=1e-4,
    weight_decay=0.01)`` (pass the decay: torch's default is 1e-2,
    optax's 1e-4), and ``step``, the number of updates taken."""

    params: Any
    optimizer: torch.optim.Optimizer
    step: int = 0


def _flat_grads(grads: Dict[str, Any], params: Dict[str, Any]):
    """The fused step's gradient dict in :func:`param_leaves` order."""
    names = [n for n, _ in params["pool"].named_parameters()]
    flat = [grads["pool"][n] for n in names] + [grads["query"]]
    head = params.get("head")
    if head is not None:
        flat += [grads["head"][k] for k in ("w", "b") if head.get(k) is not None]
    return flat


def _set_grads(leaves: List[torch.Tensor], grads) -> None:
    for p, g in zip(leaves, grads):
        p.grad = None if g is None else g.detach().to(p.dtype)


def _seed_of(rng: RngLike) -> Tuple[int, int]:
    """Two seed words of ``rng`` (drawn from it when it is a generator)."""
    if isinstance(rng, torch.Generator):
        words = torch.randint(0, 2**32, (2,), generator=rng)
        return int(words[0]), int(words[1])
    return seed_words_of(0 if rng is None else rng)


def _fold_words(rng, i: int):
    """Microbatch ``i``'s rng on the kernels' routes: seed words folded
    with ``i`` (JAX's ``fold_in(rng, i)``); anything else as given, so a
    generator hands every microbatch its own next seed words."""
    return fold_seed_words(rng, i) if isinstance(rng, tuple) else rng


def _fold_fresh(rng: RngLike, i: int) -> Tuple[int, int]:
    """Microbatch ``i``'s seed words on the loss route: fresh seed words of
    ``rng`` (drawn anew from a generator) folded with ``i``."""
    return fold_seed_words(_seed_of(rng), i)


def _loss_step(loss_on: Callable) -> Callable:
    """The local step of a loss ``loss_on(params, *batch, generator) ->
    (loss, info)``, the model families' route: ``generator`` is the step's
    draw key as given — a CPU generator, the step's seed words, or in a
    graph (``seed_words=``) the ``(2,)`` int32 words on the card that the
    model's draws read (:meth:`~aecf_tpu_torch.kernels.draws.Draws.of`) —
    the loss is scaled and differentiated by autograd, and loss and info
    come back detached."""

    def local_step(params, *args, seed_words=None):
        *batch, rng, loss_scale = args
        loss, info = loss_on(params, *batch,
                             rng if seed_words is None else seed_words)
        if loss_scale != 1.0:
            loss = loss * loss_scale
        grads = torch.autograd.grad(loss, param_leaves(params),
                                    allow_unused=True)
        return loss.detach(), {k: v.detach() for k, v in info.items()}, grads

    return local_step


def _accumulate(local_step, params, microbatches: Sequence, rng, loss_scale,
                accum_steps: int, fold: Callable):
    """The local step over ``accum_steps`` microbatches (``microbatches``
    holds a sequence of slices a batch stream, or None), microbatch ``i``
    fed ``fold(rng, i)``: the mean loss and gradients (equal microbatches of
    a mean loss give the full batch's), and the info with per-row entries
    concatenated in microbatch order and per-microbatch scalars stacked."""
    gsum, losses, infos = None, [], []
    for i in range(accum_steps):
        micro = [None if s is None else s[i] for s in microbatches]
        loss, info, grads = local_step(params, *micro, fold(rng, i),
                                       loss_scale)
        gsum = list(grads) if gsum is None else [
            b if a is None else (a if b is None else a + b)
            for a, b in zip(gsum, grads)
        ]
        losses.append(loss)
        infos.append(info)
    grads = [None if g is None else g / accum_steps for g in gsum]
    info = {
        k: torch.cat([d[k] for d in infos]) if torch.as_tensor(
            infos[0][k]).ndim else torch.stack([torch.as_tensor(d[k])
                                                for d in infos])
        for k in infos[0]
    }
    return torch.stack(losses).mean(), info, grads


def _optimizer_step(optimizer: torch.optim.Optimizer) -> None:
    """One optimizer update from the leaves' ``.grad``: the one-pass kernel
    (:func:`~aecf_tpu_torch.kernels.adam.adam_optimizer_step`) where
    :func:`~aecf_tpu_torch.kernels.adam.supports_adam` takes the optimizer
    as it stands, else ``optimizer.step()``; counted in
    :data:`optimizer_routes`."""
    if supports_adam(optimizer):
        adam_optimizer_step(optimizer)
        optimizer_routes.kernel += 1
    else:
        optimizer.step()
        optimizer_routes.torch += 1


def _update(local_step, state: TrainState, batch: Sequence, rng, axis=None,
            accum_steps: int = 1, fold: Callable = _fold_words, **staged):
    """The update body: ``(loss, info, local info)``, loss and info over
    the axis, after the optimizer's update (:func:`_optimizer_step`;
    ``state.step`` is the caller's).  ``staged`` goes to the local step as
    it is (the graph's addressing)."""
    scale = 1.0
    if axis is not None:
        rng, scale = axis.fold(rng), 1.0 / axis.size
    if accum_steps == 1:
        loss, info, grads = local_step(state.params, *batch, rng, scale,
                                       **staged)
    else:
        rows = batch[0].shape[0]
        if rows % accum_steps:
            raise ValueError(
                f"batch size {rows} is not divisible by accum_steps="
                f"{accum_steps}"
            )
        loss, info, grads = _accumulate(
            local_step, state.params,
            [None if x is None else torch.chunk(x, accum_steps)
             for x in batch],
            rng, scale, accum_steps, fold)
    local = info
    if axis is not None:
        loss, info, grads = axis.reduce(loss, info, grads)
    _set_grads(param_leaves(state.params), grads)
    _optimizer_step(state.optimizer)
    return loss, info, local


def _make_step(local_step, accum_steps: int = 1, axis=None,
               fold: Callable = _fold_words) -> Callable:
    """``(state, *batch, rng) -> (state, loss, info)``: one update
    (microbatched when ``accum_steps > 1``, microbatch ``i`` fed ``fold(rng,
    i)``; over a mesh ``axis``, the shard's seed words, the scaled loss and
    the flat all-reduce)."""

    def step(state: TrainState, *args):
        *batch, rng = args
        loss, info, _ = _update(local_step, state, batch, rng, axis,
                                accum_steps, fold)
        state.step += 1
        return state, loss, info

    return step


def _eager_chunk(single, state: TrainState, *args):
    """K calls of the single step ``single(state, *batch, seed words)``:
    ``args`` are the batch streams, each with a leading K axis (None stays
    None), then ``rng``; step ``i`` gets every stream's ``[i]`` and
    ``fold_seed_words(rng, state.step)``.  Returns ``(state, losses (K,),
    infos)`` with each info entry's per-step means."""
    *streams, rng = args
    with span("chunk.eager"):
        losses, infos = [], {}
        for i in range(streams[0].shape[0]):
            state, loss, info = single(
                state, *(None if s is None else s[i] for s in streams),
                fold_seed_words(_seed_of(rng), state.step),
            )
            losses.append(loss.detach().float())
            for k, v in info.items():
                infos.setdefault(k, []).append(v.detach().float().mean())
        return (state, torch.stack(losses),
                {k: torch.stack(v) for k, v in infos.items()})


def _data_axis(mesh, axis_name: str):
    """The mesh axis ``axis_name`` (a ``MeshAxis``), which ``mesh`` must
    have."""
    from ..parallel.collectives import MeshAxis

    axis = MeshAxis(mesh, axis_name)
    if axis.group is None:
        raise ValueError(
            f"mesh axes {getattr(mesh, 'mesh_dim_names', None)} have no "
            f"{axis_name!r} axis"
        )
    return axis


def _axis(mesh, axis_name: str):
    """The data axis of ``mesh`` (None without a mesh)."""
    return None if mesh is None else _data_axis(mesh, axis_name)


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


def _pool_streams(rows: Tuple[str, str]) -> Callable:
    """The pool builders' streams: ``kv`` ``(K, B, M, E)`` or packed ``(K,
    B, M·E)`` as ``(K, B, M, E)``, and the rows beside it ``(K, B,
    width)`` or None; ``rows`` names the rows and their width for the shape
    error."""

    def streams(state: TrainState, kv, staged):
        kv4 = _steps_view(kv, state.params["query"].shape[-1])
        K, B = kv4.shape[:2]
        if staged is not None and (tuple(staged.shape[:2]) != (K, B)
                                   or staged.ndim != 3):
            raise ValueError(
                f"{rows[0]} must be (K={K}, B={B}, {rows[1]}), got "
                f"{tuple(staged.shape)}"
            )
        return kv4, staged

    return streams


def _graph_chunk(local_step, axis=None, *, accum_steps: int = 1,
                 capturable: Optional[Callable] = None,
                 chains: Union[tuple, Callable] = (),
                 tallied: tuple = (), plan_key: Optional[Callable] = None,
                 capture_span: str, streams: Optional[Callable] = None,
                 fold: Callable = _fold_words) -> Callable:
    """The K-step chunk ``(state, *streams, rng) -> (state, losses (K,),
    infos)`` of ``local_step``: every batch stream ``(K, B, ...)`` (or
    None), ``infos`` each info entry's per-step (global) means.
    ``streams(state, *streams)``, if given, checks and reshapes the call's
    streams (the pool builders': :func:`_pool_streams`).  One
    :class:`_ChunkGraph` a shape where the call can be captured
    (``capturable(state, first stream)``, if given, holds too), recaptured
    under the span ``capture_span`` when its :func:`_signature` changed;
    else :func:`_eager_chunk` over :func:`_make_step` (microbatch ``i`` fed
    ``fold(rng, i)``).  ``chains`` — a tuple, or ``chains(state, first
    stream)`` giving the captured route's — must count K launches a
    capture, ``tallied`` wrappers' launches are added each replay as
    counted.  The returned chunk keeps its graphs by shape in
    ``chunk._graphs``."""
    single = _make_step(local_step, accum_steps, axis, fold)
    graphs: Dict[tuple, _ChunkGraph] = {}

    def chunk(state: TrainState, *args):
        *batch, rng = args
        if streams is not None:
            batch = streams(state, *batch)
        first = batch[0]
        if (accum_steps == 1 and first.is_cuda
                and (axis is None or axis.backend == "nccl")
                and (capturable is None or capturable(state, first))):
            key = tuple(None if x is None else (tuple(x.shape), x.dtype)
                        for x in batch)
            graph = graphs.get(key)
            if graph is None or graph.signature != _signature(
                    state, first, plan_key):
                with span(capture_span):
                    graph = graphs[key] = _ChunkGraph(
                        local_step, state, batch, axis,
                        chains(state, first) if callable(chains) else chains,
                        plan_key, tallied=tallied)
            return graph.run(state, batch, rng)
        return _eager_chunk(single, state, *batch, rng)

    chunk._graphs = graphs  # the captured graphs, for the card's checks
    return chunk


def _opt_tensors(optimizer) -> List[torch.Tensor]:
    return [v for st in optimizer.state.values() for v in st.values()
            if torch.is_tensor(v)]


def _signature(state: TrainState, kv4: Optional[torch.Tensor] = None,
               plan_key: Optional[Callable] = None) -> tuple:
    """What a captured graph holds fixed: the tensors it reads and writes,
    by address, every param group's non-tensor hyperparameters (all keys
    but ``params``), by value, and — given the chunk's ``(K, B, M, E)``
    staging and a ``plan_key`` — the plan its kernels resolve
    (``plan_key(state, kv4)``: an env or table change recaptures)."""
    opt = state.optimizer
    plan = () if kv4 is None or plan_key is None else plan_key(state, kv4)
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
        "the CUDA-graph chunk runs the optimizer's update inside the graph: "
        "pass torch.optim.Adam or AdamW built with capturable=True, or "
        f"torch.optim.SGD (got {type(optimizer).__name__}"
        + (" without capturable=True" if isinstance(
            optimizer, (torch.optim.Adam, torch.optim.AdamW)) else "")
        + ")"
    )


class _ChunkGraph:
    """K steps of ``local_step`` captured as one CUDA graph, for one shape.

    The call's batch streams ``(K, B, ...)`` are staged in static buffers
    of their shape, the first keeping its dtype (f32, bf16 or int8
    features), a floating stream its own, any other as f32.  Step ``i``
    runs ``local_step(params, *rows, None, loss_scale, seed_words=) ->
    (loss, info, grads)`` on its rows, the buffers' ``[i]`` views, and its
    two seed words, a row of a device buffer.  Each wrapper in ``chains`` must
    count one launch a step at capture (``launches`` + ``launches_q8``
    where it has both: the one-pass step's chain, the streamed forward and
    backward, or the two-pass forward and backward and InfoNCE's kernel);
    ``plan_key`` (or None) names the kernels' plan in the graph's
    signature.

    ``step_info[i]`` is step ``i``'s info dict as the graph writes it: the
    per-step entries of the last replay, this rank's rows; the chunk
    returns their means (over a mesh ``axis``: the global means).
    ``replays`` counts the graph's replays; each adds to the counters what
    the capture counted: the launches of ``chains`` and ``tallied``, the
    draw kernels' launches and bytes
    (:data:`aecf_tpu_torch.kernels.draws.counted`), the pool's calls by
    route (:data:`aecf_tpu_torch.ops.routes`), the optimizer kernel's
    launches (``adam_step.launches``) and its updates by route
    (:data:`optimizer_routes`: K kernel-route updates a replay where the
    optimizer qualifies) and the collectives'
    (:data:`aecf_tpu_torch.parallel.collectives.counted`).  A replay's
    spans (:mod:`aecf_tpu_torch.utils.profiling`): ``chunk.stage``,
    ``chunk.wait``, ``chunk.words`` and ``chunk.launch``."""

    def __init__(self, local_step, state: TrainState, streams: Sequence,
                 axis, chains: tuple, plan_key: Optional[Callable], *,
                 tallied: tuple = ()):
        from ..ops import routes
        from ..parallel.collectives import counted

        first = streams[0]
        dev = first.device
        K = first.shape[0]
        self.local_step, self.K = local_step, K
        self.axis, self.replays = axis, 0
        # the chains' launches, the optimizer kernel's, the draws', the
        # pool's and the optimizer's routes and every collective's count
        # and bytes
        self.chains, self.counts = chains, ReplayCounts(
            chains + tallied + (adam_step,),
            [(_draws.counted, k) for k in vars(_draws.counted)]
            + [(routes, k) for k in vars(routes)]
            + [(optimizer_routes, k) for k in vars(optimizer_routes)]
            + [(counted, k) for k in vars(counted)])
        self.views = [None if x is None else torch.empty(
            tuple(x.shape), dtype=(x.dtype if j == 0
                                   or x.dtype.is_floating_point
                                   else torch.float32), device=dev)
            for j, x in enumerate(streams)]
        self.seeds = torch.zeros((K, 2), dtype=torch.int32, device=dev)
        self.host_seeds = torch.zeros((K, 2), dtype=torch.int32).pin_memory()
        self.copied: Optional[torch.cuda.Event] = None
        self.losses = torch.empty((K,), dtype=torch.float32, device=dev)
        self.info: Dict[str, torch.Tensor] = {}
        self.step_info: List[Dict[str, torch.Tensor]] = []
        # the chains' part of what a replay adds to the counters: each
        # chain's launches, then its launches_q8 where it has one
        self.launched: Tuple[int, ...] = ()
        self.graph = torch.cuda.CUDAGraph()
        self._capture(state, streams)
        self.signature = _signature(state, first, plan_key)

    def _step(self, state: TrainState, i: int) -> Dict[str, torch.Tensor]:
        batch = [None if v is None else v[i] for v in self.views]
        loss, info, local = _update(self.local_step, state, batch, None,
                                    self.axis, seed_words=self.seeds[i])
        if self.info:
            self.losses[i].copy_(loss)
            for k, v in info.items():
                self.info[k][i].copy_(v.float().mean())
        return local

    def _capture(self, state: TrainState, streams) -> None:
        opt = state.optimizer
        leaves = param_leaves(state.params)
        _check_graph_optimizer(opt)
        self._stage(streams)
        dev = self.seeds.device
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
        # What the counters counted during the capture is what each replay
        # launches, and each chain must count K.
        with self.counts.capturing(), torch.cuda.graph(self.graph):
            self.step_info = [self._step(state, i) for i in range(self.K)]
        cells = list(zip(self.counts.cells, self.counts.added))
        self.launched = tuple(n for (o, _), n in cells if o in self.chains)
        for chain in self.chains:
            got = tuple(n for (o, _), n in cells if o is chain)
            if sum(got) != self.K:
                raise RuntimeError(
                    f"the chunk's capture counted {got} {chain.__name__} "
                    f"launches (launches, launches_q8), not one a step of "
                    f"{self.K}"
                )

    def _stage(self, streams) -> int:
        """Copies the call's batches into the graph's buffers; the bytes
        copied."""
        copied = 0
        for view, x in zip(self.views, streams):
            if view is None:
                continue
            if x.data_ptr() != view.data_ptr() or not x.is_contiguous():
                view.copy_(x, non_blocking=True)
                copied += view.nbytes
        return copied

    def run(self, state: TrainState, streams, rng):
        with span("chunk.stage") as s:
            s.add(bytes=self._stage(streams))
        if self.copied is not None:
            with span("chunk.wait"):
                self.copied.synchronize()  # the last replay's words are read
        with span("chunk.words"):
            words = [fold_seed_words(rng, state.step + i)
                     for i in range(self.K)]
            if self.axis is not None:
                words = [self.axis.fold(w) for w in words]
            self.host_seeds.numpy()[:] = np.asarray(
                words, dtype=np.uint32).view(np.int32)
            self.seeds.copy_(self.host_seeds, non_blocking=True)
            self.copied = torch.cuda.Event()
            self.copied.record()
        with span("chunk.launch"):
            self.graph.replay()
        self.replays += 1
        self.counts.replayed()
        state.step += self.K
        return (state, self.losses.clone(),
                {k: v.clone() for k, v in self.info.items()})
