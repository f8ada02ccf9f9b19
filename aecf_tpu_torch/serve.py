"""Batched inference serving for fusion models, in PyTorch.

Port of :mod:`aecf_tpu.serve` (``pad_to_bucket``, ``FusionPredictor``,
``MicroBatcher``) with the same validation, bucketing, zero-fill and
``calls`` contract.  Every device call runs at a padded bucket shape under
``torch.inference_mode()`` on an explicit ``device``; on the card the
buckets pass through reused pinned slots, one bucket ahead of the device,
and each bucket shape's forward replays one CUDA graph; ``mesh=`` shards
each bucket's rows over a mesh's data axis.
``export_predictor`` freezes a predictor into one ``.npz`` of
``torch.export`` programs, one a bucket, which ``load_exported_predictor``
serves with no model code.

Usage::

    model = VisionLanguageModel(device="cuda").eval()
    predictor = FusionPredictor(
        lambda image, text: model(image, text),
        modality_names=("image", "text"), buckets=(32, 256), device="cuda",
    )
    probs = predictor(image=imgs, text=txts)           # any batch size
    probs = predictor(image=imgs)                      # text missing → zeros
    export_predictor(predictor, "frozen.npz")
    frozen = load_exported_predictor("frozen.npz")     # no model code
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import os
import threading
import time
from concurrent.futures import Future
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from .utils.profiling import ReplayCounts, record, span, stamp

__all__ = [
    "ExportedFusionPredictor",
    "FusionPredictor",
    "MicroBatcher",
    "export_predictor",
    "load_exported_predictor",
    "pad_to_bucket",
]


def pad_to_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket ≥ n (last bucket used for chunking larger batches)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class FusionPredictor:
    """Bucketed batched predictor over a model call.

    Args:
      apply_fn: ``apply_fn(**modalities) -> logits`` on ``(bucket, dim)``
        float32 tensors (eval mode — e.g. a closure over a model after
        ``.eval()``).
      modality_names: keyword order for ``apply_fn``.
      buckets: padded batch sizes; requests larger than the biggest
        bucket are chunked.
      apply_sigmoid: return probabilities instead of logits.
      device: where the inputs are placed for ``apply_fn`` (the card
        unless the caller asks for another; with a mesh, this rank's card,
        :func:`aecf_tpu_torch.parallel.mesh.default_device`).
      mesh: optional ``DeviceMesh`` (:mod:`aecf_tpu_torch.parallel`) for
        data-parallel serving.  There is no single controller: every rank
        calls the predictor with the same request, runs ``apply_fn`` on its
        contiguous slice of each padded bucket, and gets the whole answer
        (the slices gathered with ``all_gather_into_tensor``).  Buckets
        must be divisible by the axis size.
      data_axis: the mesh axis carrying the batch dimension.

    ``calls`` counts the bucket calls whose answer arrived; ``staged`` those
    of them that took the card's pinned route (:meth:`_staged_call`: on
    CUDA without a mesh); ``graphed`` those of them answered by a CUDA
    graph's replay (``graphed / calls`` is the hit share); ``captures``
    the graphs captured.

    On the pinned route each bucket call's device work (``apply_fn``, the
    sigmoid, ``.float()``) is captured once a key — the bucket, the
    modalities provided and their widths — as a CUDA graph, at the key's
    second call (its first runs eagerly and initialises the libraries),
    and replayed after that.  A replay reads its inputs from the graph's
    static device buffers and the parameters and buffers of the
    ``nn.Module`` s that ``apply_fn`` reaches (``apply_fn`` itself, a bound
    method's ``__self__``, a Module in its closure cells) at the addresses
    they had at capture: in-place updates (``load_state_dict``, ``copy_``,
    an optimizer step) are seen by the next replay; a replaced parameter or
    buffer, a Module switched between ``train()`` and ``eval()``, another
    ``apply_fn`` or ``apply_sigmoid`` recaptures.  What else ``apply_fn``
    reads on the host (Python numbers, draws from a CPU generator) is
    frozen at capture.  An ``apply_fn`` that reaches no Module stays eager;
    so, for good, does a key whose capture fails (``apply_fn`` syncs the
    host, touches the CPU or changes shape with the data): that call is
    answered eagerly and nothing is raised.
    """

    def __init__(
        self,
        apply_fn: Callable[..., torch.Tensor],
        *,
        modality_names: Sequence[str],
        buckets: Sequence[int] = (32, 256, 1024),
        apply_sigmoid: bool = True,
        device: Optional[Union[str, torch.device]] = None,
        mesh: Optional[Any] = None,
        data_axis: str = "data",
    ):
        self.apply_fn = apply_fn
        self.modality_names = tuple(modality_names)
        self.buckets = tuple(sorted(buckets))
        self.apply_sigmoid = apply_sigmoid
        self._fresh()
        self._dims: Dict[str, int] = {}
        self._axis = None
        if mesh is not None:
            from .parallel.data_parallel import _data_axis
            from .parallel.mesh import default_device

            self._axis = _data_axis(mesh, data_axis)
            # a ragged last shard would change the padded call's shape
            bad = [b for b in self.buckets if b % self._axis.size]
            if bad:
                raise ValueError(
                    f"buckets {bad} not divisible by mesh axis "
                    f"{data_axis!r} (size {self._axis.size})"
                )
            if device is None:
                device = default_device()
        self.device = torch.device("cuda" if device is None else device)

    def _fresh(self) -> None:
        """The counters and the card's staging and graphs, empty."""
        self.calls = self.staged = self.graphed = self.captures = 0
        self._requests = itertools.count()  # span request ids
        self._staging = _Staging()
        self._graphs: Dict[tuple, _BucketGraph] = {}

    def __call__(self, **modalities: np.ndarray) -> np.ndarray:
        """Predict for any subset of modalities; absent ones are zeroed.

        All provided arrays must share a batch dimension; at least one
        modality is required.
        """
        provided = {
            k: np.asarray(v, dtype=np.float32)
            for k, v in modalities.items()
            if v is not None
        }
        if not provided:
            raise ValueError("At least one modality must be provided")
        unknown = set(provided) - set(self.modality_names)
        if unknown:
            raise ValueError(
                f"unknown modalities {sorted(unknown)}; expected "
                f"{self.modality_names}"
            )
        for k, v in provided.items():
            if v.ndim != 2:
                raise ValueError(
                    f"modality {k!r} must be (batch, features), got "
                    f"shape {v.shape}"
                )
        n = next(iter(provided.values())).shape[0]
        for k, v in provided.items():
            if v.shape[0] != n:
                raise ValueError(
                    f"batch mismatch: {k} has {v.shape[0]} rows, expected {n}"
                )
        if n == 0:
            raise ValueError("batch must have at least one row (got 0)")

        self._check_dims(provided)
        for k in self.modality_names:
            if k not in provided and k not in self._dims:
                raise ValueError(
                    f"cannot infer feature dim for absent modality {k!r}; "
                    "call once with it present, or pass an explicit zeros "
                    "array"
                )

        with span("predictor.request", next(self._requests), rows=n):
            # pinned memory and copies that do not block are CUDA's; a
            # mesh's ranks slice and gather every bucket
            if self._axis is None and self.device.type == "cuda":
                out = self._staged_call(provided, n)
            else:
                out = self._bucket_calls(provided, n)
            # Commit dims only after every device call succeeded, so one
            # bad-width first request cannot poison the zero-fill width.
            self._commit_dims(provided)
            return out

    def _chunks(self, n: int) -> Iterator[Tuple[int, int, int]]:
        """``(start, rows, bucket)`` of each device call of an n-row
        request: chunks of the largest bucket, each padded to the smallest
        bucket that holds it."""
        max_bucket = self.buckets[-1]
        for start in range(0, n, max_bucket):
            chunk_n = min(n - start, max_bucket)
            yield start, chunk_n, pad_to_bucket(chunk_n, self.buckets)

    def _width(self, k: str, provided: Dict[str, np.ndarray]) -> int:
        return provided[k].shape[1] if k in provided else self._dims[k]

    def _bucket_calls(self, provided: Dict[str, np.ndarray],
                      n: int) -> np.ndarray:
        """One blocking :meth:`_call_bucket` a bucket, on fresh zeroed
        numpy buckets (the CPU, and a mesh's ranks)."""
        outs = []
        for start, chunk_n, bucket in self._chunks(n):
            with span("predictor.pad", rows=chunk_n, padded=bucket):
                mods = []
                for k in self.modality_names:
                    x = np.zeros((bucket, self._width(k, provided)),
                                 np.float32)
                    if k in provided:
                        x[:chunk_n] = provided[k][start : start + chunk_n]
                    mods.append(x)
            out = self._call_bucket(bucket, mods)
            # one per SUCCESSFUL bucket call: a chunked request counts
            # once per chunk, a request failing validation counts zero
            self.calls += 1
            outs.append(out[:chunk_n])
        with span("predictor.concat"):
            return np.concatenate(outs)

    def _staged_call(self, provided: Dict[str, np.ndarray],
                     n: int) -> np.ndarray:
        """The card's route: each bucket staged in reused pinned slots and
        queued without blocking, one bucket ahead of the answers read.

        The host stages bucket i+1 while the device runs bucket i: bucket
        i is staged into slot ``i % 2`` of its shape (``predictor.pad``),
        copied over (``predictor.h2d``), run, and its answer queued into
        the slot's pinned answer buffer behind an event
        (``predictor.apply``); then bucket i-1's answer is awaited and its
        rows copied into the request's answer (``predictor.d2h``).  A
        missing modality is a zero bucket resident on the card.  Bucket
        for bucket the model sees what :meth:`_bucket_calls` gives it.

        Where the key's graph is captured (class docstring), ``predictor.h2d``
        copies the rows into the graph's static inputs and
        ``predictor.apply`` replays it, then queues the copy of its static
        answer; a capture (a warm-up on a side stream, then the capture)
        is the span ``predictor.capture`` between the two.  One static
        input and answer a graph is safe: a request's copies, replays and
        answer copies run in the order of one stream, so bucket i's answer
        copy is queued before bucket i+1's input copy and replay; the lock
        and each request's wait for its last answer keep requests apart.
        Each graph allocates from its own memory pool."""
        st = self._staging
        with st.lock, torch.inference_mode():
            answer: Optional[np.ndarray] = None
            issued: Optional[Tuple[_Slot, int, int, bool]] = None
            try:
                for i, (start, chunk_n, bucket) in enumerate(
                        self._chunks(n)):
                    slot = st.slot(bucket, i % 2)
                    with span("predictor.pad", rows=chunk_n, padded=bucket):
                        slot.wait()
                        hosts = [
                            slot.stage(j, provided[k], start, chunk_n)
                            if k in provided else None
                            for j, k in enumerate(self.modality_names)
                        ]
                    replayed = self._issue(slot, bucket, provided, hosts)
                    if answer is None:
                        answer = np.empty(
                            (n,) + tuple(slot.answer.shape[1:]), np.float32)
                    if issued is not None:
                        self._finish(issued, answer)
                    issued = slot, start, chunk_n, replayed
                self._finish(issued, answer)
            except BaseException:
                # Queued copies may still read or write pinned slots: let
                # them end before any slot is refilled.
                with contextlib.suppress(RuntimeError):
                    torch.cuda.current_stream(self.device).synchronize()
                raise
            return answer

    def _issue(self, slot: _Slot, bucket: int,
               provided: Dict[str, np.ndarray],
               hosts: List[Optional[torch.Tensor]]) -> bool:
        """Queue a staged bucket's copies to the card (``predictor.h2d``),
        its forward and its answer's copy into the slot
        (``predictor.apply``), capturing the key's graph first where it is
        due (``predictor.capture``).  True where a replay answers it."""
        st = self._staging
        zeros = [
            st.zeros(bucket, self._width(k, provided), self.device)
            if h is None else None
            for k, h in zip(self.modality_names, hosts)
        ]
        key = (bucket,) + tuple((k in provided, self._width(k, provided))
                                for k in self.modality_names)
        state = self._graph_state(bucket)
        graph = None if state is None else self._graphs.get(key)
        replay = graph is not None and not graph.failed
        with span("predictor.h2d", bytes=sum(
                h.nbytes for h in hosts if h is not None)):
            if replay:
                xs = graph.stage(hosts, zeros)
            else:
                xs = [z if h is None else h.to(self.device, non_blocking=True)
                      for h, z in zip(hosts, zeros)]
        if replay and graph.state != state:
            with span("predictor.capture"):
                replay = graph.capture(
                    lambda xs: self._apply(bucket, xs).float(), state)
            self.captures += replay
        with span("predictor.apply"):
            out = graph.replay() if replay else self._apply(bucket, xs).float()
            slot.queue_answer(out)
        if state is not None and key not in self._graphs:
            # the key's first call ran eagerly; its next captures
            self._graphs[key] = _BucketGraph(self.device)
        return replay

    def _finish(self, issued: Tuple[_Slot, int, int, bool],
                answer: np.ndarray) -> None:
        """Await an issued bucket's answer and copy its rows out."""
        slot, start, chunk_n, replayed = issued
        with span("predictor.d2h", bytes=slot.answer.nbytes):
            slot.wait()
            torch.from_numpy(answer[start : start + chunk_n]).copy_(
                slot.answer[:chunk_n])
        self.calls += 1
        self.staged += 1
        self.graphed += replayed

    def _reached(self, bucket: int) -> List[torch.nn.Module]:
        """The ``nn.Module`` s a bucket call's graph reads from."""
        return _modules_of(self.apply_fn)

    def _graph_state(self, bucket: int) -> Optional[tuple]:
        """What a bucket call's graph reads that the predictor can observe
        (class docstring): ``apply_fn`` and ``apply_sigmoid``, and the
        ``training`` flag of every Module it reaches and their submodules,
        and the address, shape and dtype of their parameters and buffers.
        None where the call stays eager: no Module is reached."""
        modules = self._reached(bucket)
        if not modules:
            return None
        state: List[Any] = [self.apply_fn, self.apply_sigmoid]
        for module in modules:
            for m in module.modules():
                state.append(m.training)
                for t in itertools.chain(m._parameters.values(),
                                         m._buffers.values()):
                    if t is not None:
                        state.append((t.data_ptr(), t.shape, t.dtype))
        return tuple(state)

    def _check_dims(self, provided: Dict[str, np.ndarray]) -> None:
        """Reject widths that contradict an already-committed dim
        (:class:`ExportedFusionPredictor` holds them to its artifact's)."""
        for k, v in provided.items():
            prev = self._dims.get(k)
            if prev is not None and v.shape[1] != prev:
                raise ValueError(
                    f"modality {k!r} has feature dim {v.shape[1]}, but "
                    f"this predictor previously saw {prev}"
                )

    def _commit_dims(self, provided: Dict[str, np.ndarray]) -> None:
        for k, v in provided.items():
            self._dims[k] = v.shape[1]

    def _apply(self, bucket: int, xs: List[torch.Tensor]) -> torch.Tensor:
        """The model on one padded bucket on the device: ``apply_fn``,
        then the sigmoid where ``apply_sigmoid`` is set."""
        out = self.apply_fn(**dict(zip(self.modality_names, xs)))
        return torch.sigmoid(out) if self.apply_sigmoid else out

    def _call_bucket(self, bucket: int, mods: List[np.ndarray]) -> np.ndarray:
        """One blocking device call at a padded bucket shape (over a mesh:
        this rank's rows of it, then every rank's gathered)."""
        if self._axis is not None:
            mods = [self._axis.rows(x) for x in mods]
        with torch.inference_mode():
            xs = _to_device(mods, self.device)
            with span("predictor.apply"):
                out = self._apply(bucket, xs)
                if self._axis is not None:
                    out = self._axis.gather(out)
            return _to_host(out)


def _to_device(mods: List[np.ndarray],
               device: torch.device) -> List[torch.Tensor]:
    """A bucket's host arrays on ``device`` (span ``predictor.h2d``)."""
    with span("predictor.h2d", bytes=sum(x.nbytes for x in mods)):
        return [torch.from_numpy(np.ascontiguousarray(x)).to(device)
                for x in mods]


def _to_host(out: torch.Tensor) -> np.ndarray:
    """A bucket's answer as f32 numpy (span ``predictor.d2h``, which holds
    the wait for the device's work)."""
    out = out.float()
    with span("predictor.d2h", bytes=out.numel() * out.element_size()):
        return out.cpu().numpy()


def _modules_of(fn: Any) -> List[torch.nn.Module]:
    """The ``nn.Module`` s a callable reaches: itself if it is one, a bound
    method's ``__self__``, and any Module in its closure cells."""
    if isinstance(fn, torch.nn.Module):
        return [fn]
    found = [getattr(fn, "__self__", None)]
    for cell in getattr(fn, "__closure__", None) or ():
        with contextlib.suppress(ValueError):  # a cell not yet filled
            found.append(cell.cell_contents)
    return [m for m in found if isinstance(m, torch.nn.Module)]


class _BucketGraph:
    """One key's bucket call on the card (:meth:`FusionPredictor.
    _staged_call`) as a CUDA graph: ``inputs`` its static device buckets
    (a missing modality's the staging's resident zeros, captured by
    address), ``out`` the answer its replays write, ``state`` what it read
    at capture (:meth:`FusionPredictor._graph_state`; None before the
    first), ``failed`` once a capture failed: the key stays eager."""

    def __init__(self, device: torch.device):
        self.device = device
        self.inputs: List[torch.Tensor] = []
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        self.state: Optional[tuple] = None
        self.failed = False
        self.counts = None

    def stage(self, hosts: List[Optional[torch.Tensor]],
              zeros: List[Optional[torch.Tensor]]) -> List[torch.Tensor]:
        """Queue the pinned buckets' copies into the static inputs (made at
        the first call)."""
        if not self.inputs:
            self.inputs = [
                z if h is None else torch.empty_like(h, device=self.device)
                for h, z in zip(hosts, zeros)]
        for x, h in zip(self.inputs, hosts):
            if h is not None:
                x.copy_(h, non_blocking=True)
        return self.inputs

    def capture(self, forward: Callable[[List[torch.Tensor]], torch.Tensor],
                state: tuple) -> bool:
        """Capture ``forward(inputs)`` after one warm-up run of it on a side
        stream (as the training chunk's graph does), to be read against
        ``state``; the kernel wrappers' counts of the capture become what
        each replay adds.  Both run under the route's
        ``torch.inference_mode()``, which capture works under.  A warm-up that raises raises, as an eager call
        would; a capture that raises leaves the key eager for good
        (``failed``) and returns False: the caller answers eagerly."""
        from .kernels import fused_pool_fwd, shared_query_fwd, stream_mix

        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            forward(self.inputs)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        counts = ReplayCounts((shared_query_fwd, stream_mix, fused_pool_fwd))
        self.graph = self.out = None
        try:
            with counts.capturing(), torch.cuda.graph(graph):
                out = forward(self.inputs)
        except RuntimeError:  # what torch and CUDA raise under capture
            torch.cuda.synchronize(self.device)
            self.failed = True
            return False
        self.graph, self.out, self.state, self.counts = (
            graph, out, state, counts)
        return True

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        self.counts.replayed()
        return self.out


class _Slot:
    """One staging slot of a bucket shape: a pinned host buffer a
    modality (made at its first use), a pinned answer buffer, and the
    event recorded after the answer's copy into it."""

    def __init__(self, bucket: int):
        self.bucket = bucket
        self.inputs: Dict[Tuple[int, int], torch.Tensor] = {}
        self.answer: Optional[torch.Tensor] = None
        self.done: Optional[torch.cuda.Event] = None

    def wait(self) -> None:
        """Until the device has finished with this slot's buffers."""
        if self.done is not None:
            self.done.synchronize()

    def stage(self, j: int, rows: np.ndarray, start: int,
              chunk_n: int) -> torch.Tensor:
        """Modality ``j``'s rows ``[start, start + chunk_n)`` in its pinned
        bucket, the tail zeroed (no stale row of an earlier request
        stays)."""
        key = (j, rows.shape[1])
        if key not in self.inputs:
            self.inputs[key] = torch.empty((self.bucket, rows.shape[1]),
                                           dtype=torch.float32,
                                           pin_memory=True)
        buf = self.inputs[key]
        src = rows[start : start + chunk_n]
        if src.flags.writeable and min(src.strides) >= 0:
            # torch's copy runs on ATen's threads: about 4x np.copyto on
            # an NVIDIA H100 host's 8 cores for a (1024, 2048) f32 bucket
            buf[:chunk_n].copy_(torch.from_numpy(src))
        else:  # what torch.from_numpy refuses or warns of
            np.copyto(buf.numpy()[:chunk_n], src)
        buf[chunk_n:].zero_()
        return buf

    def queue_answer(self, out: torch.Tensor) -> None:
        """Queue the device answer's copy into the pinned answer buffer,
        then the event the next :meth:`wait` waits on."""
        if self.answer is None or self.answer.shape != out.shape:
            self.answer = torch.empty(out.shape, dtype=torch.float32,
                                      pin_memory=True)
        self.answer.copy_(out, non_blocking=True)
        if self.done is None:
            self.done = torch.cuda.Event()
        self.done.record(torch.cuda.current_stream(out.device))


class _Staging:
    """A predictor's staging state on the card: two :class:`_Slot` s a
    bucket, taken in turn, the card's zero buckets for missing modalities,
    and the lock that keeps two callers out of the same slots."""

    def __init__(self):
        self.lock = threading.Lock()
        self.slots: Dict[Tuple[int, int], _Slot] = {}
        self._zeros: Dict[Tuple[int, int], torch.Tensor] = {}

    def slot(self, bucket: int, turn: int) -> _Slot:
        key = (bucket, turn)
        if key not in self.slots:
            self.slots[key] = _Slot(bucket)
        return self.slots[key]

    def zeros(self, bucket: int, width: int,
              device: torch.device) -> torch.Tensor:
        """A ``(bucket, width)`` zero bucket on ``device``, made once."""
        key = (bucket, width)
        if key not in self._zeros:
            self._zeros[key] = torch.zeros((bucket, width),
                                           dtype=torch.float32, device=device)
        return self._zeros[key]


class MicroBatcher:
    """Request coalescing: concurrent small requests ride one device call.

    Requests queue for up to ``max_wait_ms`` (or until ``max_batch`` rows
    accumulate), are grouped by modality key-set and widths, concatenated,
    run as ONE predictor call per group, and scattered back to their
    callers' futures.  Thread-safe; callers block in ``__call__``.

    Usage::

        batcher = MicroBatcher(predictor, max_batch=256, max_wait_ms=3.0)
        probs = batcher(image=img_row)        # from any number of threads
        batcher.stop()
    """

    def __init__(
        self,
        predictor: FusionPredictor,
        *,
        max_batch: int = 256,
        max_wait_ms: float = 3.0,
    ):
        self.predictor = predictor
        self.modality_names = predictor.modality_names
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # (keyset, modalities, future, request id, enqueue stamp) a request
        self._queue: List[Tuple[Tuple, Dict[str, np.ndarray], Future, int,
                                Optional[int]]] = []
        self._requests = itertools.count()  # span request ids
        self._stopping = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def __call__(self, **modalities: np.ndarray) -> np.ndarray:
        mods = {
            k: np.asarray(v, np.float32)
            for k, v in modalities.items()
            if v is not None
        }
        if not mods:
            raise ValueError("At least one modality must be provided")
        # Validate in the caller's thread: a malformed array reaching the
        # worker would fail its whole group.
        for k, v in mods.items():
            if v.ndim != 2:
                raise ValueError(
                    f"modality {k!r} must be (batch, features), got "
                    f"shape {v.shape}"
                )
        rows = {v.shape[0] for v in mods.values()}
        if len(rows) > 1:
            raise ValueError(
                "all modalities in one request must share a batch "
                f"dimension, got rows {sorted(rows)}"
            )
        if rows == {0}:
            raise ValueError("batch must have at least one row (got 0)")
        fut: Future = Future()
        # Group key includes per-modality widths: requests of different
        # widths must not share a concatenation.
        keyset = tuple(sorted((k, v.shape[1]) for k, v in mods.items()))
        with self._cv:
            if self._stopping:
                raise RuntimeError("MicroBatcher is stopped")
            self._queue.append((keyset, mods, fut, next(self._requests),
                                stamp()))
            self._cv.notify()
        return fut.result()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stopping:
                    self._cv.wait()
                if self._stopping and not self._queue:
                    return
                # batching window: wait for more arrivals (bounded)
                deadline = time.monotonic() + self.max_wait
                while (
                    sum(_rows(m) for _, m, *_ in self._queue) < self.max_batch
                    and not self._stopping
                ):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                batch, self._queue = self._queue, []
            for _, _, _, request, queued in batch:
                if queued is not None:
                    record("batcher.queued", queued, request)

            groups: Dict[Tuple, List[Tuple[Dict, Future]]] = {}
            for keyset, mods, fut, *_ in batch:
                groups.setdefault(keyset, []).append((mods, fut))
            for keyset, items in groups.items():
                try:
                    with span("batcher.form", requests=len(items),
                              rows=sum(_rows(m) for m, _ in items)):
                        stacked = {
                            k: np.concatenate([m[k] for m, _ in items])
                            for k, _dim in keyset
                        }
                    with span("batcher.call"):
                        out = self.predictor(**stacked)
                    with span("batcher.scatter"):
                        start = 0
                        for mods, fut in items:
                            n = _rows(mods)
                            fut.set_result(out[start : start + n])
                            start += n
                except Exception as e:  # noqa: BLE001 — serving boundary
                    for _, fut in items:
                        if not fut.done():
                            fut.set_exception(e)

    def stop(self) -> None:
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        self._worker.join(timeout=5)


def _rows(mods: Dict[str, np.ndarray]) -> int:
    return next(iter(mods.values())).shape[0]


# ---------------------------------------------------------------------------
# Frozen serving artifacts (torch.export)
# ---------------------------------------------------------------------------


class _Frozen(torch.nn.Module):
    """What one bucket call of a predictor computes, as a module for
    ``torch.export``: ``apply_fn`` on the modalities in order, then the
    sigmoid where ``apply_sigmoid`` is set."""

    def __init__(self, apply_fn, modality_names, apply_sigmoid):
        super().__init__()
        self.apply_fn = apply_fn
        self.modality_names = modality_names
        self.apply_sigmoid = apply_sigmoid

    def forward(self, *mods: torch.Tensor) -> torch.Tensor:
        out = self.apply_fn(**dict(zip(self.modality_names, mods)))
        return torch.sigmoid(out) if self.apply_sigmoid else out


def _npz_path(path: str) -> str:
    # np.savez appends '.npz' when it is missing but np.load does not:
    # normalise, so export and load take the same path string.
    return str(path) if str(path).endswith(".npz") else f"{path}.npz"


def export_predictor(
    predictor: FusionPredictor,
    path: str,
    *,
    feature_dims: Optional[Dict[str, int]] = None,
) -> None:
    """Freeze a predictor into a self-contained serving artifact.

    For every batch bucket, the eval forward (``apply_fn``, then the
    sigmoid where ``apply_sigmoid`` is set) is traced by
    ``torch.export.export(strict=False)`` under ``torch.no_grad()`` on
    ``(bucket, dim)`` f32 zeros on ``predictor.device``, with the
    parameters baked in as constants.  The artifact is one ``.npz``: each
    ``bucket_<b>`` the bytes of ``torch.export.save`` of that bucket's
    program, and ``config`` a JSON of the modality names, buckets,
    ``apply_sigmoid``, the feature dims and the device type traced for.
    A path without the ``.npz`` suffix gets it.

    Differences from the JAX package's ``export_predictor``, by design:
    there is no ``platforms=`` (``torch.export`` lowers for no other
    backend, so an artifact runs on the device type of the predictor it
    was traced from), and the programs call the kernels as the custom ops
    of :mod:`aecf_tpu_torch.kernels` — loading needs that package, which
    registers them (and builds a kernel at its first launch), but no model
    code.  A predictor with a ``mesh`` exports the single-device program
    of a whole bucket, with no collective.

    Args:
      feature_dims: ``{modality: feature_dim}``.  Taken from the
        predictor's call history when omitted (call it once with every
        modality present first).
    """
    if isinstance(predictor, ExportedFusionPredictor):
        # it has no apply_fn to trace: say so, not AttributeError mid-export
        raise TypeError(
            "cannot re-export a frozen ExportedFusionPredictor — export "
            "from the live FusionPredictor (the original artifact file is "
            "already the serialized form)"
        )
    dims = dict(feature_dims or predictor._dims)
    missing = [k for k in predictor.modality_names if k not in dims]
    if missing:
        raise ValueError(
            f"feature dims unknown for {missing}; pass feature_dims= or "
            "call the predictor once with every modality present"
        )
    frozen = _Frozen(predictor.apply_fn, predictor.modality_names,
                     predictor.apply_sigmoid)
    arrays: Dict[str, np.ndarray] = {}
    with torch.no_grad():
        for b in predictor.buckets:
            args = tuple(
                torch.zeros((b, dims[k]), dtype=torch.float32,
                            device=predictor.device)
                for k in predictor.modality_names
            )
            program = torch.export.export(frozen, args, strict=False)
            buf = io.BytesIO()
            torch.export.save(program, buf)
            arrays[f"bucket_{b}"] = np.frombuffer(buf.getvalue(), np.uint8)
    config = {
        "modality_names": list(predictor.modality_names),
        "buckets": list(predictor.buckets),
        "apply_sigmoid": bool(predictor.apply_sigmoid),
        "feature_dims": {k: int(dims[k]) for k in predictor.modality_names},
        "device": predictor.device.type,
    }
    arrays["config"] = np.frombuffer(json.dumps(config).encode(), np.uint8)
    np.savez(_npz_path(path), **arrays)


class ExportedFusionPredictor(FusionPredictor):
    """A :class:`FusionPredictor` backed by frozen ``torch.export``
    programs — the same padding, bucketing, chunking, missing-modality
    zero-fill and ``calls`` count, no Python model.  Its feature dims are
    the artifact's and never change; each bucket call runs that bucket's
    program under ``torch.inference_mode()`` on the device type it was
    traced for.  On the card a bucket's program is the Module its graphs
    read from (:class:`FusionPredictor`)."""

    def __init__(self, blobs: Dict[int, bytes], config: Dict[str, Any]):
        self.apply_fn = None
        self.modality_names = tuple(config["modality_names"])
        self.buckets = tuple(sorted(config["buckets"]))
        self.apply_sigmoid = bool(config["apply_sigmoid"])
        self._fresh()
        self._dims = {k: int(v) for k, v in config["feature_dims"].items()}
        self._axis = None  # frozen programs are single-device
        self.device = torch.device(config["device"])
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "this artifact was traced for CUDA and this host has no "
                "CUDA device; export from a CPU predictor to serve on the CPU"
            )
        missing = [b for b in self.buckets if b not in blobs]
        if missing:
            raise ValueError(
                f"artifact is missing programs for buckets {missing} "
                f"(config declares {list(self.buckets)}) — truncated or "
                "mismatched export"
            )
        self._programs = {
            b: torch.export.load(io.BytesIO(blobs[b])).module()
            for b in self.buckets
        }

    def _check_dims(self, provided: Dict[str, np.ndarray]) -> None:
        # The programs' input shapes are frozen: accepting another width
        # would also corrupt the zero-fill width of later requests.
        for k, v in provided.items():
            want = self._dims[k]
            if v.shape[1] != want:
                raise ValueError(
                    f"modality {k!r} has feature dim {v.shape[1]}, but the "
                    f"exported artifact expects {want}"
                )

    def _commit_dims(self, provided: Dict[str, np.ndarray]) -> None:
        pass  # the artifact's dims are authoritative and never updated

    def _reached(self, bucket: int) -> List[torch.nn.Module]:
        return [self._programs[bucket]]

    def _apply(self, bucket: int, xs: List[torch.Tensor]) -> torch.Tensor:
        return self._programs[bucket](*xs)


def load_exported_predictor(path: str) -> ExportedFusionPredictor:
    """Load an :func:`export_predictor` artifact.  It needs no model code.
    It imports :mod:`aecf_tpu_torch.kernels` first, which registers the
    custom ops the programs call: ``torch.export.load`` refuses a program
    whose op is not registered."""
    from . import kernels  # noqa: F401 — registers the aecf_tpu_torch ops

    if not str(path).endswith(".npz") and not os.path.exists(path):
        path = _npz_path(path)
    with np.load(path) as data:
        if "config" not in data.files:
            raise ValueError(
                f"{path} is not an export_predictor artifact "
                "(no 'config' entry)"
            )
        config = json.loads(bytes(data["config"]).decode())
        blobs = {
            int(name.split("_", 1)[1]): bytes(data[name])
            for name in data.files
            if name.startswith("bucket_")
        }
    return ExportedFusionPredictor(blobs, config)
