"""Batched inference serving for fusion models, in PyTorch.

Port of :mod:`aecf_tpu.serve` (``pad_to_bucket``, ``FusionPredictor``,
``MicroBatcher``) with the same validation, bucketing, zero-fill and
``calls`` contract.  Every device call runs at a padded bucket shape under
``torch.inference_mode()`` on an explicit ``device``; ``mesh=`` shards each
bucket's rows over a mesh's data axis.  The ``export_predictor`` family is
not ported yet (ROADMAP.md).

Usage::

    model = VisionLanguageModel(device="cuda").eval()
    predictor = FusionPredictor(
        lambda image, text: model(image, text),
        modality_names=("image", "text"), buckets=(32, 256), device="cuda",
    )
    probs = predictor(image=imgs, text=txts)           # any batch size
    probs = predictor(image=imgs)                      # text missing → zeros
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["FusionPredictor", "MicroBatcher", "pad_to_bucket"]


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
        self.calls = 0
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

        outs = []
        max_bucket = self.buckets[-1]
        start = 0
        while start < n:
            chunk_n = min(n - start, max_bucket)
            bucket = pad_to_bucket(chunk_n, self.buckets)
            mods = []
            for k in self.modality_names:
                x = np.zeros((bucket, provided[k].shape[1] if k in provided
                              else self._dims[k]), np.float32)
                if k in provided:
                    x[:chunk_n] = provided[k][start : start + chunk_n]
                mods.append(x)
            out = self._call_bucket(mods)
            # one per SUCCESSFUL bucket call: a chunked request counts once
            # per chunk, a request failing validation counts zero
            self.calls += 1
            outs.append(out[:chunk_n])
            start += chunk_n
        # Commit dims only after every device call succeeded, so one
        # bad-width first request cannot poison the zero-fill width.
        for k, v in provided.items():
            self._dims[k] = v.shape[1]
        return np.concatenate(outs)

    def _check_dims(self, provided: Dict[str, np.ndarray]) -> None:
        """Reject widths that contradict an already-committed dim."""
        for k, v in provided.items():
            prev = self._dims.get(k)
            if prev is not None and v.shape[1] != prev:
                raise ValueError(
                    f"modality {k!r} has feature dim {v.shape[1]}, but "
                    f"this predictor previously saw {prev}"
                )

    def _call_bucket(self, mods: List[np.ndarray]) -> np.ndarray:
        """One device call at a padded bucket shape (over a mesh: this
        rank's rows of it, then every rank's gathered)."""
        if self._axis is not None:
            mods = [self._axis.rows(x) for x in mods]
        with torch.inference_mode():
            xs = [torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
                  for x in mods]
            out = self.apply_fn(**dict(zip(self.modality_names, xs)))
            if self.apply_sigmoid:
                out = torch.sigmoid(out)
            if self._axis is not None:
                out = self._axis.gather(out)
            return out.float().cpu().numpy()


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
        self._queue: List[Tuple[Tuple, Dict[str, np.ndarray], Future]] = []
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
            self._queue.append((keyset, mods, fut))
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
                    sum(
                        next(iter(m.values())).shape[0]
                        for _, m, _ in self._queue
                    )
                    < self.max_batch
                    and not self._stopping
                ):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                batch, self._queue = self._queue, []

            groups: Dict[Tuple, List[Tuple[Dict, Future]]] = {}
            for keyset, mods, fut in batch:
                groups.setdefault(keyset, []).append((mods, fut))
            for keyset, items in groups.items():
                try:
                    stacked = {
                        k: np.concatenate([m[k] for m, _ in items])
                        for k, _dim in keyset
                    }
                    out = self.predictor(**stacked)
                    start = 0
                    for mods, fut in items:
                        n = next(iter(mods.values())).shape[0]
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
