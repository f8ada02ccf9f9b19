"""Batched inference serving for fusion models, in PyTorch.

Port of :mod:`aecf_tpu.serve` (``pad_to_bucket``, ``FusionPredictor``,
``MicroBatcher``) with the same validation, bucketing, zero-fill and
``calls`` contract.  Every device call runs at a padded bucket shape under
``torch.inference_mode()`` on an explicit ``device``; ``mesh=`` shards each
bucket's rows over a mesh's data axis.  ``export_predictor`` freezes a
predictor into one ``.npz`` of ``torch.export`` programs, one a bucket,
which ``load_exported_predictor`` serves with no model code.

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

import io
import json
import os
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

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
            out = self._call_bucket(bucket, mods)
            # one per SUCCESSFUL bucket call: a chunked request counts once
            # per chunk, a request failing validation counts zero
            self.calls += 1
            outs.append(out[:chunk_n])
            start += chunk_n
        # Commit dims only after every device call succeeded, so one
        # bad-width first request cannot poison the zero-fill width.
        self._commit_dims(provided)
        return np.concatenate(outs)

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

    def _call_bucket(self, bucket: int, mods: List[np.ndarray]) -> np.ndarray:
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
    traced for."""

    def __init__(self, blobs: Dict[int, bytes], config: Dict[str, Any]):
        self.apply_fn = None
        self.modality_names = tuple(config["modality_names"])
        self.buckets = tuple(sorted(config["buckets"]))
        self.apply_sigmoid = bool(config["apply_sigmoid"])
        self.calls = 0
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

    def _call_bucket(self, bucket: int, mods: List[np.ndarray]) -> np.ndarray:
        with torch.inference_mode():
            xs = [torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
                  for x in mods]
            return self._programs[bucket](*xs).float().cpu().numpy()


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
