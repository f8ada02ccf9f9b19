"""Prefetching batch loader over the native C++ pipeline.

Port of :mod:`aecf_tpu.data.loader`.  A C++ ring-buffer pipeline
(``aecf_tpu_torch/native/batcher.cc``, the port's own copy of the JAX
package's) gathers shuffled rows into contiguous batch buffers on a worker
thread while the card runs the previous step, exposed through ctypes with
zero-copy numpy views.  Batches are numpy tuples; the training loop moves
them to the card through :class:`aecf_tpu_torch.train.staging.Stager`.

Streams are generic (ABI v2): any number of named 2-D arrays of any dtype
share one shuffled row index — so an int8-quantized feature store (4× more
rows per host than f32, see :func:`quantize_rows`), its per-row scales, bf16
tables, and f32 labels all ride the same ring buffer.

Falls back to a pure-numpy implementation with identical semantics when the
native library can't be built (no compiler); the fallback is also the
correctness reference in tests.  The library is compiled by ``g++`` at its
first use into ``build/aecf_tpu_torch/<hash>/libaecf_batcher.so`` beside
the kernels (:mod:`aecf_tpu_torch.kernels._build`'s build root, keyed by a
hash of the source and the flags), never into the source tree.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from ..kernels import _build

__all__ = [
    "BatchLoader",
    "native_available",
    "build_native",
    "quantize_rows",
]

_SRC = Path(__file__).resolve().parents[1] / "native" / "batcher.cc"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib = None
_lib_failed = False
_lib_lock = threading.Lock()


def _lib_path() -> Path:
    """Where the batcher is built: ``<build root>/<hash>/``, the hash over
    the source and the flags, so an edited source rebuilds."""
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(" ".join(_FLAGS).encode())
    return _build._BUILD_ROOT / digest.hexdigest()[:16] / "libaecf_batcher.so"


def build_native(force: bool = False) -> Optional[str]:
    """Compile the native batcher (g++); returns the .so path or None."""
    lib = _lib_path()
    if lib.exists() and not force:
        return str(lib)
    # Link to a temp path and os.replace into place: an interrupted or
    # concurrent build must never leave a half-written .so at the library's
    # path (exists() would then return it forever and CDLL would fail).
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        lib.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, lib)
        return str(lib)
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if tmp.exists():
            try:
                tmp.unlink()
            except OSError:
                pass


def _dlopen(path: Optional[str]):
    if path is None:
        return None
    try:
        return ctypes.CDLL(path)
    except OSError:
        return None


def _abi_ok(lib) -> bool:
    try:
        lib.aecf_batcher_abi.restype = ctypes.c_int32
        return lib.aecf_batcher_abi() == 2
    except AttributeError:
        return False


def _load_lib():
    global _lib, _lib_failed
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _lib_failed:
            # remember failure: re-running the (up to 120s) g++ attempt on
            # every BatchLoader construction would stall each one
            return None
        path = _lib_path()
        existed = path.exists()
        lib = _dlopen(build_native())
        if (lib is None or not _abi_ok(lib)) and existed:
            # a PRE-EXISTING .so that fails to dlopen or speaks the wrong
            # ABI is presumed stale/corrupt: drop it and rebuild once.
            # When the library didn't exist, the failure was the fresh
            # build/dlopen itself — retrying would just double the
            # up-to-120s g++ stall (and deleting would be a no-op).
            try:
                path.unlink()
            except OSError:
                pass
            lib = _dlopen(build_native())
        if lib is None or not _abi_ok(lib):
            _lib_failed = True
            return None
        lib.aecf_batcher_create.restype = ctypes.c_void_p
        lib.aecf_batcher_create.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_uint64,
            ctypes.c_int32,
            ctypes.c_int32,
        ]
        lib.aecf_batcher_acquire.restype = ctypes.c_int64
        lib.aecf_batcher_acquire.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.aecf_batcher_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load_lib() is not None


def quantize_rows(table: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 quantization of a 2-D feature table.

    Returns ``(q (N, D) int8, scales (N, 1) f32)`` with
    ``q * scales ≈ table`` — the same symmetric-absmax scheme as
    :func:`aecf_tpu_torch.kernels.quantize_features` (which quantizes
    stacked ``(B, M, E)`` modalities per (row, modality); this is its 2-D
    feature-store form).  Both outputs are 2-D so they ride the loader as
    ordinary streams; ``scales`` stays f32 because the dequantization
    happens on the card, inside the kernels (``kv_scales=``).
    """
    table = np.ascontiguousarray(table, dtype=np.float32)
    if table.ndim != 2:
        raise ValueError(f"table must be 2-D (rows, dim), got {table.shape}")
    absmax = np.abs(table).max(axis=1)
    scales = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(
        np.round(table / scales[:, None]), -127, 127
    ).astype(np.int8)
    return q, scales[:, None]


def _prep_stream(name: str, x: np.ndarray) -> np.ndarray:
    x = np.asarray(x)
    if x.dtype == np.float64:
        # f64 is never what the card's pipeline wants; everything else (f32,
        # bf16, f16, int8, bool labels, ...) is carried at its own dtype.
        x = x.astype(np.float32)
    x = np.ascontiguousarray(x)
    if x.ndim != 2:
        raise ValueError(
            f"{name} must be 2-D (rows, features), got shape {x.shape}"
        )
    return x


class BatchLoader:
    """Iterate shuffled batches of named streams with prefetch.

    ``data`` maps stream names to 2-D ``(rows, dim)`` arrays sharing a row
    count; every batch gathers the SAME shuffled rows from each stream.
    Iteration yields tuples in the dict's insertion order (the canonical
    ``{image, text, label}`` key set always yields in that order, whatever
    the insertion order, for reference-protocol compatibility).  Arrays keep
    their dtype (float64 is downcast to float32), so quantized stores ride
    as-is::

        q, scales = quantize_rows(clip_features)   # int8 + (N, 1) f32
        loader = BatchLoader({"image": q, "image_scale": scales,
                              "label": labels}, batch_size=256)

    Args mirror the reference DataLoader usage: ``batch_size=64,
    shuffle=True`` (train_xrays_example.py:247-248), plus ``epochs`` (the
    pipeline pre-plans that many shuffled epochs) and ``drop_last`` (fixed
    batch shapes, which the card's staging buffers and CUDA graphs keep).

    ``backend='native'`` requires the C++ pipeline; ``'numpy'`` forces the
    fallback; ``'auto'`` prefers native.

    ``copy_out=False`` (native backend only) yields zero-copy views into the
    ring buffer instead of fresh arrays.  Expert mode: a view is only valid
    until the worker reuses its slot (``prefetch`` acquires later) and no
    later than the end of iteration (the generator's exit frees the ring
    buffer), and ``torch.from_numpy`` (like ``torch.as_tensor`` on the CPU)
    does NOT copy — the tensor ALIASES the view, so a retained or lazily
    consumed tensor can be silently overwritten by a later batch.  Only
    use it when every byte is consumed (copied, or staged to the card and
    the copy finished) before the next ``prefetch`` batches are drawn.
    """

    def __init__(
        self,
        data: Dict[str, np.ndarray],
        batch_size: int = 64,
        *,
        shuffle: bool = True,
        drop_last: bool = True,
        epochs: int = 1,
        seed: int = 0,
        prefetch: int = 3,
        backend: str = "auto",
        copy_out: bool = True,
    ):
        if not data:
            raise ValueError("data must contain at least one stream")
        names = list(data.keys())
        if set(names) == {"image", "text", "label"}:
            names = ["image", "text", "label"]
        self.stream_names = tuple(names)
        self.streams = {n: _prep_stream(n, data[n]) for n in names}
        first = self.stream_names[0]
        self.n = self.streams[first].shape[0]
        # Validate up front, identically for both backends: the C++
        # pipeline indexes rows 0..n-1 of EVERY array from the first
        # stream's row count — a shorter buffer would be read out of
        # bounds.
        for name in self.stream_names:
            arr = self.streams[name]
            if arr.shape[0] != self.n:
                raise ValueError(
                    f"row mismatch: {name} has {arr.shape[0]} rows, "
                    f"{first} has {self.n}"
                )
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epochs = epochs
        self.seed = seed
        self.prefetch = prefetch
        self.copy_out = copy_out

        if backend not in ("auto", "native", "numpy"):
            raise ValueError(
                f"backend must be 'auto', 'native' or 'numpy', got "
                f"{backend!r}"
            )
        if backend == "auto":
            # Prefetch overlap needs a spare core: on a single-CPU host the
            # worker thread just contends with the consumer (measured 7x
            # slower end-to-end on a 1-vCPU box).
            backend = (
                "native"
                if native_available() and (os.cpu_count() or 1) > 1
                else "numpy"
            )
        elif backend == "native" and not native_available():
            raise RuntimeError("native batcher unavailable (no g++?)")
        self.backend = backend

    def __len__(self) -> int:
        per_epoch = (
            self.n // self.batch_size
            if self.drop_last
            else -(-self.n // self.batch_size)
        )
        return per_epoch * self.epochs

    # -- iteration -------------------------------------------------------------
    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        if self.backend == "native":
            yield from self._iter_native()
        else:
            yield from self._iter_numpy()

    def _iter_native(self):
        lib = _load_lib()
        arrs = [self.streams[n] for n in self.stream_names]
        S = len(arrs)
        ptrs = (ctypes.c_void_p * S)(
            *[a.ctypes.data_as(ctypes.c_void_p) for a in arrs]
        )
        row_bytes = (ctypes.c_int64 * S)(
            *[a.shape[1] * a.itemsize for a in arrs]
        )
        handle = lib.aecf_batcher_create(
            ptrs,
            row_bytes,
            S,
            self.n,
            self.batch_size,
            self.epochs,
            self.prefetch,
            self.seed,
            1 if self.shuffle else 0,
            1 if self.drop_last else 0,
        )
        if not handle:
            raise RuntimeError("failed to create native batcher")
        try:
            out = (ctypes.c_void_p * S)()
            epoch = ctypes.c_int64()
            while True:
                rows = lib.aecf_batcher_acquire(
                    handle, out, ctypes.byref(epoch)
                )
                if rows == 0:
                    break
                # Views into the ring buffer — only valid until the worker
                # reuses the slot (`prefetch` acquires later).  Copied out
                # by default: handing a transient view to the caller is a
                # correctness trap, because torch.from_numpy ALIASES the
                # host buffer instead of copying (see the class docstring /
                # copy_out).
                batch = []
                for s, a in enumerate(arrs):
                    nbytes = rows * a.shape[1] * a.itemsize
                    buf = np.ctypeslib.as_array(
                        ctypes.cast(
                            out[s], ctypes.POINTER(ctypes.c_uint8)
                        ),
                        shape=(nbytes,),
                    )
                    view = buf.view(a.dtype).reshape(rows, a.shape[1])
                    batch.append(np.array(view) if self.copy_out else view)
                yield tuple(batch)
        finally:
            lib.aecf_batcher_destroy(handle)

    def _iter_numpy(self):
        arrs = [self.streams[n] for n in self.stream_names]
        for epoch in range(self.epochs):
            if self.shuffle:
                # Fisher-Yates with the same per-epoch seeding contract as
                # the native pipeline (values differ across backends; the
                # determinism contract per backend is what tests pin).
                rng = np.random.default_rng(self.seed + epoch)
                idx = rng.permutation(self.n)
            else:
                idx = np.arange(self.n)
            for start in range(0, self.n, self.batch_size):
                sel = idx[start : start + self.batch_size]
                if self.drop_last and len(sel) < self.batch_size:
                    break
                yield tuple(a[sel] for a in arrs)
