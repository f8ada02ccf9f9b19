"""Profiling and tracing hooks on ``torch.profiler`` and the card's
synchronisation.

Port of :mod:`aecf_tpu.utils.profiling`.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ._tree import tree_leaves_with_path

__all__ = ["trace", "named_scope", "StepTimer"]


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Profile the block (``torch.profiler``: the CPU, and the card's
    kernels when CUDA is available) and write a Chrome trace,
    ``trace_<pid>_<ns>.json``, under ``log_dir`` (default:
    ``aecf_trace`` in the temporary directory), viewable in Perfetto or
    ``chrome://tracing``."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "aecf_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


named_scope = record_function  # a named region in the trace


class _StepHandle:
    """Set ``result`` inside ``StepTimer.step()`` so the timer can
    synchronize on the step's OUTPUT before stopping the clock."""

    __slots__ = ("result",)

    def __init__(self):
        self.result = None


class StepTimer:
    """Wall-clock step timing with warmup discard and device sync.

    Usage::

        timer = StepTimer()
        for _ in range(n):
            with timer.step() as s:
                s.result = train_step(...)

    Assigning ``s.result`` lets the timer synchronize on the body's
    output before the clock stops.  Without it only the host's enqueue is
    measured, which for the card's asynchronous launches is near zero.

    ``sync='fetch'`` (default) reads one element of the first non-empty
    tensor in the result (``.item()``, which waits for the work that
    makes it); ``sync='block'`` waits for the whole card
    (``torch.cuda.synchronize`` on that tensor's device; nothing for CPU
    tensors).  Per-step numbers include that wait — for throughput over
    long windows use :func:`aecf_tpu_torch.measure.ab_train_windows`.
    """

    def __init__(self, warmup: int = 3, *, sync: str = "fetch"):
        if sync not in ("fetch", "block"):
            raise ValueError(f"sync must be 'fetch' or 'block', got {sync!r}")
        self.warmup = warmup
        self.sync = sync
        self.times: list[float] = []
        self._seen = 0

    def _sync(self, result) -> None:
        for _, leaf in tree_leaves_with_path(result):
            if isinstance(leaf, torch.Tensor) and leaf.numel():
                if self.sync == "fetch":
                    leaf.reshape(-1)[0].item()
                elif leaf.is_cuda:
                    torch.cuda.synchronize(leaf.device)
                break

    @contextlib.contextmanager
    def step(self) -> Iterator[_StepHandle]:
        handle = _StepHandle()
        start = time.perf_counter()
        yield handle
        if handle.result is not None:
            self._sync(handle.result)
        elapsed = time.perf_counter() - start
        self._seen += 1
        if self._seen > self.warmup:
            self.times.append(elapsed)

    def record(self, fn, *args, **kwargs):
        with self.step() as s:
            out = fn(*args, **kwargs)
            s.result = out
        return out

    @property
    def mean_s(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")

    @property
    def p50_s(self) -> float:
        if not self.times:
            return float("nan")
        s = sorted(self.times)
        return s[len(s) // 2]
