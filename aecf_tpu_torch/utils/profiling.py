"""Profiling and tracing hooks on ``torch.profiler`` and the card's
synchronisation.

Port of :mod:`aecf_tpu.utils.profiling`, plus the port's own span
recorder: :func:`span` marks a stretch of host work inside the program
(the serving and training paths name theirs ``predictor.pad``,
``chunk.launch``, ...), stamped on the profiler's host clock (unix-epoch
nanoseconds), so a span can be laid beside the device's timeline of the
same profile.  Spans record only while a ``torch.profiler`` session runs
in the process, or inside :func:`recording`; otherwise :func:`span` hands
back one shared object that does nothing.  Read them with :func:`spans`.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import tempfile
import threading
import time
from typing import (Any, Dict, Iterator, NamedTuple, Optional, Sequence,
                    Tuple)

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

from ._tree import tree_leaves_with_path

__all__ = ["trace", "named_scope", "StepTimer"]

SPAN_CAPACITY = 65536  # the newest spans kept; older ones are counted


class SpanRecord(NamedTuple):
    """One finished span.  Times are unix-epoch nanoseconds, the clock of
    ``torch.profiler``'s host events; ``parent`` is the ``id`` of the span
    open around it on the same thread (None at the top)."""

    id: int
    parent: Optional[int]
    name: str
    start_ns: int
    end_ns: int
    thread: int
    request: Optional[int]
    counts: Dict[str, int]


class SpanList(list):
    """The kept :class:`SpanRecord` s, oldest first, and ``dropped``: how
    many older ones the bound pushed out."""

    dropped = 0


class _Recorder:
    """The process's spans: a bounded store shared by every thread, each
    thread's stack of open spans, and the depth of :func:`recording`
    blocks."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self.records = collections.deque(maxlen=capacity)
        self.dropped = 0
        self.forced = 0  # open recording() blocks
        self.lock = threading.Lock()
        self.local = threading.local()
        self.ids = itertools.count(1)

    def stack(self) -> list:
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack

    def keep(self, record: SpanRecord) -> None:
        with self.lock:
            if len(self.records) == self.records.maxlen:
                self.dropped += 1
            self.records.append(record)


_RECORDER = _Recorder()


def _recording() -> bool:
    # The Python-side flag of torch.profiler is process-wide, where
    # torch.autograd._profiler_enabled() answers for the calling thread
    # only, and a worker thread started before the profile would never
    # record.
    return bool(_RECORDER.forced or _autograd_profiler._is_profiler_enabled)


class _NoSpan:
    """What :func:`span` returns while nothing records: one shared object
    whose entry and exit do nothing."""

    __slots__ = ()

    def add(self, **counts) -> None:
        pass


_NO_SPAN = _NoSpan()
# Entry and exit are C callables rather than Python methods: entry hands
# back the object itself, exit returns '' (false, so an exception
# propagates).  With Python methods a span that records nothing costs
# 0.34-0.57 us on a shared Intel Xeon host (CPython 3.12, a loop of 10^6),
# over the 0.5 us a span may cost while off; with these, 0.22-0.34 us there
# and 0.11 us (against 0.18-0.20) on the host of an NVIDIA H100 machine.
_NoSpan.__enter__ = itertools.repeat(_NO_SPAN).__next__
_NoSpan.__exit__ = "".format


class _Span:
    __slots__ = ("name", "request", "counts", "id", "parent", "start_ns",
                 "scope")

    def __init__(self, name: str, request: Optional[int],
                 counts: Dict[str, int]):
        self.name, self.request, self.counts = name, request, counts

    def add(self, **counts) -> None:
        """Counts known only inside the span (bytes copied, a flag)."""
        self.counts.update(counts)

    def __enter__(self):
        stack = _RECORDER.stack()
        self.parent = stack[-1].id if stack else None
        self.id = next(_RECORDER.ids)
        stack.append(self)
        self.scope = None
        if torch.autograd._profiler_enabled():  # this thread is profiled
            self.scope = record_function(self.name)
            self.scope.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.scope is not None:
            self.scope.__exit__(*exc)
        _RECORDER.stack().pop()
        _RECORDER.keep(SpanRecord(
            self.id, self.parent, self.name, self.start_ns, end,
            threading.get_ident(), self.request, self.counts))
        return False


def span(name: str, request: Optional[int] = None, **counts: int):
    """A context manager that records the block as a span ``name``, with
    an optional request id and integer ``counts`` (``bytes``, ``rows``;
    more through the entered object's ``add(**counts)``).  While a
    ``torch.profiler`` session profiles the calling thread, the block is
    also a ``record_function`` range of that name, so :func:`trace`'s
    Chrome trace shows it.  While nothing records it returns one shared
    no-op object and reads no clock."""
    # _recording(), written out: this test is all a span costs while off
    if not (_autograd_profiler._is_profiler_enabled or _RECORDER.forced):
        return _NO_SPAN
    return _Span(name, request, counts)


def stamp() -> Optional[int]:
    """The host clock for a span that ends on another thread
    (:func:`record`), or None while nothing records."""
    return time.time_ns() if _recording() else None


def record(name: str, start_ns: int, request: Optional[int] = None,
           **counts: int) -> None:
    """Keep a span from ``start_ns`` (a :func:`stamp`) to now, with no
    parent: a wait that began on one thread and ends on this one."""
    _RECORDER.keep(SpanRecord(
        next(_RECORDER.ids), None, name, start_ns, time.time_ns(),
        threading.get_ident(), request, counts))


def spans() -> SpanList:
    """The kept spans in the order they ended, and ``.dropped``."""
    with _RECORDER.lock:
        out = SpanList(_RECORDER.records)
        out.dropped = _RECORDER.dropped
    return out


def clear_spans() -> None:
    with _RECORDER.lock:
        _RECORDER.records.clear()
        _RECORDER.dropped = 0


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans inside the block without a profiler (every thread's)."""
    with _RECORDER.lock:
        _RECORDER.forced += 1
    try:
        yield
    finally:
        with _RECORDER.lock:
            _RECORDER.forced -= 1


class ReplayCounts:
    """What each replay of a CUDA graph adds to the counters it read while
    it was captured: the kernel wrappers' ``launches`` and ``launches_q8``
    (those of the two each has) and the ``(object, attribute)`` pairs
    ``cells``.  Capturing launches nothing, so :meth:`capturing` takes
    what the counters counted meanwhile as ``added`` and puts them back as
    they were, even where the capture raises; :meth:`replayed` adds
    ``added``."""

    def __init__(self, wrappers: Sequence[Any] = (),
                 cells: Sequence[Tuple[Any, str]] = ()):
        self.cells = [(w, a) for w in wrappers
                      for a in ("launches", "launches_q8") if hasattr(w, a)]
        self.cells += cells
        self.added = [0] * len(self.cells)

    @contextlib.contextmanager
    def capturing(self) -> Iterator[None]:
        before = [getattr(o, a) for o, a in self.cells]
        try:
            yield
        finally:
            self.added = [getattr(o, a) - n
                          for (o, a), n in zip(self.cells, before)]
            for (o, a), n in zip(self.cells, before):
                setattr(o, a, n)

    def replayed(self) -> None:
        for (o, a), n in zip(self.cells, self.added):
            if n:
                setattr(o, a, getattr(o, a) + n)


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
