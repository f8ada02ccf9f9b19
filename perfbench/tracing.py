"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a short
steady stretch of the window, reduced to what the per-layer readers and
the result line take — the device's busy time, its operations by name and
interval, the idle gaps and what the host was doing in them — beside the
program's counters and the benchmark's own spans over the same stretch.

The profiler starts and stops between two units of the driver's work, each
time after a synchronise, so the stretch holds exactly the work issued in
it.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.autograd import DeviceType

WINDOW_SPAN = "perfbench.traced"


def _ns(event, which: str) -> int:
    fn = getattr(event, f"{which}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(event, f"{which}_us")() * 1000)


def _annotation(event) -> bool:
    """A named range (``record_function``), which the profiler also marks
    on the device's timeline, where it occupies nothing."""
    fn = getattr(event, "is_user_annotation", None)
    return bool(fn()) if fn is not None else False


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


class Tracer:
    """Starts the profiler ``start_after`` seconds into the window and
    stops it ``seconds`` later, at the driver's calls of :meth:`tick`.
    ``counters()`` reads the program's counters and the driver's work
    counts; their increase over the stretch lands in ``counted``, and the
    host seconds from starting the profiler to having stopped it (its own
    set-up and tear-down included) in ``spent``."""

    def __init__(self, enabled: bool, start_after: float, seconds: float,
                 counters: Callable[[], Dict[str, float]]):
        self.start_after, self.seconds = start_after, seconds
        self.counters = counters
        self.state = "idle" if enabled else "off"
        self.prof = None
        self.span = None
        self.t0 = 0.0
        self.spent = 0.0  # host seconds from starting to having stopped
        self.before: Dict[str, float] = {}
        self.counted: Dict[str, float] = {}
        self.spans: Dict[str, List[float]] = collections.defaultdict(list)

    def tick(self, elapsed: float) -> None:
        """Between two units of work, ``elapsed`` seconds into the
        window."""
        if self.state == "idle" and elapsed >= self.start_after:
            self._start()
        elif self.state == "on" and time.perf_counter() - self.t0 >= self.seconds:
            self.stop()

    def record(self, name: str, seconds: float) -> None:
        """A span of the benchmark's own, kept while the profiler runs."""
        if self.state == "on":
            self.spans[name].append(seconds)

    def _start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        self.began = time.perf_counter()
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.span = record_function(WINDOW_SPAN)
        self.span.__enter__()
        self.before = self.counters()
        self.state = "on"
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        """Ends the stretch (a no-op unless it runs)."""
        if self.state != "on":
            return
        torch.cuda.synchronize()
        after = self.counters()
        self.counted = {k: after[k] - self.before.get(k, 0.0) for k in after}
        self.span.__exit__(None, None, None)
        self.prof.stop()
        self.state = "done"
        self.spent = time.perf_counter() - self.began

    def reduce(self) -> Optional["Trace"]:
        """The stretch's :class:`Trace`, or None if it never ran."""
        if self.state != "done":
            return None
        return Trace(self.prof, self.counted, dict(self.spans))


class Trace:
    """The reduced stretch.  Times in seconds.

    ``window_s``: from the first to the last moment of the span that
    bounds the stretch; ``ops``: ``(name, start_s, end_s)`` of every
    device operation inside it, kernels and copies; ``busy_s``: the union
    of their intervals; ``gaps``: the device's idle stretches."""

    def __init__(self, prof, counted: Dict[str, float],
                 spans: Dict[str, List[float]]):
        self.counted, self.spans = counted, spans
        events = prof.profiler.kineto_results.events()
        marks = [e for e in events if e.name() == WINDOW_SPAN]
        if not marks:
            raise RuntimeError("the traced stretch's span is not in the trace")
        w0 = _ns(marks[0], "start")
        w1 = w0 + _ns(marks[0], "duration")
        self.window_s = (w1 - w0) * 1e-9
        ops, host = [], []
        for e in events:
            s = _ns(e, "start")
            d = _ns(e, "duration")
            if e.name() == WINDOW_SPAN or _annotation(e):
                continue
            if e.device_type() == DeviceType.CUDA:  # kernels, copies, sets
                lo, hi = max(s, w0), min(s + d, w1)
                if hi > lo:
                    ops.append((e.name(), lo, hi))
            elif d > 0:
                host.append((s, s + d, e.name()))
        self.ops = [(n, (s - w0) * 1e-9, (e - w0) * 1e-9) for n, s, e in ops]
        busy = _union([(s, e) for _, s, e in ops])
        self.busy_s = sum(e - s for s, e in busy) * 1e-9
        self.host = host
        self.gaps = self._gaps(busy, w0, w1)

    @staticmethod
    def _gaps(busy, w0, w1) -> List[Tuple[int, int]]:
        """The device's idle stretches, ``(start, end)`` in ns."""
        edges = [w0] + [x for s, e in busy for x in (s, e)] + [w1]
        return [(lo, hi) for lo, hi in zip(edges[::2], edges[1::2]) if hi > lo]

    def _host_at(self, t: int) -> str:
        """The innermost host event (the shortest) running at ``t``."""
        best = None
        for s, e, name in self.host:
            if s <= t <= e and (best is None or e - s < best[0]):
                best = (e - s, name)
        return best[1] if best else "host idle"

    def device_s(self, match: Callable[[str], bool]) -> float:
        """Summed device time of the operations whose name ``match``es."""
        return sum(e - s for n, s, e in self.ops if match(n))

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by_op: Dict[str, float] = collections.defaultdict(float)
        for n, s, e in self.ops:
            by_op[n] += e - s
        ranked = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        longest = sorted(self.gaps, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, s] for n, s in ranked],
                "idle_gaps": [[self._host_at((lo + hi) // 2),
                               (hi - lo) * 1e-9] for lo, hi in longest]}
