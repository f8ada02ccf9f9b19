"""One run of one cell: set-up, the measured window (traced in part with
``--trace 1``), the modules check, the comparison with the plain reference,
and the result line.

:func:`run_cell` is the whole run; ``perfbench/run.py`` is its command
line.  A run on the CPU (``device='cpu'``, the tests' dry run of the
plumbing at small sizes) reports no metric: a number from the CPU is never
written under a device metric's name.
"""

from __future__ import annotations

import gc
import importlib
import json
import math
import sys
import time
import types
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from . import roofline, spec
from .tracing import Tracer

# top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "aecf_tpu")


class NoCard(RuntimeError):
    """The run found fewer cards than its cell asks for."""


class Forbidden(RuntimeError):
    """A module of JAX or of the JAX package was loaded."""


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (the port's own name begins with the JAX package's)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def cache_dir(root: Path) -> Path:
    """The run's build and kernel caches: a fixed directory inside the
    checkout, so only the first run of a checkout builds."""
    return root / "build" / "perfbench"


def evaluate(numbers: Dict[str, Optional[float]],
             limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict]]:
    """``(correct, checks)``: every number with a limit read, finite and
    no more than its limit."""
    checks, correct = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        ok = value is not None and math.isfinite(value) and value <= limit
        correct &= ok
        checks[name] = {"value": value, "limit": limit}
    return correct, checks


def _driver(cell: spec.Cell, seed: int, device):
    module = importlib.import_module(
        f"perfbench.drivers.{cell.traffic['driver']}")
    return module.Run(cell, seed, device)


def untraced(work: Dict, tracer: Tracer) -> Dict:
    """The window's work and seconds outside the traced stretch, where the
    profiler neither ran nor started."""
    out = {k: v - tracer.counted.get(k, 0) for k, v in work.items()}
    out["elapsed_s"] = work["elapsed_s"] - tracer.spent
    return out


def _per_layer(cell: spec.Cell, trace, work: Dict) -> Dict[str, Dict]:
    """Each per-layer metric's reader over the traced stretch (``trace``)
    and the window's untraced work (``work``)."""
    ctx = types.SimpleNamespace(trace=trace, work=work, config=cell.config,
                                traffic=cell.traffic, roofline=roofline)
    out = {}
    for m in cell.per_layer:
        value = spec.reader(cell.root, m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda") -> Dict:
    """The result line of one run (a dict in the line's key order)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < cell.chips):
        raise NoCard(
            f"cell {cell.name} asks for {cell.chips} card(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count()={torch.cuda.device_count()}")
    from aecf_tpu_torch.measure import enable_persistent_cache

    enable_persistent_cache(str(cache_dir(cell.root) / "kernels"))
    run = _driver(cell, seed, dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    run.setup()
    # what set-up made lives to the end: out of the collector's way, as a
    # Python server freezes its heap once loaded
    gc.collect()
    gc.freeze()
    setup_s = time.monotonic() - t_start
    tracer = Tracer(trace and cuda, cell.traffic["trace_start_s"],
                    cell.traffic["trace_s"], run.counters)
    res = run.window(seconds, tracer)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    traced = tracer.reduce()
    run.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    correct, checks = evaluate(run.check(), cell.limits)

    metrics: Dict[str, Dict] = {}
    if cuda and trace:
        metrics = _per_layer(cell, traced, untraced(res["work"], tracer))
    elif cuda:
        values = dict(res["metrics"], setup_s=setup_s)
        for m in cell.end_to_end:
            v = values.get(m["name"])
            if v is None or not math.isfinite(v):
                raise RuntimeError(f"end-to-end metric {m['name']} not read "
                                   f"({v!r})")
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(res["attempted"]),
              "failed": int(res["failed"]), "metrics": metrics,
              "device": device_info}
    if traced is not None:
        device_info["busy_s"] = traced.busy_s
        device_info["window_s"] = traced.window_s
        result["breakdown"] = traced.breakdown()
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        raise Forbidden(f"loaded once the window closed: {', '.join(found)}")
    return result


def report(result: Dict) -> None:
    """The result line on stdout, then each compared number beside its
    limit as the last lines on stderr."""
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    for name, c in result["checks"].items():
        ok = c["value"] is not None and c["value"] <= c["limit"]
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
