"""Serving independent users: an open loop of small requests through
``MicroBatcher`` → ``FusionPredictor``.

Requests are sent on a schedule, whatever the system does: each is handed
to a thread of its own at its due moment and timed from that moment until
its answer returns.  Every seed gets the same set of gaps, sizes and
modality subsets, in its own order: the gaps are the quantiles of the
exponential distribution at the mix's rate (Poisson arrivals), the sizes
and subsets are apportioned by the mix's weights.

Traffic keys: ``rate_per_s``, ``rows`` (size → weight), ``subsets``
(``both`` / ``image`` / ``text`` → weight), ``buckets``, ``max_batch``,
``max_wait_ms``, ``clients`` (threads that may wait at once),
``pool_rows`` (host rows requests are cut from), ``sample_requests``
(answers kept for the check, beside every request of the largest size),
``warm_s`` (open-loop warm-up), ``answer_wait_s``, ``trace_start_s``,
``trace_s``.
"""

from __future__ import annotations

import math
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np

from .. import models
from . import _serving


def apportion(weights: Dict[str, float], n: int) -> List[str]:
    """``n`` labels in the proportions of ``weights`` (largest
    remainders), in the order of the keys."""
    total = sum(weights.values())
    exact = {k: n * w / total for k, w in weights.items()}
    counts = {k: int(math.floor(v)) for k, v in exact.items()}
    rest = sorted(exact, key=lambda k: counts[k] - exact[k])
    for k in rest[:n - sum(counts.values())]:
        counts[k] += 1
    return [k for k in weights for _ in range(counts[k])]


def schedule(traffic: Dict, seconds: float, seed: int) -> Dict[str, np.ndarray]:
    """The requests of ``seconds`` of the mix: ``due`` (s from the start),
    ``rows``, ``subset`` and ``start`` (first host row) each."""
    rate = traffic["rate_per_s"]
    n = max(1, round(rate * seconds))
    rng = np.random.default_rng(seed)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    rows = np.array([int(r) for r in apportion(traffic["rows"], n)])
    subsets = np.array(apportion(traffic["subsets"], n))
    due = np.cumsum(rng.permutation(gaps))
    rows, subsets = rng.permutation(rows), rng.permutation(subsets)
    start = rng.integers(0, traffic["pool_rows"] - rows + 1)
    return {"due": due, "rows": rows, "subset": subsets, "start": start}


class Run:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.t = cell.traffic
        self.lock = threading.Lock()
        self.rows = 0

    def setup(self) -> None:
        from aecf_tpu_torch.serve import MicroBatcher

        self.served = _serving.Served(self.cell.config, self.t, self.seed,
                                      self.device, self.t["pool_rows"])
        self.served.warm()
        self.batcher = MicroBatcher(self.served.predictor,
                                    max_batch=self.t["max_batch"],
                                    max_wait_ms=self.t["max_wait_ms"])
        self.pool = ThreadPoolExecutor(max_workers=self.t["clients"])
        warm = schedule(self.t, self.t["warm_s"],
                        models.sub_seed(self.seed, "warm"))
        self._loop(warm, None, keep=set())

    def counters(self) -> Dict[str, float]:
        from aecf_tpu_torch.kernels import shared_query_fwd

        with self.lock:
            rows = self.rows
        return {"rows": rows, "predictor.calls": self.served.predictor.calls,
                "shared_query_fwd.launches": shared_query_fwd.launches}

    def _loop(self, sched, tracer, keep) -> Dict:
        """Send ``sched``; wait for every answer up to ``answer_wait_s``
        past the last due moment.  No request's future is kept: what the
        loop holds stays a few arrays, whatever the window's length."""
        n = len(sched["due"])
        latency = np.full(n, np.inf)
        late = np.zeros(n)
        answers: Dict[int, np.ndarray] = {}
        done = threading.Condition()
        count = {"left": n, "failed": 0}

        def send(i, due):
            try:
                out = self.batcher(**self.served.request(
                    int(sched["start"][i]), int(sched["rows"][i]),
                    str(sched["subset"][i])))
                latency[i] = time.perf_counter() - due
                with self.lock:
                    self.rows += len(out)
                if i in keep:
                    answers[i] = out
            except Exception as e:  # noqa: BLE001 — a failed request counts
                print(f"request {i} failed: {e!r}", file=sys.stderr)
                with done:
                    count["failed"] += 1
            with done:
                count["left"] -= 1
                if not count["left"]:
                    done.notify_all()

        t0 = time.perf_counter()
        for i in range(n):
            due = t0 + sched["due"][i]
            now = time.perf_counter()
            if tracer is not None:
                tracer.tick(now - t0)
            if due > now:
                time.sleep(due - now)
            late[i] = time.perf_counter() - due
            self.pool.submit(send, i, due)
        end = t0 + sched["due"][-1]
        with done:
            done.wait_for(lambda: not count["left"], timeout=max(
                1.0, end + self.t["answer_wait_s"] - time.perf_counter()))
            failed = count["failed"] + count["left"]
        if tracer is not None:
            tracer.stop()
        return {"latency": latency, "late": late, "answers": answers,
                "failed": failed, "seconds": end - t0}

    def window(self, seconds: float, tracer) -> Dict:
        self.sched = schedule(self.t, seconds, self.seed)
        rows = self.sched["rows"]
        rng = np.random.default_rng(models.sub_seed(self.seed, "sample"))
        n = len(rows)
        keep = set(rng.choice(n, min(n, self.t["sample_requests"]),
                              replace=False).tolist())
        keep |= set(np.flatnonzero(rows == rows.max()).tolist())
        res = self._loop(self.sched, tracer, keep)
        lat = np.sort(res["latency"])
        p95 = lat[max(0, math.ceil(0.95 * n) - 1)]
        late = res["late"]
        print(f"open loop: {n} requests due in {res['seconds']:.3f} s, "
              f"{int(rows.sum())} rows, failed {res['failed']}; sender late "
              f"p50 {np.median(late) * 1e3:.4f} ms, p99 "
              f"{np.quantile(late, 0.99) * 1e3:.4f} ms, max "
              f"{late.max() * 1e3:.4f} ms; latency p50 "
              f"{np.median(lat) * 1e3:.4f} ms", file=sys.stderr)
        self.answers = [(int(self.sched["start"][i]), int(rows[i]),
                         str(self.sched["subset"][i]), a)
                        for i, a in sorted(res["answers"].items())]
        self.missing = len(keep) - len(self.answers)
        return {
            "metrics": {"serve_p95_ms": float(p95) * 1e3},
            "attempted": n, "failed": res["failed"],
            "work": {"requests": n, "rows": int(rows.sum()),
                     "elapsed_s": res["seconds"]},
        }

    def release(self) -> None:
        self.batcher.stop()
        self.pool.shutdown(wait=True)
        self.served.release()

    def check(self) -> Dict:
        return {"prob_gap": _serving.check(self.served, self.answers,
                                           self.device),
                "missing": float(self.missing)}

    def reading(self, kind: str) -> Dict:
        """``'control'``: the reference one precision down in the
        program's place."""
        if kind != "control":
            raise ValueError(f"no reading {kind!r} for a serving cell")
        return {"prob_gap": _serving.control(
            self.served, self.answers, self.cell.config["control"],
            self.device), "missing": 0.0}
