"""Offline re-scoring: one client sends large requests of both modalities
straight to ``FusionPredictor``, each after the last returned (a closed
loop).  Requests cycle over a few host arrays in an order drawn from the
seed.

Traffic keys: ``request_rows``, ``arrays``, ``buckets``,
``sample_requests`` (answers kept for the check, beside the last),
``warm_requests``, ``trace_start_s``, ``trace_s``.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np

from .. import models
from . import _serving


class Run:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.t = cell.traffic
        self.n = self.t["request_rows"]
        self.rows = 0

    def setup(self) -> None:
        self.served = _serving.Served(self.cell.config, self.t, self.seed,
                                      self.device,
                                      self.t["arrays"] * self.n)
        self.order = np.random.default_rng(
            models.sub_seed(self.seed, "order")).permutation(self.t["arrays"])
        self.served.warm()
        for i in range(self.t["warm_requests"]):
            self._send(i)

    def _start(self, i: int) -> int:
        return int(self.order[i % len(self.order)]) * self.n

    def _send(self, i: int) -> np.ndarray:
        out = self.served.predictor(**self.served.request(
            self._start(i), self.n, "both"))
        self.rows += len(out)
        return out

    def counters(self) -> Dict[str, float]:
        from aecf_tpu_torch.kernels import shared_query_fwd

        return {"rows": self.rows,
                "predictor.calls": self.served.predictor.calls,
                "shared_query_fwd.launches": shared_query_fwd.launches}

    def window(self, seconds: float, tracer) -> Dict:
        rng = np.random.default_rng(models.sub_seed(self.seed, "sample"))
        keep = set(rng.choice(4 * self.t["sample_requests"],
                              self.t["sample_requests"], replace=False)
                   .tolist())
        self.answers, start, i = [], self.rows, 0
        t0 = time.perf_counter()
        while True:
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
            tracer.tick(elapsed)
            out = self._send(i)
            if i in keep:
                self.answers.append((self._start(i), self.n, "both", out))
            i += 1
        elapsed = time.perf_counter() - t0
        tracer.stop()
        self.answers.append((self._start(i - 1), self.n, "both", out))
        rows = self.rows - start
        return {
            "metrics": {"serve_rows_per_s": rows / elapsed},
            "attempted": i, "failed": 0,
            "work": {"requests": i, "rows": rows, "elapsed_s": elapsed},
        }

    def release(self) -> None:
        self.served.release()

    def check(self) -> Dict:
        return {"prob_gap": _serving.check(self.served, self.answers,
                                           self.device)}

    def reading(self, kind: str) -> Dict:
        """``'control'``: the reference one precision down in the
        program's place."""
        if kind != "control":
            raise ValueError(f"no reading {kind!r} for a serving cell")
        return {"prob_gap": _serving.control(
            self.served, self.answers, self.cell.config["control"],
            self.device)}
