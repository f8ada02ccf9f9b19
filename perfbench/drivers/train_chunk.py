"""Training through the K-step chunk (``make_pool_scan_train_step``):
K batches staged on the device once, then the chunk called back to back;
on the card each call replays one CUDA graph of K updates.

Traffic keys: ``batch``, ``modalities``, ``steps_per_call`` (K),
``label_rate`` (share of positive labels), ``warm_calls`` (calls after the
first, before the window), ``trace_start_s`` and ``trace_s`` (the traced
stretch of a ``--trace 1`` run).
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from .. import models
from ._training import Program, numbers


class Run:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        t, c = cell.traffic, cell.config
        self.K, self.B, self.M = t["steps_per_call"], t["batch"], t["modalities"]
        self.E, self.C = c["embed_dim"], c["num_classes"]
        self.rng = models.sub_seed(seed, "masks")
        self.calls = 0

    def setup(self) -> None:
        """The step object, the staged batches, the first call (capture and
        the first K updates, snapshotted for the check), the warm calls."""
        cfg, t = self.cell.config, self.cell.traffic
        self.program = Program(cfg, self.seed, self.device)
        g = models.generator(self.seed, "inputs", self.device)
        self.kv = torch.randn((self.K, self.B, self.M * self.E), generator=g,
                              device=self.device)
        self.labels = (torch.rand((self.K, self.B, self.C), generator=g,
                                  device=self.device) < t["label_rate"]).float()
        _, losses, _ = self._call()
        self.first = self.program.snapshot(losses)
        for _ in range(t["warm_calls"]):
            self._call()
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _call(self):
        p = self.program
        p.state, losses, infos = p.chunk(p.state, self.kv, self.labels,
                                         self.rng)
        self.calls += 1
        return p.state, losses, infos

    def counters(self) -> Dict[str, float]:
        from aecf_tpu_torch.kernels import train_step

        return {"updates": self.calls * self.K,
                "train_step.launches": train_step.launches}

    def window(self, seconds: float, tracer) -> Dict:
        start = self.calls
        t0 = time.perf_counter()
        while True:
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
            tracer.tick(elapsed)
            self._call()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        tracer.stop()
        elapsed = time.perf_counter() - t0
        updates = (self.calls - start) * self.K
        return {
            "metrics": {"train_samples_per_s": updates * self.B / elapsed},
            "attempted": updates, "failed": 0,
            "work": {"updates": updates, "elapsed_s": elapsed},
        }

    def release(self) -> None:
        self.program.release()

    def batches(self):
        """The first call's batches as the reference takes them."""
        return [(self.kv[i].view(self.B, self.M, self.E), self.labels[i])
                for i in range(self.K)]

    def check(self) -> Dict:
        return numbers(self)

    def reading(self, kind: str) -> Dict:
        return numbers(self, kind)
