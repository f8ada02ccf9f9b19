"""Training through ``fit``: a host feature store, epoch-shuffled batches
(``make_epoch_batch_fn``), K batches staged a chunk, the K-step chunk
(``as_fit_chunk(make_pool_scan_train_step(...))``).

The first ``fit`` call, of one chunk, captures the chunk's graph and takes
the run's first K steps, snapshotted for the check (the rows as ``fit``
staged them, the losses the chunk returned, what the step left); a second, of
``rate_chunks`` chunks, gives the rate that sizes the window's call; the
window is one ``fit`` call of whole chunks.  Each call reads the store
from its own step on, so no two calls train on the same batches.

Traffic keys: ``batch``, ``modalities`` (2: image and text),
``store_rows``, ``scan_chunk`` (K), ``label_rate``, ``rate_chunks``,
``trace_start_s``, ``trace_s``.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from .. import models
from ..reference import epoch
from ._training import Program, numbers


class Run:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        t, c = cell.traffic, cell.config
        if t["modalities"] != 2:
            raise ValueError("fit feeds two streams, image and text")
        self.K, self.B = t["scan_chunk"], t["batch"]
        self.E, self.C = c["embed_dim"], c["num_classes"]
        self.data_seed = models.sub_seed(seed, "epochs") % (1 << 31)
        self.rng = models.sub_seed(seed, "fit0")  # the first call's
        self.steps = 0  # store batches of the fit calls so far
        self.fed = 0  # batch_fn calls so far
        self.tracer = None

    def setup(self) -> None:
        cfg, t = self.cell.config, self.cell.traffic
        from aecf_tpu_torch.train import (
            as_fit_chunk,
            fit,
            make_epoch_batch_fn,
        )

        self.program = Program(cfg, self.seed, self.device)
        n = t["store_rows"]
        g = models.generator(self.seed, "inputs", self.device)
        feats = torch.randn((2, n, self.E), generator=g, device=self.device)
        labels = (torch.rand((n, self.C), generator=g, device=self.device)
                  < t["label_rate"]).float()
        # numpy's own allocations, as a store loaded from disk is (numpy
        # asks for huge pages for them where the host allows)
        self.store = {}
        for name, made in (("image", feats[0]), ("text", feats[1]),
                           ("label", labels)):
            self.store[name] = np.empty(tuple(made.shape), np.float32)
            torch.from_numpy(self.store[name]).copy_(made)
        del feats, labels
        self.batch_fn = make_epoch_batch_fn(self.store, self.B,
                                            seed=self.data_seed)
        self.fit = fit
        inner = as_fit_chunk(self.program.chunk)

        def chunk_fn(state, images, texts, labels, rng):
            if self.recording:
                self.staged = torch.cat([images, texts], dim=-1).reshape(
                    -1, 2 * self.E).clone()
            out = inner(state, images, texts, labels, rng)
            if self.recording:
                self.first_losses = out[1]
            return out

        self.chunk_fn = chunk_fn
        self.recording = True
        self._fit(self.K, self.rng)
        self.recording = False
        self.first = self.program.snapshot(self.first_losses)
        steps = t["rate_chunks"] * self.K
        t0 = time.perf_counter()
        self._fit(steps, models.sub_seed(self.seed, "fit1"))
        self._sync()
        self.rate = steps / (time.perf_counter() - t0)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _feed(self, offset: int):
        """``batch_fn`` from store batch ``offset`` on, each call timed."""

        def batch(step):
            if self.tracer is not None:
                self.tracer.tick(time.perf_counter() - self.t0)
            t0 = time.perf_counter()
            out = self.batch_fn(offset + step)
            self.fed += 1
            if self.tracer is not None:
                self.tracer.record("batch_fn", time.perf_counter() - t0)
            return out

        return batch

    def _fit(self, steps: int, rng: int) -> None:
        p = self.program
        p.state, _ = self.fit(None, p.optimizer, p.state.params,
                              self._feed(self.steps), num_steps=steps,
                              rng=rng, chunk_fn=self.chunk_fn,
                              scan_chunk=self.K)
        self.steps += steps

    def counters(self) -> Dict[str, float]:
        from aecf_tpu_torch.kernels import train_step

        return {"updates": self.fed, "train_step.launches": train_step.launches}

    def window(self, seconds: float, tracer) -> Dict:
        chunks = max(1, round(self.rate * seconds / self.K))
        steps = chunks * self.K
        self.tracer = tracer
        self.t0 = time.perf_counter()
        self._fit(steps, models.sub_seed(self.seed, "window"))
        self._sync()
        tracer.stop()
        elapsed = time.perf_counter() - self.t0
        self.tracer = None
        return {
            "metrics": {"fit_samples_per_s": steps * self.B / elapsed},
            "attempted": steps, "failed": 0,
            "work": {"updates": steps, "elapsed_s": elapsed},
        }

    def release(self) -> None:
        self.program.release()

    def batches(self):
        """The first call's K batches as the reference gathers them from
        the store: ``(B, 2, E)`` image and text, and the labels."""
        if not hasattr(self, "_gathered"):
            idx = [epoch.batch_rows(len(self.store["label"]), self.B,
                                    self.data_seed, s) for s in range(self.K)]
            self._gathered = [(
                torch.from_numpy(np.stack([self.store["image"][i],
                                           self.store["text"][i]], axis=1)
                                 ).to(self.device),
                torch.from_numpy(self.store["label"][i]).to(self.device))
                for i in idx]
        return self._gathered

    def check(self) -> Dict:
        out = numbers(self)
        rows = torch.cat([kv.reshape(self.B, 2 * self.E)
                          for kv, _ in self.batches()])
        out["rows_differ"] = float((self.staged != rows).sum())
        return out

    def reading(self, kind: str) -> Dict:
        return dict(numbers(self, kind), rows_differ=0.0)
