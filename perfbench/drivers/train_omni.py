"""Training the omni late-fusion pool classifier through the K-step chunk
(``make_pool_scan_train_step`` above the resident cap: the streamed
split): K batches of three modalities' f32 features at E = 3584 staged on
the device once, then the chunk called back to back; on the card each call
replays one CUDA graph of K updates, the streamed forward reading each
step's seed words there.  The chunk runs under the configuration's
float32 product mode (``core.matmul_precision``), as a process training at
``precision='default'`` sets it: the head's products as TF32 as the
pool's.

Traffic keys: those of ``train_chunk``.

The check holds the first call's K updates to
``reference/pool_classifier.py`` in IEEE float32 as ``train_chunk`` does —
losses, the last gradients, the parameters' change, the pool's weights
and curriculum masks — and the first update alone: its pool weights
(``first_weights_gap``) and, from an eager step off the same weights, its
gradients element by element (``first_grad_gap``), before any optimizer
step spreads the rounding.  It needs the chunk's graph on the streamed
split and fails at set-up without one.
"""

from __future__ import annotations

import statistics
from typing import Dict, Optional

import torch

from ..reference import pool_classifier as ref
from . import train_chunk
from ._training import _norms, compare, reference_run


class Run(train_chunk.Run):
    def setup(self) -> None:
        super().setup()
        if self.device.type == "cuda" and not self.program.chunk._graphs:
            raise RuntimeError(
                "the chunk ran its steps eagerly: this cell measures the "
                "streamed split's K updates as one CUDA graph")

    def _call(self):
        from aecf_tpu_torch.core import matmul_precision

        with matmul_precision(self.cell.config["precision"]):
            return super()._call()

    def counters(self) -> Dict[str, float]:
        from aecf_tpu_torch.kernels import stream_bwd, stream_mix

        return dict(super().counters(),
                    **{"stream_mix.launches": stream_mix.launches,
                       "stream_bwd.launches": stream_bwd.launches})

    def first_grads(self) -> Dict[str, torch.Tensor]:
        """The program's gradients of the first update, from the
        benchmark's weights: one eager step over the first batch keyed by
        the first step's words, as the graph's first step takes it (the
        card's tests hold the two equal bit for bit)."""
        from aecf_tpu_torch.core import matmul_precision
        from aecf_tpu_torch.kernels.draws import fold_seed_words
        from aecf_tpu_torch.train import (
            TrainState,
            make_pool_train_step,
            param_leaves,
        )

        from .. import models

        cfg = self.cell.config
        params = models.pool_classifier_params(cfg, self.program.weights)
        leaves = param_leaves(params)
        state = TrainState(params, torch.optim.SGD(leaves, lr=0.0))
        step = make_pool_train_step(
            num_heads=cfg["num_heads"], impl="auto",
            precision=cfg["precision"], base_mask_prob=cfg["base_mask_prob"],
            entropy_target=cfg["entropy_target"],
            min_active=cfg["min_active"], entropy_coeff=cfg["entropy_coeff"])
        kv, labels = self.batches()[0]
        with matmul_precision(cfg["precision"]):
            step(state, kv, labels, fold_seed_words(self.rng, 0))
        return dict(zip(ref.LEAVES, (p.grad.detach().clone()
                                     for p in leaves)))

    def check(self) -> Dict:
        return numbers(self)

    def reading(self, kind: str) -> Dict:
        return numbers(self, kind)


def numbers(run, kind: str = "program") -> Dict[str, Optional[float]]:
    """``train_chunk``'s compared numbers of ``run`` (``'program'``, the
    control and the planted faults ``'half_batch'`` and ``'mask_altered'``)
    with the first update's beside them."""
    cfg, w = run.cell.config, run.program.weights
    batches = run.batches()
    want = reference_run(cfg, w, batches, run.rng, "f32")
    if kind == "program":
        got = dict(run.first, grads_first=run.first_grads())
    elif kind == "control":
        got = reference_run(cfg, w, batches, run.rng, cfg["control"])
    elif kind == "half_batch":
        got = reference_run(cfg, w, batches, run.rng, "f32",
                            loss_rows=batches[0][0].shape[0] // 2)
    elif kind == "mask_altered":
        got = reference_run(cfg, w, batches, run.rng ^ 1, "f32")
    else:
        raise ValueError(f"unknown reading {kind!r}")
    out = compare(got, want, w)
    first = _norms(want["grads_first"])
    med = statistics.median(first.values())
    diff = _norms({k: got["grads_first"][k].double().reshape(
        want["grads_first"][k].shape) - want["grads_first"][k].double()
        for k in ref.LEAVES})
    out["first_grad_leaves"] = {k: diff[k] / max(first[k], med)
                                for k in ref.LEAVES}
    out["first_grad_gap"] = max(out["first_grad_leaves"].values())
    out["first_weights_gap"] = None
    if "weights" in got:
        out["first_weights_gap"] = float(
            (got["weights"][0] - want["weights"][0]).abs().max())
    return out
