"""What the two training drivers share: the program's step object over the
benchmark's weights, the snapshot of its first steps, and the comparison of
those steps with the plain reference's."""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import torch

from .. import models
from ..reference import pool_classifier as ref

# leaves whose reference gradient is under this share of the median leaf's
# move under Adam by round-off alone, and are left out of the change
FROZEN_SHARE = 1e-3


class Program:
    """The step object of a training cell: parameters, optimizer and the
    chunk builder's callable, built once over the benchmark's weights
    (``weights``, kept apart for the reference)."""

    def __init__(self, cfg: Dict, seed: int, device):
        from aecf_tpu_torch.train import (
            TrainState,
            make_pool_scan_train_step,
            param_leaves,
        )

        self.cfg = cfg
        self.weights = models.pool_classifier_weights(cfg, seed, device)
        params = models.pool_classifier_params(cfg, self.weights)
        opt = cfg["optimizer"]
        self.optimizer = torch.optim.AdamW(
            param_leaves(params), lr=opt["lr"], betas=tuple(opt["betas"]),
            eps=opt["eps"], weight_decay=opt["weight_decay"],
            capturable=device.type == "cuda")
        self.state = TrainState(params, self.optimizer)
        self.leaves = param_leaves(params)
        self.chunk = make_pool_scan_train_step(
            num_heads=cfg["num_heads"], impl="auto",
            precision=cfg["precision"],
            base_mask_prob=cfg["base_mask_prob"],
            entropy_target=cfg["entropy_target"],
            min_active=cfg["min_active"], entropy_coeff=cfg["entropy_coeff"])

    def snapshot(self, losses: torch.Tensor) -> Dict:
        """What the first steps left, read before any later step: the
        per-step losses, the last step's gradients as the optimizer got
        them, the parameters; on the card's graph route also each step's
        attention weights and mask, as the graph wrote them."""
        snap = {
            "losses": losses.detach().float().clone(),
            "grads_last": dict(zip(ref.LEAVES, (
                p.grad.detach().clone() for p in self.leaves))),
            "params": dict(zip(ref.LEAVES, (
                p.detach().clone() for p in self.leaves))),
        }
        graphs = list(self.chunk._graphs.values())
        if graphs:
            info = graphs[0].step_info
            snap["weights"] = torch.stack(
                [i["attention_weights"][:, 0, :].float() for i in info])
            snap["masks"] = torch.stack(
                [i["masked_attention_weights"][:, 0, :] > 0 for i in info])
        return snap

    def release(self) -> None:
        self.chunk = self.state = self.optimizer = self.leaves = None


def reference_run(cfg: Dict, weights: Dict[str, torch.Tensor], batches,
                  rng, precision: str, **fault) -> Dict:
    """The plain reference over ``batches`` at ``precision``, in the
    snapshot's form (``fault``: :func:`..reference.pool_classifier.train`'s
    ``loss_rows``)."""
    out = ref.train(weights, batches, rng=rng, precision=precision,
                    optimizer=cfg["optimizer"],
                    mask_prob=cfg["base_mask_prob"],
                    min_active=cfg["min_active"], **fault)
    out["masks"] = out["masks"] > 0.5
    return out


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            leaves.items()}


def _gaps(got: Dict[str, float], want: Dict[str, float],
          names: List[str]) -> Dict[str, float]:
    """Each leaf's gap between two norms, against the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    med = statistics.median(want[k] for k in names)
    return {k: abs(got[k] - want[k]) / max(want[k], med) for k in names}


def compare(prog: Dict, want: Dict, weights0: Dict[str, torch.Tensor]
            ) -> Dict[str, Optional[float]]:
    """The numbers a training cell holds to its limits."""
    lp, lr = prog["losses"].double().cpu(), want["losses"].double().cpu()
    first = _norms(want["grads_first"])
    med = statistics.median(first.values())
    moved = [k for k in ref.LEAVES if first[k] >= FROZEN_SHARE * med]
    delta = lambda p: {k: p[k].float() - weights0[k].reshape(p[k].shape)  # noqa: E731
                       for k in ref.LEAVES}
    grads = _gaps(_norms(prog["grads_last"]), _norms(want["grads_last"]),
                  list(ref.LEAVES))
    updates = _gaps(_norms(delta(prog["params"])),
                    _norms(delta(want["params"])), moved)
    out: Dict[str, Optional[float]] = {
        "loss_gap": float(((lp - lr).abs() / lr.abs()).max()),
        "grad_gap": max(grads.values()),
        "update_gap": max(updates.values()),
        "weights_gap": None,
        "mask_share": None,
        # by leaf, for the readings; no limit reads them
        "grad_leaves": grads,
        "update_leaves": updates,
    }
    if "weights" in prog:
        out["weights_gap"] = float(
            (prog["weights"] - want["weights"]).abs().max())
        out["mask_share"] = float(
            (prog["masks"] != want["masks"]).float().mean())
    return out


def numbers(run, kind: str = "program") -> Dict[str, Optional[float]]:
    """The compared numbers of a training driver ``run`` (its ``first``
    snapshot, ``batches()``, ``rng`` and ``program.weights``) against the
    plain reference in f32, with in the program's place: ``'program'`` the
    program's first steps; ``'control'`` the reference one precision down
    (the configuration's ``control``); ``'half_batch'`` the reference with
    its loss over half of each batch; ``'mask_altered'`` the reference
    drawing its masks from other seed words."""
    cfg, w = run.cell.config, run.program.weights
    batches = run.batches()
    want = reference_run(cfg, w, batches, run.rng, "f32")
    if kind == "program":
        got = run.first
    elif kind == "control":
        got = reference_run(cfg, w, batches, run.rng, cfg["control"])
    elif kind == "half_batch":
        got = reference_run(cfg, w, batches, run.rng, "f32",
                            loss_rows=batches[0][0].shape[0] // 2)
    elif kind == "mask_altered":
        got = reference_run(cfg, w, batches, run.rng ^ 1, "f32")
    else:
        raise ValueError(f"unknown reading {kind!r}")
    return compare(got, want, w)
