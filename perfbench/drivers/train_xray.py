"""Training the chest X-ray AECF model through the model families' K-step
chunk (``make_scan_train_step`` over ``XrayAECFModel``), curriculum masking
and missing-modality simulation on: K batches of image and text features
staged on the device once, then the chunk called back to back; on the card
each call replays one CUDA graph of K updates, every draw keyed by the
step's seed words read there.

Traffic keys: ``batch``, ``steps_per_call`` (K), ``label_rate`` (share of
positive labels), ``curriculum_enabled`` and ``missing_modality_training``
(the forward's flags), ``warm_calls`` (calls after the first, before the
window), ``trace_start_s`` and ``trace_s`` (the traced stretch of a
``--trace 1`` run).

The check holds the first call's K updates to ``reference/xray.py`` in
IEEE float32 — losses, the last gradients, the parameters' change, the
pool's weights and curriculum masks, every missing-modality and dropout
bit; the first update's pool weights and, from an eager step off the
same weights, its gradients element by element, before any optimizer
step spreads the rounding — and counts the pool's calls by route in a
call: K on the torch route, none on the kernels'.  It needs the program's device-keyed draws
(``aecf_tpu_torch.kernels.draws.Draws``) and fails at set-up without them.
"""

from __future__ import annotations

import math
import statistics
import time
from typing import Dict, List, Optional

import torch

from .. import models
from ..reference import xray as ref
from ._training import FROZEN_SHARE, _gaps, _norms


def xray_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The X-ray model's state: torch's initial distributions — every
    weight and bias uniform in ``±1/√fan_in``, the pool's in-projection
    xavier-uniform, its biases uniform in ``±1/√E`` so that every bias path
    carries numbers — and the fusion query ``0.02·N(0, 1)``, the
    reference's."""
    I, T, E, C = (cfg["image_dim"], cfg["text_dim"], cfg["hidden_dim"],
                  cfg["num_classes"])
    g = models.generator(seed, "weights", device)
    layers = {"image_encoder": (E, I), "text_encoder": (E, T),
              "image_proj": (2 * E, E), "text_proj": (2 * E, E),
              "fusion_proj": (2 * E, E), "classifier_hidden": (E, 2 * E),
              "classifier_out": (C, E)}
    shapes = {"pool.in_proj_weight": (3 * E, E), "pool.in_proj_bias": (3 * E,),
              "pool.out_proj_weight": (E, E), "pool.out_proj_bias": (E,)}
    bounds = {k: 1.0 / math.sqrt(E) for k in shapes}
    bounds["pool.in_proj_weight"] = math.sqrt(6.0 / (4 * E))
    for name, (out, fan_in) in layers.items():
        shapes[f"{name}.weight"] = (out, fan_in)
        shapes[f"{name}.bias"] = (out,)
        bounds[f"{name}.weight"] = bounds[f"{name}.bias"] = \
            1.0 / math.sqrt(fan_in)
    w = models._uniform_leaves(shapes, bounds, g, device)
    w["fusion_query"] = 0.02 * torch.randn((1, 1, E), generator=g,
                                           device=device)
    return w


def xray_model(cfg: Dict, weights: Dict[str, torch.Tensor]):
    """The program's ``XrayAECFModel`` holding copies of ``weights``."""
    from aecf_tpu_torch.models import XrayAECFModel

    dev = weights["fusion_query"].device
    model = XrayAECFModel(
        cfg["image_dim"], cfg["text_dim"], cfg["num_classes"],
        cfg["hidden_dim"], num_heads=cfg["num_heads"],
        base_mask_prob=cfg["base_mask_prob"],
        entropy_target=cfg["entropy_target"], min_active=cfg["min_active"],
        missing_prob=cfg["missing_prob"], generator=torch.Generator(),
        device=dev)
    model.load_state_dict({k: v.clone() for k, v in weights.items()},
                          strict=True)
    return model


class _Recorder:
    """Keeps the uniforms of every model-level draw of the first call (on
    the card those of the capture: after the first replay they hold its
    values) — the program's missing-modality and dropout bits."""

    def __init__(self, draws_cls, cuda: bool):
        self.cls, self.cuda, self.got = draws_cls, cuda, []
        self.original = draws_cls.uniforms

    def __enter__(self):
        original, got, cuda = self.original, self.got, self.cuda

        def uniforms(draws, rows, cols, device):
            u = original(draws, rows, cols, device)
            if not cuda or torch.cuda.is_current_stream_capturing():
                got.append(u)
            return u

        self.cls.uniforms = uniforms
        return self

    def __exit__(self, *exc):
        self.cls.uniforms = self.original


def drop_bits(uniforms: List[torch.Tensor], K: int, cfg: Dict) -> torch.Tensor:
    """Each step's missing-modality and dropout bits from its draws (the
    ``(B, 3)`` block, then three dropout blocks), in the reference's
    order."""
    per = len(uniforms) // K
    out = []
    for i in range(K):
        u, *drops = uniforms[i * per:(i + 1) * per]
        drop_img = u[:, 0] < cfg["missing_prob"]
        drop_txt = u[:, 1] < cfg["missing_prob"]
        keep_img = u[:, 2] > 0.5
        both = drop_img & drop_txt
        bits = [torch.where(both, ~keep_img, drop_img),
                torch.where(both, keep_img, drop_txt), keep_img]
        bits += [d < 1.0 - ref.DROP_RATE for d in drops]
        out.append(torch.cat([b.reshape(-1) for b in bits]))
    return torch.stack(out)


class Run:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        t, c = cell.traffic, cell.config
        self.K, self.B = t["steps_per_call"], t["batch"]
        self.rng = models.sub_seed(seed, "draws")
        self.calls = 0
        self.route_calls: Optional[Dict[str, float]] = None

    def setup(self) -> None:
        """The model, its optimizer and chunk over the benchmark's weights,
        the staged batches, the first call (capture and the first K
        updates, snapshotted for the check), the warm calls."""
        from aecf_tpu_torch.kernels.draws import Draws
        from aecf_tpu_torch.train import TrainState, make_scan_train_step

        cfg, t = self.cell.config, self.cell.traffic
        dev = self.device
        self.weights = xray_weights(cfg, self.seed, dev)
        self.model = xray_model(cfg, self.weights)
        opt = cfg["optimizer"]
        self.optimizer = torch.optim.AdamW(
            self.model.parameters(), lr=opt["lr"], betas=tuple(opt["betas"]),
            eps=opt["eps"], weight_decay=opt["weight_decay"],
            capturable=dev.type == "cuda")
        self.state = TrainState(self.model, self.optimizer)
        flags = dict(curriculum_enabled=t["curriculum_enabled"],
                     missing_modality_training=t["missing_modality_training"])

        def apply_fn(model, images, texts, generator):
            model.train()
            return model(images, texts, generator=generator,
                         return_info=True, **flags)

        self.apply_fn = apply_fn
        self.chunk = make_scan_train_step(
            apply_fn, entropy_coeff=cfg["entropy_coeff"])
        g = models.generator(self.seed, "inputs", dev)
        K, B = self.K, self.B
        self.images = torch.randn((K, B, cfg["image_dim"]), generator=g,
                                  device=dev)
        self.texts = torch.randn((K, B, cfg["text_dim"]), generator=g,
                                 device=dev)
        self.labels = (torch.rand((K, B, cfg["num_classes"]), generator=g,
                                  device=dev) < t["label_rate"]).float()
        with _Recorder(Draws, dev.type == "cuda") as drawn:
            losses = self._call()
        self.first = self._snapshot(losses, drawn.got)
        before = self.counters()
        for _ in range(t["warm_calls"]):
            self._call()
        after = self.counters()
        self.route_calls = {k: (after[k] - before[k]) / t["warm_calls"]
                            for k in ("fusion_pool.torch_route",
                                      "fusion_pool.kernel_route")}
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def _call(self) -> torch.Tensor:
        from aecf_tpu_torch.core import matmul_precision

        with matmul_precision(self.cell.config["precision"]):
            self.state, losses, _ = self.chunk(
                self.state, self.images, self.texts, self.labels, self.rng)
        self.calls += 1
        return losses

    def _snapshot(self, losses, drawn) -> Dict:
        """What the first call left, read before any later call: the
        per-step losses, the last step's gradients and the parameters by
        name, every draw's bits; on the card's graph route also each step's
        attention weights and mask, as the graph wrote them."""
        named = list(self.model.named_parameters())
        snap = {
            "losses": losses.detach().float().clone(),
            "grads_last": {n: p.grad.detach().clone() for n, p in named},
            "params": {n: p.detach().clone() for n, p in named},
            "drops": drop_bits(drawn, self.K, self.cell.config).cpu(),
        }
        graphs = list(self.chunk._graphs.values())
        if graphs:
            info = graphs[0].step_info
            snap["weights"] = torch.stack(
                [i["attention_weights"][:, 0, :].float() for i in info])
            snap["masks"] = torch.stack(
                [i["masked_attention_weights"][:, 0, :] > 0 for i in info])
        return snap

    def first_grads(self) -> Dict[str, torch.Tensor]:
        """The program's gradients of the first update, from the
        benchmark's weights: one eager step over the first batch keyed by
        the first step's words, as the graph's first step takes it (the
        card's tests hold the two equal bit for bit)."""
        from aecf_tpu_torch.core import matmul_precision
        from aecf_tpu_torch.kernels.draws import fold_seed_words
        from aecf_tpu_torch.train import TrainState, make_train_step

        cfg = self.cell.config
        model = xray_model(cfg, self.weights)
        state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0))
        step = make_train_step(self.apply_fn,
                               entropy_coeff=cfg["entropy_coeff"])
        with matmul_precision(cfg["precision"]):
            step(state, self.images[0], self.texts[0], self.labels[0],
                 fold_seed_words(self.rng, 0))
        return {n: p.grad.detach().clone()
                for n, p in model.named_parameters()}

    def counters(self) -> Dict[str, float]:
        from aecf_tpu_torch import ops
        from aecf_tpu_torch.kernels import draws

        return {"updates": self.calls * self.K,
                "draws.launches": draws.counted.launches,
                "draws.bytes": draws.counted.bytes,
                "fusion_pool.torch_route": ops.routes.torch_route,
                "fusion_pool.kernel_route": ops.routes.kernel_route}

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
        self.chunk = self.state = self.optimizer = self.model = None

    def batches(self):
        """The first call's batches as the reference takes them."""
        return [(self.images[i], self.texts[i], self.labels[i])
                for i in range(self.K)]

    def check(self) -> Dict:
        return numbers(self)

    def reading(self, kind: str) -> Dict:
        return numbers(self, kind)


def reference_run(run, precision: str, **fault) -> Dict:
    """The plain reference over the run's first batches at ``precision``
    (``fault``: :func:`..reference.xray.train`'s keywords, or ``rng``)."""
    kw = dict(rng=run.rng,
              missing=run.cell.traffic["missing_modality_training"])
    kw.update(fault)
    return ref.train(run.weights, run.batches(), precision=precision,
                     cfg=run.cell.config, **kw)


def compare(prog: Dict, want: Dict, weights0: Dict[str, torch.Tensor]
            ) -> Dict[str, Optional[float]]:
    """The numbers the cell holds to its limits (``route_calls_off`` is
    the caller's)."""
    names = list(want["params"])
    lp, lr = prog["losses"].double().cpu(), want["losses"].double().cpu()
    first = _norms(want["grads_first"])
    med = statistics.median(first.values())
    moved = [k for k in names if first[k] >= FROZEN_SHARE * med]
    delta = lambda p: {k: p[k].float() - weights0[k].reshape(p[k].shape)  # noqa: E731
                       for k in names}
    grads = _gaps(_norms(prog["grads_last"]), _norms(want["grads_last"]),
                  names)
    # the first update's gradients element by element: each leaf's norm of
    # the difference over its reference norm or the median leaf's
    first_diff = _norms({k: prog["grads_first"][k].double()
                         - want["grads_first"][k].double() for k in names})
    first_grads = {k: first_diff[k] / max(first[k], med) for k in names}
    updates = _gaps(_norms(delta(prog["params"])),
                    _norms(delta(want["params"])), moved)
    out: Dict[str, Optional[float]] = {
        "loss_gap": float(((lp - lr).abs() / lr.abs()).max()),
        "grad_gap": max(grads.values()),
        "update_gap": max(updates.values()),
        "weights_gap": None,
        "mask_share": None,
        "drop_share": float((prog["drops"].cpu() != want["drops"].cpu())
                            .float().mean()),
        "first_grad_gap": max(first_grads.values()),
        "first_weights_gap": None,
        # by leaf and by step, for the readings; no limit reads them
        "grad_leaves": grads,
        "update_leaves": updates,
        "first_grad_leaves": first_grads,
    }
    if "weights" in prog:
        steps = (prog["weights"] - want["weights"]).abs().amax(dim=(1, 2))
        out["weights_gap"] = float(steps.max())
        out["first_weights_gap"] = float(steps[0])
        out["weights_steps"] = steps.tolist()
        out["mask_share"] = float(
            (prog["masks"] != want["masks"]).float().mean())
    return out


def numbers(run, kind: str = "program") -> Dict[str, Optional[float]]:
    """The compared numbers of ``run`` against the plain reference in f32,
    with in the program's place: ``'program'`` the program's first call;
    ``'control'`` the reference one precision down (the configuration's
    ``control``); the planted faults ``'half_batch'`` (the loss over half
    of each batch), ``'mask_altered'`` (every draw from other seed words),
    ``'missing_off'`` (no missing-modality simulation) and ``'unchanged'``
    (a state left unchanged)."""
    cfg = run.cell.config
    want = reference_run(run, "f32")
    faults = {"control": (cfg["control"], {}),
              "half_batch": ("f32", {"loss_rows": run.B // 2}),
              "mask_altered": ("f32", {"rng": run.rng ^ 1}),
              "missing_off": ("f32", {"missing": False}),
              "unchanged": ("f32", {"lr": 0.0})}
    if kind == "program":
        got = dict(run.first, grads_first=run.first_grads())
    elif kind in faults:
        precision, fault = faults[kind]
        got = reference_run(run, precision, **fault)
        if kind == "missing_off":
            # a forward without the simulation drops no modality
            got["drops"] = torch.cat([torch.zeros(
                (run.K, 3 * run.B), dtype=torch.bool,
                device=got["drops"].device), got["drops"]], dim=1)
    else:
        raise ValueError(f"unknown reading {kind!r}")
    out = compare(got, want, run.weights)
    calls = run.route_calls if kind == "program" else None
    out["route_calls_off"] = None if calls is None else float(
        abs(calls["fusion_pool.torch_route"] - run.K)
        + calls["fusion_pool.kernel_route"])
    return out

