"""Training harness: the state, BCE steps, chunks, evaluation and the
baseline-vs-AECF experiment.

Port of :mod:`aecf_tpu.train.trainer`.  JAX keeps the optimizer state
beside immutable parameters and returns a new state from every step; here
the parameters are tensors that a ``torch.optim`` optimizer updates in
place, so the state holds the parameters, the optimizer over their leaves,
and the step count.  ``apply_fn(params, images, texts, generator) ->
(logits, info)`` takes the parameters — a model of
:mod:`aecf_tpu_torch.models` (an ``nn.Module``) or a pool-classifier dict —
and a CPU ``torch.Generator`` for the step's draws, in place of JAX's
``rng``.  A step's ``rng`` is a seed (an int or two 32-bit words, folded
with the step index as JAX folds keys) or a generator.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.masking import entropy_loss
from ..kernels.draws import device_generator, fold_seed_words, seed_words_of
from .metrics import calculate_metrics
from .staging import Stager

__all__ = [
    "TrainState",
    "param_leaves",
    "bce_with_logits_loss",
    "accumulate_grads",
    "make_train_step",
    "make_scan_train_step",
    "mask_modality",
    "evaluate_model",
    "ExperimentConfig",
    "train_parallel_experiment",
]

RngLike = Union[int, Tuple[int, int], torch.Generator, None]


def param_leaves(params: Any) -> List[torch.Tensor]:
    """The trainable tensors of ``params`` in a fixed order: a module's
    ``parameters()``, or for a ``{'pool', 'query'[, 'head']}`` dict the
    pool's parameters (``named_parameters`` order), the query, then the
    head's ``w`` and ``b``."""
    if isinstance(params, nn.Module):
        return list(params.parameters())
    leaves = list(params["pool"].parameters()) + [params["query"]]
    head = params.get("head")
    if head is not None:
        leaves += [head[k] for k in ("w", "b") if head.get(k) is not None]
    return leaves


@dataclasses.dataclass
class TrainState:
    """``params`` (see :func:`param_leaves`), ``optimizer`` over their
    leaves, e.g. ``torch.optim.AdamW(param_leaves(params), lr=1e-4,
    weight_decay=0.01)`` (pass the decay: torch's default is 1e-2,
    optax's 1e-4), and ``step``, the number of updates taken."""

    params: Any
    optimizer: torch.optim.Optimizer
    step: int = 0


def _generator(rng: RngLike) -> Optional[torch.Generator]:
    """A CPU generator for ``apply_fn``: ``rng`` itself, or one seeded
    from its two words."""
    if rng is None or isinstance(rng, torch.Generator):
        return rng
    return device_generator(seed_words_of(rng), "cpu")


def _params_device(params: Any) -> torch.device:
    return param_leaves(params)[0].device


def bce_with_logits_loss(logits: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on logits (torch ``BCEWithLogitsLoss``)."""
    return F.binary_cross_entropy_with_logits(logits, labels.to(logits.dtype))


def _set_grads(leaves, grads) -> None:
    for p, g in zip(leaves, grads):
        p.grad = None if g is None else g.detach().to(p.dtype)


def _unstack_info(infos: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The per-sample info contract after microbatching: per-row leaves
    concatenated in microbatch order, per-microbatch scalars stacked."""
    return {
        k: torch.cat([d[k] for d in infos]) if torch.as_tensor(
            infos[0][k]).ndim else torch.stack([torch.as_tensor(d[k])
                                                for d in infos])
        for k in infos[0]
    }


def accumulate_grads(
    loss_fn: Callable[..., Tuple[torch.Tensor, Any]],
    params: Any,
    microbatches: Tuple[Tuple[torch.Tensor, ...], ...],
    rng: RngLike,
    accum_steps: int,
):
    """Run ``loss_fn(params, *microbatch, generator_i) -> (loss, info)``
    over ``microbatches`` (a tuple of per-stream tuples of ``accum_steps``
    slices), averaging loss and gradients.

    Returns ``(loss, info, grads)``: ``loss`` and ``grads`` (in
    :func:`param_leaves` order) are the full-batch means (equal microbatches
    of a mean loss), ``info`` is full-batch shaped.  Microbatch ``i`` draws
    from the fold of ``rng`` and ``i`` (JAX's ``fold_in(rng, i)``), so the
    draws are i.i.d. across microbatches.
    """
    leaves = param_leaves(params)
    gsum, losses, infos = None, [], []
    for i in range(accum_steps):
        micro = tuple(stream[i] for stream in microbatches)
        gen = _generator(fold_seed_words(_seed_of(rng), i))
        loss, info = loss_fn(params, *micro, gen)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        gsum = list(grads) if gsum is None else [
            b if a is None else (a if b is None else a + b)
            for a, b in zip(gsum, grads)
        ]
        losses.append(loss.detach())
        infos.append({k: v.detach() for k, v in info.items()})
    grads = [None if g is None else g / accum_steps for g in gsum]
    return torch.stack(losses).mean(), _unstack_info(infos), grads


def _seed_of(rng: RngLike):
    """Two seed words of ``rng`` (drawn from it when it is a generator)."""
    if isinstance(rng, torch.Generator):
        words = torch.randint(0, 2**32, (2,), generator=rng)
        return int(words[0]), int(words[1])
    return seed_words_of(0 if rng is None else rng)


def _split_microbatches(arrays, accum_steps: int):
    batch = arrays[0].shape[0]
    if batch % accum_steps:
        raise ValueError(
            f"batch size {batch} is not divisible by accum_steps="
            f"{accum_steps}"
        )
    return tuple(torch.chunk(x, accum_steps) for x in arrays)


def _make_loss_on(apply_fn, entropy_coeff, entropy_seq_len):
    """The train-step loss: BCE + the optional (detached in training,
    quirk Q2) entropy regularizer."""

    def loss_on(params, images, texts, labels, generator):
        logits, info = apply_fn(params, images, texts, generator)
        loss = bce_with_logits_loss(logits, labels)
        if entropy_coeff and "entropy" in info:
            loss = loss + entropy_coeff * entropy_loss(
                info["entropy"], seq_len=entropy_seq_len
            )
        return loss, info

    return loss_on


def _grad_step(state, images, texts, labels, rng, *, loss_on, accum_steps,
               reduce=None):
    """One ``(state, batch, rng) -> (state, loss, info)`` update: the body
    of :func:`make_train_step` and :func:`make_scan_train_step`, and of the
    parallel steps, whose ``reduce(loss, info, grads)`` makes the
    cross-rank sums before the optimizer's update."""
    leaves = param_leaves(state.params)
    if accum_steps == 1:
        loss, info = loss_on(state.params, images, texts, labels,
                             _generator(rng))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        loss = loss.detach()
        info = {k: v.detach() for k, v in info.items()}
    else:
        mbs = _split_microbatches((images, texts, labels), accum_steps)
        loss, info, grads = accumulate_grads(
            loss_on, state.params, mbs, rng, accum_steps
        )
    if reduce is not None:
        loss, info, grads = reduce(loss, info, grads)
    _set_grads(leaves, grads)
    state.optimizer.step()
    state.step += 1
    return state, loss, info


def make_train_step(
    apply_fn: Callable[..., Any],
    *,
    entropy_coeff: float = 0.0,
    entropy_seq_len: int = 2,
    accum_steps: int = 1,
) -> Callable:
    """Build a ``(state, images, texts, labels, rng) -> (state, loss,
    info)`` step: mean BCE on ``apply_fn``'s logits (plus ``entropy_coeff``
    times the entropy regularizer, a detached value in training), the
    gradients by autograd, one ``state.optimizer.step()``.  The JAX
    builder's optimizer is ``state.optimizer`` here; ``donate`` has no
    counterpart.  ``accum_steps > 1`` splits the batch into that many equal
    microbatches (:func:`accumulate_grads`) for one update."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    loss_on = _make_loss_on(apply_fn, entropy_coeff, entropy_seq_len)

    def step(state: TrainState, images, texts, labels, rng):
        return _grad_step(state, images, texts, labels, rng,
                          loss_on=loss_on, accum_steps=accum_steps)

    return step


def make_scan_train_step(
    apply_fn: Callable[..., Any],
    *,
    entropy_coeff: float = 0.0,
    entropy_seq_len: int = 2,
    accum_steps: int = 1,
) -> Callable:
    """Build a K-step chunk ``(state, images, texts, labels, rng) ->
    (state, losses (K,), infos)``: the batch streams carry a leading steps
    axis ``(K, B, ...)`` and the K updates run in one call, eagerly.  Step
    ``i`` draws from :func:`~aecf_tpu_torch.kernels.draws.fold_seed_words`
    of ``rng`` and the global ``state.step`` — JAX's ``fold_in(rng,
    state.step)`` — so chunks chain and resume exactly like single steps
    fed those words.  ``infos`` are per-step means."""
    return _chunk_of(make_train_step(apply_fn, entropy_coeff=entropy_coeff,
                                     entropy_seq_len=entropy_seq_len,
                                     accum_steps=accum_steps))


def _chunk_of(step: Callable) -> Callable:
    """The K-step chunk over ``step``: step ``i`` fed the fold of ``rng``
    and the global ``state.step``."""

    def chunk(state: TrainState, images, texts, labels, rng):
        losses, infos = [], {}
        for i in range(images.shape[0]):
            state, loss, info = step(state, images[i], texts[i], labels[i],
                                     fold_seed_words(_seed_of(rng),
                                                     state.step))
            losses.append(loss)
            for k, v in info.items():
                infos.setdefault(k, []).append(v.float().mean())
        return (state, torch.stack(losses),
                {k: torch.stack(v) for k, v in infos.items()})

    return chunk


def mask_modality(
    images: np.ndarray, texts: np.ndarray, mask_type: str = "none"
) -> Tuple[np.ndarray, np.ndarray]:
    """Zero one modality for eval sweeps (reference :252-258)."""
    if mask_type == "images":
        return np.zeros_like(images), texts
    if mask_type == "texts":
        return images, np.zeros_like(texts)
    return images, texts


def _iter_batches(n: int, batch_size: int, *, shuffle: bool, seed: int):
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    for start in range(0, n, batch_size):
        yield idx[start : start + batch_size]


def evaluate_model(
    predict_fn: Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor],
    params: Any,
    images: np.ndarray,
    texts: np.ndarray,
    labels: np.ndarray,
    mask_type: str = "none",
    batch_size: int = 64,
) -> Tuple[float, float, np.ndarray]:
    """Masked eval sweep → (mAP, macro F1, per-label F1) (reference
    :297-310).  ``predict_fn(params, images, texts) -> logits`` runs on the
    parameters' device under ``torch.no_grad``; ragged final batches are
    padded to ``batch_size`` with zero rows, as JAX pads them to one
    compiled shape."""
    images, texts = mask_modality(images, texts, mask_type)
    stage = Stager(_params_device(params))
    n = images.shape[0]
    preds = []
    with torch.no_grad():
        for sel in _iter_batches(n, batch_size, shuffle=False, seed=0):
            bi, bt = images[sel], texts[sel]
            pad = batch_size - len(sel)
            if pad:
                bi = np.concatenate([bi, np.zeros((pad, bi.shape[1]), bi.dtype)])
                bt = np.concatenate([bt, np.zeros((pad, bt.shape[1]), bt.dtype)])
            logits = predict_fn(params, *stage([(bi, bt)]))
            preds.append(logits.float().cpu().numpy()[: len(sel)])
    return calculate_metrics(np.concatenate(preds), labels)


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Hyperparameters of the parallel baseline-vs-AECF experiment
    (reference defaults: epochs=60 :755, batch=64 :247, lr=1e-4 :312,
    weight_decay=0.01 :324-325, curriculum activation at epoch 40 :344-349).
    """

    epochs: int = 60
    batch_size: int = 64
    lr: float = 1e-4
    weight_decay: float = 0.01
    curriculum_epoch: int = 40
    seed: int = 0
    eval_batch_size: int = 64


def _fusion_rows_mean(x, row_mask):
    """Mean over the both-present rows (the reference pools only those;
    ``info['fusion_row_mask']``); None when no row fused."""
    x = x.float()
    if row_mask is None:
        return float(x.mean())
    rows = int(row_mask.sum())
    if rows == 0:
        return None
    per_row = x.numel() // row_mask.numel()
    m = row_mask.reshape(tuple(row_mask.shape) + (1,) * (x.ndim - row_mask.ndim))
    return float(torch.where(m, x, 0.0).sum() / (rows * per_row))


def train_parallel_experiment(
    baseline_model: nn.Module,
    aecf_model: nn.Module,
    train_data: Dict[str, np.ndarray],
    val_data: Dict[str, np.ndarray],
    config: ExperimentConfig = ExperimentConfig(),
    *,
    verbose: bool = True,
) -> Dict[str, Dict[str, list]]:
    """Train baseline and AECF models in lockstep with curriculum
    activation — the reference's ``train_both_models``
    (train_xrays_example.py:312-427): AdamW, BCE, the curriculum and
    missing-modality simulation switched on at ``curriculum_epoch``, and
    per-epoch eval with no modality, images or texts masked.  The results
    dict has the JAX function's schema.

    The models are the port's (``XrayBaselineModel``, ``XrayAECFModel``),
    built — and their parameters drawn — by the caller, on the device the
    experiment runs on; JAX's ``model.init`` draws them from the config's
    seed instead.  Batch draws fold the config's seed with the epoch and
    the batch index.  "Parallel" is the two models in lockstep, not
    devices."""
    words = seed_words_of(config.seed)
    k_train = fold_seed_words(words, 2)

    def make_opt(model):
        return torch.optim.AdamW(model.parameters(), lr=config.lr,
                                 weight_decay=config.weight_decay)

    base_state = TrainState(baseline_model, make_opt(baseline_model))
    aecf_state = TrainState(aecf_model, make_opt(aecf_model))

    def base_apply(model, images, texts, generator):
        model.train()
        return model(images, texts, generator=generator), {}

    def make_aecf_apply(curriculum: bool):
        def apply(model, images, texts, generator):
            model.train()
            return model(images, texts, generator=generator,
                         curriculum_enabled=curriculum,
                         missing_modality_training=curriculum,
                         return_info=True)

        return apply

    base_step = make_train_step(base_apply)
    aecf_step_pre = make_train_step(make_aecf_apply(False))
    aecf_step_post = make_train_step(make_aecf_apply(True))

    def predict(model, images, texts):
        model.eval()
        return model(images, texts)

    def empty_track():
        return {
            "train_loss": [],
            "val_full_map": [],
            "val_full_f1": [],
            "val_full_f1_per_label": [],
            "val_no_images_map": [],
            "val_no_images_f1": [],
            "val_no_images_f1_per_label": [],
            "val_no_texts_map": [],
            "val_no_texts_f1": [],
            "val_no_texts_f1_per_label": [],
        }

    results: Dict[str, Dict[str, list]] = {
        "baseline": empty_track(),
        "aecf": {**empty_track(), "gate_entropy": [], "mask_rate": []},
    }
    tr_img, tr_txt, tr_lab = (
        train_data["image"], train_data["text"], train_data["label"],
    )
    stage = Stager(_params_device(baseline_model))

    for epoch in range(config.epochs):
        curriculum_on = epoch >= config.curriculum_epoch
        if epoch == config.curriculum_epoch and verbose:
            print(f"EPOCH {epoch + 1}: activating curriculum masking")
        aecf_step = aecf_step_post if curriculum_on else aecf_step_pre
        base_losses, aecf_losses = [], []
        epoch_entropies, epoch_mask_rates = [], []
        epoch_key = fold_seed_words(k_train, epoch)

        for bi, sel in enumerate(_iter_batches(
                tr_img.shape[0], config.batch_size, shuffle=True,
                seed=config.seed + epoch)):
            if len(sel) < config.batch_size:
                continue  # drop the ragged tail batch, as the reference
            images, texts, labels = stage(
                [(tr_img[sel], tr_txt[sel], tr_lab[sel])])
            bkey = fold_seed_words(epoch_key, bi)
            kb, ka = fold_seed_words(bkey, 0), fold_seed_words(bkey, 1)
            base_state, base_loss, _ = base_step(
                base_state, images, texts, labels, kb)
            aecf_state, aecf_loss, info = aecf_step(
                aecf_state, images, texts, labels, ka)
            base_losses.append(float(base_loss))
            aecf_losses.append(float(aecf_loss))
            row_mask = info.get("fusion_row_mask")
            for key_, sink in (("entropy", epoch_entropies),
                               ("mask_rate", epoch_mask_rates)):
                if key_ in info:
                    v = _fusion_rows_mean(info[key_], row_mask)
                    if v is not None:
                        sink.append(v)

        epoch_evals = {}
        for name, state in (("baseline", base_state), ("aecf", aecf_state)):
            for mask_type, tag in (("none", "full"), ("images", "no_images"),
                                   ("texts", "no_texts")):
                m, f1, per_label = evaluate_model(
                    predict, state.params, val_data["image"],
                    val_data["text"], val_data["label"], mask_type,
                    config.eval_batch_size,
                )
                results[name][f"val_{tag}_map"].append(m)
                results[name][f"val_{tag}_f1"].append(f1)
                results[name][f"val_{tag}_f1_per_label"].append(per_label)
                epoch_evals[(name, tag)] = (m, f1)

        results["baseline"]["train_loss"].append(
            float(np.mean(base_losses)) if base_losses else 0.0)
        results["aecf"]["train_loss"].append(
            float(np.mean(aecf_losses)) if aecf_losses else 0.0)
        results["aecf"]["gate_entropy"].append(
            float(np.mean(epoch_entropies)) if epoch_entropies else 0.0)
        results["aecf"]["mask_rate"].append(
            float(np.mean(epoch_mask_rates)) if epoch_mask_rates else 0.0)

        if verbose:
            bm, bf = epoch_evals[("baseline", "full")]
            am, af = epoch_evals[("aecf", "full")]
            print(
                f"Epoch {epoch + 1:2d}: "
                f"Baseline mAP={bm:.4f}, F1={bf:.4f} | "
                f"AECF mAP={am:.4f}, F1={af:.4f}, "
                f"Entropy={results['aecf']['gate_entropy'][-1]:.4f}"
            )

    results["_states"] = {"baseline": base_state, "aecf": aecf_state}
    return results
