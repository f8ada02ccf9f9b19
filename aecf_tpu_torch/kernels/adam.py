"""Adam and AdamW over all of an optimizer's leaves in one pass
(``csrc/adam.cu``): p, g, m and v read once and p, m and v written once.

The JAX package leaves the optimizer to optax
(``aecf_tpu/train/pool_step.py``), so the kernel replaces no TPU kernel;
it takes the place of ``torch.optim.AdamW(capturable=True)``'s foreach
branch, nine passes over the parameter-sized tensors (88 bytes an element
against the 28 an update needs) and two launches a leaf for its divisions
by one-element tensors.  Its arithmetic is that branch's, in its order,
so the two agree bit for bit on the card.

:func:`adam_step` takes lists of tensors: CUDA tensors launch the kernel
(two launches for up to 40 leaves), CPU tensors run
:func:`adam_step_plain`, the same order of operations in PyTorch.
:func:`supports_adam` says whether an optimizer's ``step()`` may be
replaced by :func:`adam_optimizer_step`, which creates missing state as
torch does and updates the optimizer's own state in place, so
``state_dict()``, checkpoints and a later ``optimizer.step()`` carry on
unchanged.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.optim.optimizer as _torch_optimizer

from ._build import load_library
from .shared_query import _bind_error_string, _raise_on_error

__all__ = [
    "AdamHyper",
    "adam_optimizer_step",
    "adam_step",
    "adam_step_plain",
    "supports_adam",
]


@dataclasses.dataclass(frozen=True)
class AdamHyper:
    """One param group's hyperparameters, as Python numbers;
    ``decoupled``: AdamW's decay of the parameters, else Adam's L2 term
    added to the gradient."""

    lr: float
    beta1: float
    beta2: float
    eps: float
    weight_decay: float
    decoupled: bool


def _reciprocal(x: float) -> float:
    """``1 / x`` in double as ATen takes it: a signed infinity at zero (an
    LR schedule that reaches 0), where the step size then comes out as
    ``-0`` and p is left as it was."""
    return 1 / x if x else math.copysign(math.inf, x)


def adam_step_plain(params: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor],
                    exp_avgs: Sequence[torch.Tensor],
                    exp_avg_sqs: Sequence[torch.Tensor],
                    steps: Sequence[torch.Tensor],
                    hypers: Sequence[AdamHyper]) -> None:
    """:func:`adam_step` in PyTorch, leaf by leaf in torch's capturable
    order: the step count incremented, the step size ``1 / ((β1^t − 1) ·
    (1 / lr))`` (ATen's foreach division by a number multiplies by its
    reciprocal) and ``sqrt(−(β2^t − 1))`` as one-element tensors, then
    ``p ·= 1 − lr·wd`` (AdamW) or ``g + wd·p`` (Adam), ``m.lerp_(g, 1 −
    β1)``, ``v·β2 + (1 − β2)·g·g`` and ``p += m / ((sqrt(v) / c2 + eps) /
    step size)``."""
    with torch.no_grad():
        for p, g, m, v, t, h in zip(params, grads, exp_avgs, exp_avg_sqs,
                                    steps, hypers):
            t.add_(1)
            step_size = torch.pow(h.beta1, t).sub_(1)
            step_size.mul_(_reciprocal(h.lr))
            step_size.reciprocal_()
            c2 = torch.pow(h.beta2, t).sub_(1).neg_().sqrt_()
            if h.weight_decay != 0:
                if h.decoupled:
                    p.mul_(1 - h.lr * h.weight_decay)
                else:
                    g = g.add(p, alpha=h.weight_decay)
            m.lerp_(g, 1 - h.beta1)
            v.mul_(h.beta2).addcmul_(g, g, value=1 - h.beta2)
            p.addcdiv_(m, v.sqrt().div_(c2).add_(h.eps).div_(step_size))


def _check(params, grads, exp_avgs, exp_avg_sqs, steps, hypers) -> int:
    n = len(params)
    if n < 1 or any(len(x) != n for x in (grads, exp_avgs, exp_avg_sqs,
                                           steps, hypers)):
        raise ValueError(
            "params, grads, exp_avgs, exp_avg_sqs, steps and hypers must be "
            "lists of one length, at least 1")
    dev = params[0].device
    for i, (p, *rest) in enumerate(zip(params, grads, exp_avgs,
                                       exp_avg_sqs)):
        for t in (p, *rest):
            if (t.dtype != torch.float32 or t.layout != torch.strided
                    or not t.is_contiguous() or t.device != dev
                    or t.shape != p.shape):
                raise ValueError(
                    f"leaf {i}: p, g, m and v must be contiguous float32 "
                    f"tensors of one shape on {dev}, got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
        if (steps[i].dtype != torch.float32 or steps[i].numel() != 1
                or steps[i].device != dev):
            raise ValueError(
                f"leaf {i}: the step must be one float32 on {dev}, got "
                f"{steps[i].dtype} {tuple(steps[i].shape)} on "
                f"{steps[i].device}")
    return n


def adam_step(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
              exp_avgs: Sequence[torch.Tensor],
              exp_avg_sqs: Sequence[torch.Tensor],
              steps: Sequence[torch.Tensor],
              hypers: Sequence[AdamHyper]) -> None:
    """One Adam or AdamW update of every leaf ``params[i]`` (float32,
    contiguous) from its gradient ``grads[i]``, its moments ``exp_avgs[i]``
    and ``exp_avg_sqs[i]`` and its step count ``steps[i]`` (one float32),
    under ``hypers[i]``, all in place.

    CPU tensors run :func:`adam_step_plain`; CUDA tensors launch the
    kernel on the current stream (it captures inside a CUDA graph) or
    raise; the step's scalars pass between the kernel's two launches
    through a buffer of two floats a leaf, allocated on each call (under a
    capture, from the graph's own pool).  ``adam_step.launches`` counts the
    kernel's launches (the plain version does not count)."""
    n = _check(params, grads, exp_avgs, exp_avg_sqs, steps, hypers)
    dev = params[0].device
    if dev.type == "cpu":
        adam_step_plain(params, grads, exp_avgs, exp_avg_sqs, steps, hypers)
        return
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    scratch = torch.empty((2 * n,), dtype=torch.float32, device=dev)
    ptrs = np.array([[t.data_ptr() for t in leaf] for leaf in zip(
        params, grads, exp_avgs, exp_avg_sqs, steps)], dtype=np.uint64)
    sizes = np.array([p.numel() for p in params], dtype=np.int64)
    # the Python numbers in double, then rounded to f32 once, as ATen takes
    # a Scalar into a float kernel
    hyper = np.array([[_reciprocal(h.lr), h.beta1, h.beta2, 1 - h.beta1,
                       1 - h.beta2, h.eps, h.weight_decay,
                       1 - h.lr * h.weight_decay] for h in hypers],
                     dtype=np.float64).astype(np.float32)
    flags = np.array([int(h.weight_decay != 0) | int(h.decoupled) << 1
                      for h in hypers], dtype=np.int32)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.aecf_adam_step(
            n, ptrs.ctypes.data, sizes.ctypes.data, hyper.ctypes.data,
            flags.ctypes.data, scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on_error(lib, err, "adam_step")
    adam_step.launches += 2 * -(-n // lib.aecf_adam_max_leaves())
    # written through their pointers: autograd's in-place checks see it
    torch.autograd.graph.increment_version(
        [*params, *exp_avgs, *exp_avg_sqs, *steps])


adam_step.launches = 0


def _dense_f32(t: torch.Tensor, device: torch.device,
               contiguous: bool = True) -> bool:
    return (t.dtype == torch.float32 and t.layout == torch.strided
            and (t.is_contiguous() or not contiguous) and t.device == device)


def _number(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def _step_dtype() -> torch.dtype:
    """The dtype torch gives a new capturable state's step."""
    return (torch.float64 if torch.get_default_dtype() == torch.float64
            else torch.float32)


def _refusal(optimizer: torch.optim.Optimizer) -> Optional[str]:
    """Why :func:`adam_optimizer_step` may not take ``optimizer.step()``'s
    place, or None (:func:`supports_adam`)."""
    if type(optimizer) not in (torch.optim.Adam, torch.optim.AdamW):
        return "not exactly torch.optim.Adam or AdamW"
    own = vars(optimizer).get("step")
    if own is not None and not getattr(own, "_wrapped_by_lr_sched", False):
        return "a step of its own"
    if (optimizer._optimizer_step_pre_hooks
            or optimizer._optimizer_step_post_hooks
            or _torch_optimizer._global_optimizer_pre_hooks
            or _torch_optimizer._global_optimizer_post_hooks):
        return "step hooks"
    if (getattr(optimizer, "grad_scale", None) is not None
            or getattr(optimizer, "found_inf", None) is not None):
        return "gradient scaling"
    groups = optimizer.param_groups
    for flag in ("amsgrad", "maximize", "differentiable", "fused"):
        if any(g.get(flag) for g in groups):
            return flag
    if any(g.get("foreach") is False for g in groups):
        return "foreach=False"
    for key in ("lr", "betas", "eps", "weight_decay"):
        if not all(_number(x) for g in groups for x in (
                g[key] if key == "betas" else (g[key],))):
            return f"{key} not Python numbers"
    device = None
    for group in groups:
        for p in group["params"]:
            if p.grad is None:
                continue
            device = p.device if device is None else device
            if (not _dense_f32(p, device)
                    or not _dense_f32(p.grad, device, contiguous=False)
                    or p.grad.shape != p.shape):
                return "a leaf or gradient not dense float32"
            state = optimizer.state.get(p)
            if not state:
                if _step_dtype() != torch.float32:
                    return "a new step would not be float32"
                continue
            t = state["step"] if set(state) == {
                "step", "exp_avg", "exp_avg_sq"} else None
            if (t is None or not torch.is_tensor(t) or t.numel() != 1
                    or t.dtype != torch.float32 or t.device != device
                    or not all(_dense_f32(state[k], device)
                               and state[k].shape == p.shape
                               for k in ("exp_avg", "exp_avg_sq"))):
                return "state not dense contiguous float32"
    if device is None:
        return "no gradients"
    if not all(g.get("capturable") for g in groups):
        return "capturable=False"
    if device.type != "cuda":
        return f"no kernel for device {device}"
    return None


def supports_adam(optimizer: torch.optim.Optimizer) -> bool:
    """Whether :func:`adam_optimizer_step` may take ``optimizer.step()``'s
    place: ``optimizer`` is exactly ``torch.optim.Adam`` or ``AdamW``,
    with no step hooks, no ``step`` of its own (an LR scheduler's
    step-tracking wrapper aside) and no gradient scaling; no group is
    ``amsgrad``, ``maximize``, ``differentiable``, ``fused`` or
    ``foreach=False``, every group is ``capturable``, with ``lr``,
    ``betas``, ``eps`` and ``weight_decay`` Python numbers; and some leaf
    has a gradient, and every leaf that has one and its state are dense,
    contiguous float32 tensors on one CUDA device (the step one float32),
    its gradient a float32 tensor of its shape there, of any strides."""
    return _refusal(optimizer) is None


def adam_optimizer_step(optimizer: torch.optim.Optimizer) -> None:
    """``optimizer.step()`` of an optimizer that :func:`supports_adam`
    takes, through :func:`adam_step` on the optimizer's own state: a leaf
    without state gets it as torch's ``_init_group`` makes it (``step`` a
    zero float32 on the leaf's device, ``exp_avg`` and ``exp_avg_sq``
    ``zeros_like`` in ``preserve_format``); the leaves without a gradient
    are left alone.  A gradient that is not contiguous (a product's
    transposed result) is read through a contiguous copy."""
    leaves: List[List] = [[], [], [], [], [], []]
    for group in optimizer.param_groups:
        beta1, beta2 = group["betas"]
        # an older torch's AdamW, a class of its own, lacks the key
        decoupled = group.get("decoupled_weight_decay",
                              type(optimizer) is torch.optim.AdamW)
        hyper = AdamHyper(group["lr"], beta1, beta2, group["eps"],
                          group["weight_decay"], decoupled)
        for p in group["params"]:
            if p.grad is None:
                continue
            state = optimizer.state[p]
            if len(state) == 0:
                state["step"] = torch.zeros((), dtype=_step_dtype(),
                                            device=p.device)
                state["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
            grad = p.grad if p.grad.is_contiguous() else p.grad.contiguous()
            for into, t in zip(leaves, (p, grad, state["exp_avg"],
                                        state["exp_avg_sq"], state["step"],
                                        hyper)):
                into.append(t)
    if vars(optimizer).get("step") is not None:
        optimizer._opt_called = True  # what the scheduler's wrapper records
    adam_step(*leaves)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("adam")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aecf_adam_step.argtypes = [i, p, p, p, p, p, p]
    lib.aecf_adam_step.restype = ctypes.c_int
    lib.aecf_adam_max_leaves.argtypes = []
    lib.aecf_adam_max_leaves.restype = ctypes.c_int
    return _bind_error_string(lib)
