"""The float32 matmul mode of the port, per call, and the TF32 rounding.

Port of the JAX package's ``jax.default_matmul_precision(precision)``
around its XLA path (``aecf_tpu/ops/__init__.py``,
``aecf_tpu/nn/modules.py``) and around the kernels' prologue and glue
(``aecf_tpu/kernels/shared_query.py``, ``_ctx_prec``):
:func:`matmul_precision` runs a block under the mode that ``precision``
names and gives the process its own mode back afterwards, so
``ops.fusion_pool``, ``MultimodalAttentionPool`` and the kernels'
wrappers share one rule.  :func:`run_at` runs a differentiable block
under that mode, forward and backward, as JAX binds the precision into
every dot it traces, the transposed dots of the gradient among them.

:func:`round_tf32` is what the tensor cores do to an f32 operand at
``'default'`` (PTX ``cvt.rna.tf32.f32``), for the kernels' plain versions.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, Iterator, Optional

import torch

__all__ = ["PRECISIONS", "matmul_precision", "process_precision",
           "round_tf32", "run_at"]

PRECISIONS = ("default", "high", "highest")

# torch's float32 matmul mode is one setting for the whole process, where
# JAX's context is per thread.  Blocks of every thread share one nesting
# count a mode: the first block to enter saves the process's mode, the
# last to leave restores it, and in between the most precise mode held
# wins ('highest' over TF32).
_lock = threading.Lock()
_depth: Dict[str, int] = {"highest": 0, "high": 0}
_saved: Optional[str] = None


def _mode_of(precision: str) -> str:
    """torch's name of the mode a precision runs at: ``'highest'`` (IEEE
    f32) or ``'high'`` (TF32 tensor cores on a CUDA card)."""
    return "highest" if precision == "highest" else "high"


def _apply() -> None:
    """Set the process to the mode the blocks held now ask for (under
    ``_lock``)."""
    if _depth["highest"]:
        torch.set_float32_matmul_precision("highest")
    elif _depth["high"]:
        torch.set_float32_matmul_precision("high")
    else:
        torch.set_float32_matmul_precision(_saved)


def process_precision() -> str:
    """The precision the process's float32 matmul mode runs at now:
    ``'highest'`` (IEEE f32) or ``'default'`` (TF32 tensor cores on a
    card) — for a call that follows the mode its caller set."""
    return ("highest" if torch.get_float32_matmul_precision() == "highest"
            else "default")


@contextlib.contextmanager
def matmul_precision(precision: str) -> Iterator[None]:
    """Run the block under the float32 matmul mode ``precision`` names.

    ``'highest'`` is IEEE f32 (no TF32), as JAX's ``HIGHEST``, whatever
    the process set (``torch.set_float32_matmul_precision``,
    ``torch.backends.cuda.matmul.allow_tf32``).  ``'default'`` and
    ``'high'`` are torch's ``'high'``: TF32 tensor cores for float32
    matmuls on a CUDA card, as JAX's ``DEFAULT`` runs them on an Ampere or
    Hopper GPU; the CPU computes them in IEEE f32 either way, as JAX's CPU
    backend does.  The process's mode is restored on exit, also when the
    block raises.

    More precise, never less: while any thread holds a ``'highest'`` block
    the process stays IEEE, and a ``'default'`` block nested in a
    ``'highest'`` one (or running beside it in another thread) does not
    lower it.  One nesting count a mode, shared by every thread: the first
    block to enter saves the process's mode and the last to leave restores
    it.  A thread that sets the mode itself meanwhile has its setting
    undone then.

    The block covers what runs inside it: autograd calls a backward
    later, outside it.  A differentiable block whose gradient must run at
    the same mode goes through :func:`run_at`; the kernels' autograd
    functions enter their forward's mode in their backward themselves.
    """
    global _saved
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision must be one of {PRECISIONS}, got {precision!r}"
        )
    mode = _mode_of(precision)
    with _lock:
        if not any(_depth.values()):
            _saved = torch.get_float32_matmul_precision()
        _depth[mode] += 1
        _apply()
    try:
        yield
    finally:
        with _lock:
            _depth[mode] -= 1
            _apply()


def _keeps_graph() -> bool:
    """Whether the backward running now keeps its graph
    (``retain_graph=True``); True where torch cannot say."""
    probe = getattr(torch._C._autograd, "_get_current_graph_task_keep_graph",
                    None)
    return True if probe is None else bool(probe())


class _RunAt(torch.autograd.Function):
    """``fn`` on detached copies of the inputs, its graph kept inside the
    node: the forward builds it under ``precision``'s mode, the backward
    differentiates it under the same mode, so the mode is entered and left
    within each of the two calls."""

    @staticmethod
    def forward(ctx, precision, fn, *tensors):
        ctx.set_materialize_grads(False)
        inner = tuple(
            t.detach().requires_grad_(t.requires_grad)
            if isinstance(t, torch.Tensor) else t
            for t in tensors
        )
        with torch.enable_grad(), matmul_precision(precision):
            outs = fn(*inner)
        ctx.single = isinstance(outs, torch.Tensor)
        outs = (outs,) if ctx.single else tuple(outs)
        ctx.precision = precision
        ctx.graph = (inner, outs)
        detached = tuple(
            o.detach() if isinstance(o, torch.Tensor) else o for o in outs
        )
        ctx.mark_non_differentiable(*(
            d for d, o in zip(detached, outs)
            if isinstance(o, torch.Tensor) and not o.requires_grad
        ))
        return detached[0] if ctx.single else detached

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        if ctx.graph is None:
            raise RuntimeError(
                "Trying to backward through the graph a second time; pass "
                "retain_graph=True to the first backward"
            )
        inner, outs = ctx.graph
        keep = _keeps_graph()
        if not keep:
            ctx.graph = None  # the inner graph goes with this call
        pairs = [
            (o, g) for o, g in zip(outs, grads)
            if g is not None and isinstance(o, torch.Tensor)
            and o.requires_grad
        ]
        wanted = [i for i, t in enumerate(inner)
                  if ctx.needs_input_grad[2 + i]]
        result = [None] * (2 + len(inner))
        if pairs and wanted:
            with matmul_precision(ctx.precision):
                got = torch.autograd.grad(
                    [o for o, _ in pairs], [inner[i] for i in wanted],
                    [g for _, g in pairs], retain_graph=keep,
                    allow_unused=True,
                )
            for i, g in zip(wanted, got):
                result[2 + i] = g
        return tuple(result)


def run_at(precision: str, fn: Callable[..., Any], *tensors: Any) -> Any:
    """``fn(*tensors)`` under :func:`matmul_precision` ``(precision)``,
    its gradient too: the backward re-enters the mode and leaves it before
    it returns — also after a backward that raises, or one taken with
    respect to some of the inputs only.

    ``fn`` returns a tensor or a tuple of tensors (None allowed); every
    tensor it differentiates must come through ``tensors`` (a tensor it
    closes over gets no gradient through the block).  Entries of
    ``tensors`` that are not tensors, None among them, pass through.
    Where nothing requires a gradient (``torch.no_grad()``, frozen
    inputs), it is ``fn`` inside the mode's block and nothing more.  The
    gradients are once differentiable.
    """
    if not torch.is_grad_enabled() or not any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors
    ):
        with matmul_precision(precision):
            return fn(*tensors)
    return _RunAt.apply(precision, fn, *tensors)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32, any device) rounded to TF32 as PTX
    ``cvt.rna.tf32.f32`` does: to nearest at bit 13 of the significand,
    ties away from zero, the low 13 bits cleared.  NaN, ±inf and ±0 are
    kept; a subnormal rounds like any other bit pattern, so it may carry
    into the smallest normal; a value that rounds past the largest finite
    TF32 becomes inf.  Computed on an int32 view: adding 2^12 to the
    magnitude's bits rounds half away from zero, and the mask truncates."""
    if x.dtype != torch.float32:
        raise TypeError(f"round_tf32 takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    mag = bits & 0x7FFFFFFF
    rounded = ((mag + 0x1000) & ~0x1FFF) | (bits & ~0x7FFFFFFF)
    keep = mag >= 0x7F800000  # NaN and ±inf as they are
    return torch.where(keep, bits, rounded).view(torch.float32)
