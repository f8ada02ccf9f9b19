"""The float32 matmul mode of the port, per call, and the TF32 rounding.

Port of the JAX package's ``jax.default_matmul_precision(precision)``
around its XLA path (``aecf_tpu/ops/__init__.py``,
``aecf_tpu/nn/modules.py``) and around the kernels' prologue and glue
(``aecf_tpu/kernels/shared_query.py``, ``_ctx_prec``):
:func:`matmul_precision` runs a block under the mode that ``precision``
names and gives the process its own mode back afterwards, so
``ops.fusion_pool``, ``MultimodalAttentionPool`` and the kernels'
wrappers share one rule.

:func:`round_tf32` is what the tensor cores do to an f32 operand at
``'default'`` (PTX ``cvt.rna.tf32.f32``), for the kernels' plain versions.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Optional

import torch

__all__ = ["PRECISIONS", "matmul_precision", "round_tf32"]

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

    Gradients are not covered: autograd's backward runs later, outside
    the block, at the process's mode, unless the backward enters the mode
    itself, as the kernels' autograd functions do.
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
