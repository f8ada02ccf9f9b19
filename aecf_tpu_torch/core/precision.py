"""The float32 matmul mode of the torch path, per call.

Port of the JAX package's ``jax.default_matmul_precision(precision)``
around its XLA path (``aecf_tpu/ops/__init__.py``,
``aecf_tpu/nn/modules.py``): :func:`matmul_precision` runs a block under
the mode that ``precision`` names and gives the process its own mode back
afterwards, so ``ops.fusion_pool`` and ``MultimodalAttentionPool`` share
one rule.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional

import torch

__all__ = ["PRECISIONS", "matmul_precision"]

PRECISIONS = ("default", "high", "highest")

# torch's float32 matmul mode is one setting for the whole process, where
# JAX's context is per thread: 'highest' blocks of every thread share one
# nesting count, so the first to enter saves the process's mode and the
# last to leave restores it.
_lock = threading.Lock()
_depth = 0
_saved: Optional[str] = None


@contextlib.contextmanager
def matmul_precision(precision: str) -> Iterator[None]:
    """Run the block under the float32 matmul mode ``precision`` names.

    ``'highest'`` is IEEE f32 (no TF32), as JAX's ``HIGHEST``, whatever
    the process set (``torch.set_float32_matmul_precision``,
    ``torch.backends.cuda.matmul.allow_tf32``).  ``'high'`` and
    ``'default'`` keep the process's own setting for now: their mapping
    to TF32 or bf16 tensor cores is settled with the kernels' tensor-core
    work (ROADMAP.md, queue 2, item 4).  The process's mode is restored on
    exit, also when the block raises.

    What it does not cover:

    - Gradients.  Autograd's backward runs later, outside the block, at
      the process's mode: a ``'highest'`` forward under TF32 computes its
      gradients in TF32.
    - Other threads.  The mode is the process's, so while any thread is in
      a ``'highest'`` block every thread's float32 matmuls run in IEEE f32
      (more precise, never less); the last thread to leave restores the
      mode that the first one found.  A thread that sets the mode itself
      meanwhile has its setting undone then.
    """
    global _depth, _saved
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision must be one of {PRECISIONS}, got {precision!r}"
        )
    if precision != "highest":
        yield
        return
    with _lock:
        if _depth == 0:
            _saved = torch.get_float32_matmul_precision()
            torch.set_float32_matmul_precision("highest")
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0:
                torch.set_float32_matmul_precision(_saved)
