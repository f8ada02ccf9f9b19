"""Numerical-safety debug tooling: a scoped NaN check over every aten op,
and finiteness reports over a tree of tensors.

Port of :mod:`aecf_tpu.utils.debug`.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ._tree import tree_leaves_with_path

__all__ = ["debug_nans", "assert_finite", "tree_finite_report"]


class _NanCheck(TorchDispatchMode):
    """Raises ``FloatingPointError`` at the first aten op with a NaN in a
    floating output."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for _, t in tree_leaves_with_path(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and t.numel() and bool(torch.isnan(t).any())):
                raise FloatingPointError(
                    f"NaN in an output of {func} (debug_nans)"
                )
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """Within the block, any aten op — forward or backward, on any device
    — whose floating output holds a NaN raises ``FloatingPointError``
    naming the op (JAX's scoped ``jax_debug_nans``).  Each checked output
    costs a device sync.  The previous dispatch mode is back on exit,
    also when the block raises; ``enable=False`` checks nothing (it does
    not suspend an enclosing block).

    What it cannot see: the port's CUDA kernels run through ``ctypes``
    and write into tensors that aten allocated, so a NaN a kernel writes
    is caught at the first aten op that reads it, named by that op."""
    if not enable:
        yield
        return
    with _NanCheck():
        yield


def _floating(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point()
    dtype = getattr(leaf, "dtype", None)
    return dtype is not None and np.issubdtype(dtype, np.floating)


def _tensor(leaf) -> torch.Tensor:
    return leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
        np.asarray(leaf, dtype=np.float32))


def assert_finite(tree: Any, name: str = "tree") -> None:
    """Host-side finiteness check over a tree of tensors (waits for their
    values); raises ``FloatingPointError`` naming every leaf with a NaN or
    an infinity."""
    bad = [path for path, leaf in tree_leaves_with_path(tree)
           if _floating(leaf)
           and not bool(torch.isfinite(_tensor(leaf)).all())]
    if bad:
        raise FloatingPointError(
            f"non-finite values in {name}: {', '.join(bad)}"
        )


def tree_finite_report(tree: Any) -> dict:
    """Per-leaf ``{path: (finite_fraction, max_abs)}`` summary for
    debugging (``max_abs`` over the values with NaN as 0 and ±inf as the
    dtype's largest finite value)."""
    report = {}
    for path, leaf in tree_leaves_with_path(tree):
        if _floating(leaf):
            t = _tensor(leaf)
            report[path] = (
                int(torch.isfinite(t).sum()) / t.numel(),
                float(torch.nan_to_num(t).abs().max()),
            )
    return report
