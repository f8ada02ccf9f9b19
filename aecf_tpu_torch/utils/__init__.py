"""Utilities: profiling and tracing hooks and debug helpers.

Port of :mod:`aecf_tpu.utils`: ``torch.profiler`` in place of
``jax.profiler``, a dispatch mode in place of ``jax_debug_nans``.
"""

from .debug import assert_finite, debug_nans, tree_finite_report
from .profiling import StepTimer, named_scope, trace

__all__ = [
    "assert_finite",
    "debug_nans",
    "tree_finite_report",
    "StepTimer",
    "named_scope",
    "trace",
]
