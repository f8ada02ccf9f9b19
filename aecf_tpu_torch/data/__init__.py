"""Data pipelines: the native batch loader, pathology report mining,
synthetic feature generation, and quantized feature stores.

Port of :mod:`aecf_tpu.data`, with the same ten exports.
"""

from .loader import BatchLoader, build_native, native_available, quantize_rows
from .pathology import (
    NEGATION_PATTERNS,
    check_pathology_presence,
    find_single_pathology_cases,
    load_xray_parquet,
)
from .synthetic import XRAY_PATHOLOGY_NAMES, make_synthetic_clip_features

__all__ = [
    "BatchLoader",
    "build_native",
    "native_available",
    "quantize_rows",
    "NEGATION_PATTERNS",
    "check_pathology_presence",
    "find_single_pathology_cases",
    "load_xray_parquet",
    "XRAY_PATHOLOGY_NAMES",
    "make_synthetic_clip_features",
]
