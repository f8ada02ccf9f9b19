"""Shared pieces of the benchmark's tests: the ``card`` marker (tests that
need an NVIDIA card skip without one, deciding inside the fixture), and
the cells of ``BENCHMARK.json`` cut to sizes a CPU test run holds."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the shapes each cell is cut to on the CPU: traffic keys, then config keys
SMALL = {
    "ns-train-chunk": ({"batch": 64, "steps_per_call": 4, "warm_calls": 1},
                       {"embed_dim": 32, "num_classes": 5}),
    "x3-fit": ({"batch": 64, "store_rows": 1024, "scan_chunk": 4,
                "rate_chunks": 1}, {"embed_dim": 32, "num_classes": 5}),
    "vl-serve-open": ({"rate_per_s": 200, "pool_rows": 256,
                       "sample_requests": 64, "warm_s": 0.2},
                      {"img_dim": 48, "txt_dim": 24, "hidden_dim": 16,
                       "num_classes": 10}),
    "vl-serve-bulk": ({"request_rows": 64, "arrays": 2, "buckets": [8, 32],
                       "warm_requests": 1},
                      {"img_dim": 48, "txt_dim": 24, "hidden_dim": 16,
                       "num_classes": 10}),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cell's own sizes run there")
    return torch.device("cuda")


def small_cell(name: str):
    """Cell ``name`` (of ``BENCHMARK.json``, or one kept out of it), cut
    to :data:`SMALL`'s sizes."""
    from perfbench import spec

    cell = spec.any_cell(ROOT, name)
    traffic, config = SMALL[name]
    cell.traffic.update(traffic)
    cell.config.update(config)
    return cell
