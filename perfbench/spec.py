"""The benchmark's data: ``BENCHMARK.json`` at the checkout's root, and the
files it names, found by name — a configuration's file
(``configs[].file``), a traffic mix's (``traffic/<mix>.json``), a cell's
limits (``limits/<cell>.json``), a per-layer metric's reader
(``metrics/<metric>.py``).  Adding a cell, a configuration, a mix or a
metric adds files and entries and edits none."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    root: Path  # the checkout
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]  # the cell's end-to-end metrics
    per_layer: List[Dict]  # the cell's per-layer metrics
    chips: int


def _reports(metric: Dict, cell: str, e2e_names: List[str]) -> bool:
    """A per-layer metric is read in the cells it lists, or without a list
    in every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def load(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {', '.join(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    pb = root / bench["paths"][0]
    traffic = json.loads((pb / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((pb / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _reports(m, workload, names)]
    return Cell(workload, root, config, traffic, limits["limits"], e2e,
                per_layer, int(w["chips"]))


# Cells whose files the benchmark keeps while BENCHMARK.json does not hold
# them (their end-to-end metric spread wider than a bound may; PERF.md §7):
# the configuration's file, the mix, the end-to-end metrics.
KEPT_OUT = {
    "vl-serve-open": ("configs/aecf-vl-r50-bert.json", "open-poisson-1to16",
                      ["serve_p95_ms", "ms"]),
    "x3-fit": ("configs/aecf-clipb32-c14.json", "fit-store-2p18-k8",
               ["fit_samples_per_s", "samples/s"]),
}


def any_cell(root: Path, workload: str) -> Cell:
    """The cell of ``BENCHMARK.json``, or one kept out of it, from its
    files (``limits/<cell>.json`` beside its configuration and mix)."""
    if workload not in KEPT_OUT:
        return load(root, workload)
    config_file, traffic, (metric, unit) = KEPT_OUT[workload]
    pb = root / "perfbench"
    read = lambda path: json.loads(path.read_text())  # noqa: E731
    return Cell(workload, root, read(pb / config_file),
                read(pb / "traffic" / f"{traffic}.json"),
                read(pb / "limits" / f"{workload}.json")["limits"],
                [{"name": metric, "unit": unit},
                 {"name": "setup_s", "unit": "s"}], [], 1)


def reader(root: Path, metric: str) -> Callable:
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    path = root / bench["paths"][0] / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
