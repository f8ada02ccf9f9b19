"""The readings a cell's limits are set from, on the card, in one process:
for each seed, a short run of the cell and its compared numbers (the
program's: the lower readings); for the first ``--faulty`` seeds also the
control (the reference one precision down in the program's place) and, for
a training cell, the planted faults (half of each batch left out of the
loss; the masks drawn from other seed words) — the upper readings.  One
JSON line a reading.

    python3 perfbench/readings.py --workload ns-train-chunk \\
        --seeds 12 --first-seed 5000000001 --faulty 3 --seconds 1
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TRAINING_FAULTS = ("half_batch", "mask_altered")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--faulty", type=int, default=3)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from aecf_tpu_torch.measure import enable_persistent_cache
    from perfbench import harness, spec
    from perfbench.tracing import Tracer

    cell = spec.any_cell(ROOT, args.workload)
    enable_persistent_cache(str(harness.cache_dir(ROOT) / "kernels"))
    training = cell.traffic["driver"].startswith("train")
    for k in range(args.seeds):
        seed = args.first_seed + k
        t0 = time.perf_counter()
        run = harness._driver(cell, seed, torch.device("cuda"))
        run.setup()
        run.window(args.seconds, Tracer(False, 0, 0, dict))
        run.release()
        gc.collect()
        torch.cuda.empty_cache()
        kinds = ["program"]
        if k < args.faulty:
            kinds += ["control"] + (list(TRAINING_FAULTS) if training else [])
        for kind in kinds:
            numbers = run.check() if kind == "program" else run.reading(kind)
            print(json.dumps({"cell": cell.name, "seed": seed,
                              "reading": kind, "numbers": numbers,
                              "s": time.perf_counter() - t0}), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
