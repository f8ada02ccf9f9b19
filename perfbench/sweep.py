"""Find the open loop's knee once, on the card: one process, one set-up,
the mix sent at each of a list of rates for a few seconds each, printing
latency percentiles, the rate answered, failures and how late the sender
ran.  The knee is the highest rate answered without a growing backlog; the
mix's ``rate_per_s`` is set to about four fifths of it.

    python3 perfbench/sweep.py --seed 1 --seconds 10 \\
        --rates 500,1000,2000,4000
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--rates", required=True)
    p.add_argument("--repeat", type=int, default=1,
                   help="windows at each rate, back to back")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import harness, spec
    from perfbench.drivers.serve_open import schedule
    from perfbench.tracing import Tracer

    cell = spec.any_cell(ROOT, "vl-serve-open")
    from aecf_tpu_torch.measure import enable_persistent_cache

    enable_persistent_cache(str(harness.cache_dir(ROOT) / "kernels"))
    run = harness._driver(cell, args.seed, torch.device("cuda"))
    run.setup()
    gc.collect()
    gc.freeze()
    rates = [float(r) for r in args.rates.split(",")
             for _ in range(args.repeat)]
    for k, rate in enumerate(rates):
        run.t["rate_per_s"] = rate
        t0 = time.perf_counter()
        sched = schedule(run.t, args.seconds, args.seed + k)
        res = run._loop(sched, Tracer(False, 0, 0, dict), set())
        wall = time.perf_counter() - t0
        lat = np.sort(res["latency"])
        n = len(lat)
        line = {"rate_per_s": rate, "requests": n, "failed": res["failed"],
                "answered_per_s": n / wall,
                "p50_ms": float(lat[n // 2] * 1e3),
                "p95_ms": float(lat[int(np.ceil(0.95 * n)) - 1] * 1e3),
                "p99_ms": float(lat[int(np.ceil(0.99 * n)) - 1] * 1e3),
                "late_p99_ms": float(np.quantile(res["late"], 0.99) * 1e3),
                "drain_s": wall - res["seconds"],
                # p95 of each fifth of the window, in ms
                "p95_fifths_ms": [
                    float(np.quantile(res["latency"][part], 0.95) * 1e3)
                    for part in np.array_split(
                        np.argsort(sched["due"]), 5)]}
        print(json.dumps(line), flush=True)
    run.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
