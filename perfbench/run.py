"""The benchmark of the PyTorch + CUDA port (``aecf_tpu_torch``), one cell a
run.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for.  Prints one JSON line last on stdout: the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``,
``correct`` from the comparison with the plain reference, and each
compared number beside its limit (also the last lines on stderr).  Exits
non-zero, printing no result, without the cards, when a module of JAX or
of the JAX package is loaded, or on any failure.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    cache = ROOT / "build" / "perfbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    from perfbench import harness, spec

    cell = spec.load(ROOT, args.workload)
    try:
        result = harness.run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), T_START)
    except (harness.NoCard, harness.Forbidden) as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
