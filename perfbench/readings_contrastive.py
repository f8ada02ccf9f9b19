"""The readings of ``large-dp4-train``'s limits: ``perfbench/readings.py``
with the cell's third planted fault beside the other two, InfoNCE over
each shard's own targets (``local_negatives``).  Needs the cell's four
cards.

    python3 perfbench/readings_contrastive.py --workload large-dp4-train \\
        --seeds 8 --first-seed 5000000001 --faulty 3 --seconds 1
"""

import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from perfbench import readings

    readings.TRAINING_FAULTS = readings.TRAINING_FAULTS + ("local_negatives",)
    sys.exit(readings.main())
