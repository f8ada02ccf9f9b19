"""The readings of ``xray-aecf-train``'s limits: ``perfbench/readings.py``
with the cell's planted faults beside the loss over half of each batch and
the draws from other seed words: the missing-modality simulation off, and
a state left unchanged.

    python3 perfbench/readings_xray.py --workload xray-aecf-train \\
        --seeds 12 --first-seed 5000000001 --faulty 12 --seconds 1
"""

import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from perfbench import readings

    readings.TRAINING_FAULTS = readings.TRAINING_FAULTS + ("missing_off",
                                                           "unchanged")
    sys.exit(readings.main())
