"""Which rows of an ``n``-row store make batch ``step``: epochs of ``n //
batch`` batches (the ragged tail dropped), epoch ``e``'s row order
``numpy.random.default_rng(seed + e).permutation(n)``."""

from __future__ import annotations

import numpy as np


def batch_rows(n: int, batch: int, seed: int, step: int) -> np.ndarray:
    epoch, pos = divmod(int(step), n // batch)
    order = np.random.default_rng(seed + epoch).permutation(n)
    return order[pos * batch:(pos + 1) * batch]
