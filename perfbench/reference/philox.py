"""The training mask's random bits, frozen: Philox4x32-10 keyed by a step's
two seed words, one counter a (row, group of four modalities), and the
fold of a run's seed with the step index.

A copy of the arithmetic the port documents for its kernels and their
plain versions, kept here so the yardstick does not move with the program.
Words live in int64 tensors or ints, masked to 32 bits.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

_WORD = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_FOLD = 0x464F4C44  # "FOLD": a fold's counters never meet the mask's

SeedLike = Union[int, Tuple[int, int]]


def seed_words(rng: SeedLike) -> Tuple[int, int]:
    """An int's low and high 32-bit words, or a pair of words as given."""
    if isinstance(rng, tuple):
        return int(rng[0]) & _WORD, int(rng[1]) & _WORD
    rng = int(rng)
    return rng & _WORD, (rng >> 32) & _WORD


def philox(counter, key):
    """Philox4x32-10 on four counter words and two key words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _WORD
            k1 = (k1 + _W1) & _WORD
        p0 = c0 * _M0
        p1 = c2 * _M1
        c0, c1, c2, c3 = (
            ((p1 >> 32) & _WORD) ^ c1 ^ k0,
            p1 & _WORD,
            ((p0 >> 32) & _WORD) ^ c3 ^ k1,
            p0 & _WORD,
        )
    return c0, c1, c2, c3


def fold(rng: SeedLike, step: int) -> Tuple[int, int]:
    """The seed words of update ``step`` of a run seeded ``rng``."""
    step = int(step)
    words = philox((step & _WORD, (step >> 32) & _WORD, _FOLD, 0),
                   seed_words(rng))
    return words[0], words[1]


def uniforms(seed: Tuple[int, int], B: int, M: int,
             device=None) -> torch.Tensor:
    """(B, M) uniforms in [0, 1): row ``b``, modality ``m`` is word
    ``m % 4`` of Philox at counter ``(b, m // 4, 0, 0)``, its top 24 bits
    over 2**24."""
    groups = (M + 3) // 4
    rows = torch.arange(B, dtype=torch.int64, device=device)[:, None]
    grp = torch.arange(groups, dtype=torch.int64, device=device)[None, :]
    rows, grp = torch.broadcast_tensors(rows, grp)
    zero = torch.zeros_like(rows)
    words = philox((rows, grp, zero, zero), (seed[0], seed[1]))
    bits = torch.stack(words, dim=-1).reshape(B, groups * 4)[:, :M]
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
