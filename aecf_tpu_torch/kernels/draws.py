"""The training mask's random bits and masking chain, in plain PyTorch.

The TPU kernels draw with ``pltpu.prng_random_bits``, which has no GPU
counterpart, so the port's draws cannot match the TPU's bit for bit
(``docs/prng.md``: parity is fixed-mask injection plus distribution
tests).  The CUDA kernels use Philox4x32-10 (``csrc/pool_common.cuh``);
this module computes the same bits in torch for their plain versions:

* key = the call's two 32-bit seed words (:func:`draw_seed_words`);
* counter of batch row ``b``, modality ``m`` = ``(b, m // 4, 0, 0)``, the
  draw is output word ``m % 4`` — so draws do not depend on a tile size,
  and the training forward and the one-pass step draw the same mask for
  the same seed;
* uniform = ``(bits >> 8) · 2⁻²⁴`` (the TPU kernel's 24-bit construction).

Torch has no full uint32 arithmetic: words live in int64 and are masked
with ``& 0xFFFFFFFF``.  The high word of a 32×32 product is
``(a·b >> 32) & 0xFFFFFFFF`` — int64 multiplication wraps and keeps bits
32-63.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

__all__ = [
    "device_generator",
    "draw_seed_words",
    "fold_seed_words",
    "generator_on",
    "mask_and_renorm",
    "mask_uniforms",
    "philox4x32_10",
    "seed_words_of",
]

_WORD = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
# aecf_tpu/core/masking.py EPS: the renormalisation's degenerate-row floor
_EPS = 1e-8


# The third counter word of a fold: "FOLD", so a fold's draws never meet
# the mask's counters (row, group, 0, 0).
_FOLD = 0x464F4C44

SeedLike = Union[int, Tuple[int, int]]


def seed_words_of(rng: SeedLike) -> Tuple[int, int]:
    """A run's seed as two 32-bit words: an int's low and high words, or a
    pair of words as given."""
    if isinstance(rng, tuple):
        if len(rng) != 2:
            raise ValueError(f"seed words are a pair, got {rng!r}")
        return int(rng[0]) & _WORD, int(rng[1]) & _WORD
    rng = int(rng)
    return rng & _WORD, (rng >> 32) & _WORD


def fold_seed_words(rng: SeedLike, step: int) -> Tuple[int, int]:
    """The seed words of update ``step`` of a run seeded ``rng``: Philox
    keyed by ``rng``'s words at counter ``(step low, step high, FOLD, 0)``,
    its first two words — the port's ``jax.random.fold_in(rng, step)``.
    A pure function of ``(rng, step)``, so a resumed run and every chunking
    of a run draw the masks of the uninterrupted run."""
    step = int(step)
    words = philox4x32_10(
        (step & _WORD, (step >> 32) & _WORD, _FOLD, 0), seed_words_of(rng)
    )
    return words[0], words[1]


def draw_seed_words(
    generator: Union[torch.Generator, Tuple[int, int], None],
) -> Tuple[int, int]:
    """Two 32-bit seed words from a CPU ``torch.Generator`` as host ints
    (no device sync), or the pair of words itself when one is given (a
    step's :func:`fold_seed_words`); ``(0, 0)`` without either, as the JAX
    ``_draw_seed_words`` gives zeros without a key."""
    if generator is None:
        return 0, 0
    if isinstance(generator, tuple):
        return seed_words_of(generator)
    if generator.device.type != "cpu":
        raise ValueError(
            "seed words come from a CPU torch.Generator, got one on "
            f"{generator.device}"
        )
    words = torch.randint(0, 2**32, (2,), generator=generator)
    return int(words[0]), int(words[1])


def device_generator(seed: Tuple[int, int], device) -> torch.Generator:
    """A generator on ``device`` seeded from two seed words — the torch
    paths' ``torch.bernoulli`` draws from it, so a caller hands over one
    CPU generator whatever the path and device."""
    g = torch.Generator(device=device)
    g.manual_seed((seed[0] << 32) | seed[1])
    return g


def generator_on(
    generator: Union[torch.Generator, Tuple[int, int], None], device
) -> Optional[torch.Generator]:
    """``generator`` itself when it lives on ``device``'s kind, else a
    generator on ``device`` seeded from two words drawn from it (or from
    the pair of seed words given in its place)."""
    if generator is None or (
        isinstance(generator, torch.Generator)
        and generator.device.type == torch.device(device).type
    ):
        return generator
    return device_generator(draw_seed_words(generator), device)


def philox4x32_10(counter, key):
    """Philox4x32-10 (Random123) on int64 tensors or ints holding uint32
    words: ``counter`` is four words, ``key`` two; returns four words."""
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


def mask_uniforms(
    seed: Tuple[int, int], B: int, M: int, device=None
) -> torch.Tensor:
    """(B, M) f32 uniforms of the training mask: row ``b``, modality
    ``m`` is word ``m % 4`` of Philox at counter ``(b, m // 4, 0, 0)``."""
    groups = (M + 3) // 4
    rows = torch.arange(B, dtype=torch.int64, device=device)[:, None]
    grp = torch.arange(groups, dtype=torch.int64, device=device)[None, :]
    rows, grp = torch.broadcast_tensors(rows, grp)
    zero = torch.zeros_like(rows)
    words = philox4x32_10((rows, grp, zero, zero), (seed[0], seed[1]))
    bits = torch.stack(words, dim=-1).reshape(B, groups * 4)[:, :M]
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def mask_and_renorm(
    w: torch.Tensor,  # (B, M) head-averaged weights
    entropy: torch.Tensor,  # (B,) clipped entropy
    uniforms: torch.Tensor,  # (B, M)
    *,
    mask_prob: float,
    min_active: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Port of ``_mask_and_renorm``: Bernoulli ``uniform < keep`` →
    whole-row ``min_active`` replacement (unrolled argmax, first occurrence
    wins ties) → renormalisation with the ``<= 1e-8`` fallback to ``w``.
    Returns ``(masked weights, rate (B,), mask)``."""
    B, M = w.shape
    max_entropy = math.log(M)
    norm_entropy = (entropy / max_entropy).clamp(0.0, 1.0)
    keep = (1.0 - mask_prob * norm_entropy).clamp(0.0, 1.0)
    mask = (uniforms < keep[:, None]).to(torch.float32)

    eff = min(int(min_active), M)
    needs_more = mask.sum(dim=-1, keepdim=True) < eff
    col = torch.arange(M, device=w.device).expand(B, M)
    work = w
    indicator = torch.zeros_like(w)
    for _ in range(eff):
        is_max = work == work.amax(dim=-1, keepdim=True)
        first_idx = torch.where(is_max, col, M).amin(dim=-1, keepdim=True)
        first = col == first_idx
        indicator = torch.where(first, 1.0, indicator)
        work = torch.where(first, -math.inf, work)
    mask = torch.where(needs_more, indicator, mask)

    masked = w * mask
    msum = masked.sum(dim=-1, keepdim=True)
    valid = msum > _EPS
    mw = torch.where(valid, masked / torch.where(valid, msum, 1.0), w)
    rate = 1.0 - mask.sum(dim=-1) / M  # the kernel's order: exact
    return mw, rate, mask
