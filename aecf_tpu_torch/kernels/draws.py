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

The model families draw by the same rule (:class:`Draws`, ``docs/prng.md``):
a draw of a ``(rows, cols)`` block at site tag ``t`` takes word ``c % 4``
of Philox at counter ``(r, c // 4, t, 0)`` — the mask is tag 0 — and a
sub-key is a fold of the words.  On the card one launch of
``csrc/draws.cu`` computes either, reading the words from the card where
they are a ``(2,)`` int32 tensor (a CUDA graph's buffer); elsewhere the
same arithmetic runs in torch (:func:`uniforms_plain`), so the CPU's draws
are the card's bit for bit.  ``counted.launches`` and ``counted.bytes``
count the kernel's launches and the bytes they write and read.
"""

from __future__ import annotations

import ctypes
import functools
import math
import types
from typing import Optional, Tuple, Union

import torch

__all__ = [
    "Draws",
    "device_generator",
    "draw_key",
    "draw_seed_words",
    "fold_key",
    "fold_seed_words",
    "mask_and_renorm",
    "mask_uniforms",
    "philox4x32_10",
    "seed_words_of",
    "uniforms",
    "uniforms_plain",
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
    """A generator on ``device`` seeded from two seed words: the module
    API's attention dropout draws ``torch.bernoulli`` from it, so a caller
    hands over one CPU generator whatever the device."""
    g = torch.Generator(device=device)
    g.manual_seed((seed[0] << 32) | seed[1])
    return g


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


def uniforms_plain(seed: Tuple[int, int], rows: int, cols: int, *,
                   tag: int = 0, device=None) -> torch.Tensor:
    """(rows, cols) f32 uniforms of site ``tag``: ``(r, c)`` is word
    ``c % 4`` of Philox at counter ``(r, c // 4, tag, 0)`` keyed by the two
    seed words, as ``(bits >> 8) · 2⁻²⁴``."""
    groups = (cols + 3) // 4
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    grp = torch.arange(groups, dtype=torch.int64, device=device)[None, :]
    r, grp = torch.broadcast_tensors(r, grp)
    zero = torch.zeros_like(r)
    words = philox4x32_10((r, grp, zero + (int(tag) & _WORD), zero),
                          (seed[0], seed[1]))
    bits = torch.stack(words, dim=-1).reshape(rows, groups * 4)[:, :cols]
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def mask_uniforms(
    seed: Tuple[int, int], B: int, M: int, device=None
) -> torch.Tensor:
    """(B, M) f32 uniforms of the training mask: row ``b``, modality
    ``m`` is word ``m % 4`` of Philox at counter ``(b, m // 4, 0, 0)``
    (:func:`uniforms_plain` at tag 0)."""
    return uniforms_plain(seed, B, M, tag=0, device=device)


# ---- the model families' draws ------------------------------------------

# what the draw kernels did: launches, and bytes written and read
counted = types.SimpleNamespace(launches=0, bytes=0)

Key = Union[Tuple[int, int], torch.Tensor]


def _check_key_tensor(key: torch.Tensor) -> None:
    if tuple(key.shape) != (2,) or key.dtype != torch.int32:
        raise ValueError(
            f"seed words on a device are a (2,) int32 tensor, got "
            f"{key.dtype} {tuple(key.shape)}"
        )


def draw_key(source) -> Key:
    """The seed words a draw is keyed by: two words drawn from a
    ``torch.Generator`` (on the CPU; one on a card is read back), a seed
    (an int or two words) as its words, or a ``(2,)`` int32 words tensor
    as it is (a CUDA graph's buffer: read when the draw runs)."""
    if isinstance(source, torch.Tensor):
        _check_key_tensor(source)
        return source
    if isinstance(source, torch.Generator):
        if source.device.type == "cpu":
            return draw_seed_words(source)
        words = torch.randint(0, 2**32, (2,), generator=source,
                              device=source.device).tolist()
        return int(words[0]) & _WORD, int(words[1]) & _WORD
    return seed_words_of(source)


def _host_words(key: Key) -> Tuple[int, int]:
    if isinstance(key, torch.Tensor):
        a, b = key.tolist()
        return a & _WORD, b & _WORD
    return key


@functools.cache
def _library() -> ctypes.CDLL:
    from ._build import load_library
    from .shared_query import _bind_error_string

    lib = load_library("draws")
    p, i, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    lib.aecf_draw_uniforms.argtypes = [p, u32, u32, i, i, u32, p, p]
    lib.aecf_draw_uniforms.restype = ctypes.c_int
    lib.aecf_fold_words.argtypes = [p, u32, u32, u32, u32, p, p]
    lib.aecf_fold_words.restype = ctypes.c_int
    return _bind_error_string(lib)


def _key_args(key: Key, device: torch.device):
    """``(pointer, k0, k1)`` of the C entries: the words on the card by
    pointer, else by value."""
    if isinstance(key, torch.Tensor):
        if key.device.type != "cuda" or (
                device.index is not None and key.device.index != device.index):
            raise ValueError(
                f"seed words on {key.device} for a draw on {device}")
        return key.data_ptr(), 0, 0
    return None, key[0], key[1]


def _launched(lib, err: int, what: str, nbytes: int) -> None:
    from .shared_query import _raise_on_error

    _raise_on_error(lib, err, what)
    counted.launches += 1
    counted.bytes += nbytes


def uniforms(key: Key, rows: int, cols: int, *, tag: int = 0,
             device=None) -> torch.Tensor:
    """(rows, cols) f32 uniforms of site ``tag`` keyed by ``key``
    (:func:`draw_key`'s words) on ``device``: one launch of
    ``csrc/draws.cu`` on a card (it captures inside a CUDA graph),
    :func:`uniforms_plain` elsewhere — the same bits."""
    device = torch.device(device if device is not None else "cpu")
    if device.type != "cuda":
        return uniforms_plain(_host_words(key), rows, cols, tag=tag,
                              device=device)
    out = torch.empty((rows, cols), dtype=torch.float32, device=device)
    ptr, k0, k1 = _key_args(key, device)
    lib = _library()
    with torch.cuda.device(device):
        err = lib.aecf_draw_uniforms(
            ptr, k0, k1, rows, cols, int(tag) & _WORD, out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    _launched(lib, err, "draw_uniforms", out.nbytes + (8 if ptr else 0))
    return out


def fold_key(key: Key, n: int) -> Key:
    """``key``'s words folded with ``n`` (:func:`fold_seed_words`): host
    words for host words, a ``(2,)`` int32 tensor on the card, computed
    there in one launch, for words there."""
    if not isinstance(key, torch.Tensor):
        return fold_seed_words(key, n)
    if key.device.type != "cuda":
        return fold_seed_words(_host_words(key), n)
    out = torch.empty((2,), dtype=torch.int32, device=key.device)
    lib = _library()
    with torch.cuda.device(key.device):
        err = lib.aecf_fold_words(
            key.data_ptr(), 0, 0, n & _WORD, (n >> 32) & _WORD,
            out.data_ptr(), torch.cuda.current_stream(key.device).cuda_stream)
    _launched(lib, err, "fold_words", 16)
    return out


class Draws:
    """The draws of one forward, keyed by a step's seed words (``key``,
    :func:`draw_key`'s): site ``n`` (1, 2, … in call order) is either a
    block of uniforms at tag ``n`` (:meth:`uniforms`) or the sub-key
    ``fold_key(key, n)`` (:meth:`fork`, a pool's mask key).  So a forward's
    draws are a pure function of the step's words and of the order of its
    sites, on every device."""

    __slots__ = ("key", "sites")

    def __init__(self, key: Key):
        self.key = key
        self.sites = 0

    @classmethod
    def of(cls, source) -> Optional["Draws"]:
        """``source`` itself when it is a :class:`Draws`, None for None,
        else the draws keyed by :func:`draw_key` of it."""
        if source is None or isinstance(source, Draws):
            return source
        return cls(draw_key(source))

    def _site(self) -> int:
        self.sites += 1
        return self.sites

    def uniforms(self, rows: int, cols: int, device) -> torch.Tensor:
        return uniforms(self.key, rows, cols, tag=self._site(), device=device)

    def fork(self) -> Key:
        return fold_key(self.key, self._site())


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
