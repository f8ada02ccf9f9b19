"""The omni late-fusion update counted from its shapes: the operations
the update's mathematics needs, and the bytes the streamed split must
move.

The same work is counted whatever implements it: a later change to the
program moves the measured time, never these counts.
"""

from __future__ import annotations


def update_work(batch: int, modalities: int, embed: int,
                classes: int) -> float:
    """Operations of one update of the pool classifier at one shared query
    (H = 1), forward and backward: the pool's value and output projections
    of the pooled mix (two ``B·E·E`` products) and the head (``B·E·C``),
    each three times its forward's products (the input's and the weight's
    gradients beside it); the scores and the mix over the modalities, and
    in the backward their weight-side products (the features are frozen:
    no gradient reaches them).  The query's projections, a few ``E·E``
    products a batch, are left out."""
    B, M, E, C = batch, modalities, embed, classes
    products = 3.0 * (2 * 2 * B * E * E + 2 * B * E * C)
    rows = 2.0 * (2 * B * M * E) + 2.0 * (2 * B * M * E)
    return products + rows


def stream_bytes(batch: int, modalities: int, embed: int,
                 mix_bytes: int = 2) -> float:
    """Bytes the streamed split must move in one update at H = 1: the f32
    features read by the forward and again by the backward, the mix
    written and its cotangent ``d_mix`` read at their stored width (bf16,
    2 bytes, at ``precision='default'``), the forward's weights, masked
    weights, entropy and rate written and the backward's weights cotangent
    read (f32).  ``u``, ``c`` and the backward's partial sums, under a
    megabyte, are left out."""
    B, M, E = batch, modalities, embed
    kv = 2 * 4 * B * M * E
    mix = 2 * mix_bytes * B * E
    rows = 4 * (2 * B * M + 2 * B) + 4 * B * M
    return float(kv + mix + rows)
