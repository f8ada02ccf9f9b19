"""The X-ray model's update counted from its shapes: the model's operations
a row, and the bytes its draws write and read.

The same work is counted whatever implements it: a later change to the
program moves the measured time, never these counts.
"""

from __future__ import annotations


def row_flops(image_dim: int, text_dim: int, hidden: int, modalities: int,
              num_classes: int) -> float:
    """Operations of one row of an update, forward and backward, every
    route computed densely: the two encoders at twice their forward's
    products (the features are frozen, so the backward forms their
    weights' gradients and no input gradient), and three times the
    forward's products of the rest — the pool's key and value projections
    of each modality, its scores and context, its out projection, the
    fusion, image and text routes, the classifier.  The query's
    projection, one a batch, is left out."""
    E, M = hidden, modalities
    encoders = image_dim * E + text_dim * E
    rest = (2 * M * E * E + 2 * M * E + E * E  # pool
            + 3 * E * 2 * E  # routes
            + 2 * E * E + E * num_classes)  # classifier
    return 2.0 * (2.0 * encoders + 3.0 * rest)


def draws_bytes(batch: int, hidden: int, modalities: int) -> float:
    """Bytes the draws of one update move: the missing-modality block
    ``(B, 3)``, three dropout blocks ``(B, E)`` and the curriculum mask's
    ``(B, M)`` uniforms written (4 bytes each), each launch's two seed
    words read, and the mask key's fold (two words read, two written)."""
    uniforms = batch * (3 + 3 * hidden + modalities)
    return float(4 * uniforms + 5 * 8 + 16)
