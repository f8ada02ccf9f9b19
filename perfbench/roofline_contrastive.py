"""The work of one data-parallel contrastive update (BASELINE config 5) on
one card, counted from its shapes, and the link the cards share.

``B`` rows a card, ``N`` rows in the global batch, ``M`` modalities, width
``E``, projection width ``P``.  The same work is counted whatever
implements it; products run on the TF32 tensor cores under
``precision='default'`` (the f32 pipes at ``'highest'``), the rest at the
f32 peak.  Peaks are :mod:`perfbench.roofline`'s.
"""

from __future__ import annotations

from .roofline import Work, _products

# A card's NVLink, one direction: 18 links of 26.562 GB/s each, as
# `nvidia-smi nvlink --status` reads them on the four-card H100 machine
# (`nvidia-smi topo -m` does not run there), 478.1 GB/s; NVIDIA's H100 SXM
# data sheet gives 900 GB/s both directions, 450 each way.  The larger of
# the two, so that a share of it is never overstated.
NVLINK_BYTES_PER_S = 18 * 26.562e9


def pool_chain_work(B: int, M: int, E: int, precision: str) -> Work:
    """The pool's two-pass kernels for one update: the training forward
    chain (scores, softmax, entropy, mask, mix; ``out = mix W_voᵀ``) and
    the backward chain (the softmax recomputed, ``d_mix = d_out W_vo``, the
    softmax backward, ``G = d_outᵀ mix``, ``du``): kv read by each, W_vo
    read by each, G written; the prologue and epilogue products outside
    the chains are not counted here."""
    ee = E * E
    nbytes = 4 * (2 * B * M * E + 3 * ee + 3 * B * E + 6 * B * M + 4 * E)
    prod_f32, prod_tf32 = _products(6 * B * ee, precision)
    return (float(nbytes), float(12 * B * M * E + prod_f32), float(prod_tf32))


def update_work(B: int, N: int, M: int, E: int, P: int,
                precision: str) -> Work:
    """One update on one card: the pool chains (:func:`pool_chain_work`),
    the products that fold ``W_vo = Wo Wv`` and unfold its gradient into
    ``dWo`` and ``dWv`` (3 E³ products), the two projections and their
    gradients (five ``B×E×P`` products), the logits over every card's
    targets and their two gradients (three ``B×N×P`` products), the
    softmax cross-entropy over the logits, and AdamW over every
    parameter."""
    pool = pool_chain_work(B, M, E, precision)
    params = 4 * E * E + 5 * E + 2 * (E * P + P)
    products = 6 * E ** 3 + 10 * B * E * P + 6 * B * N * P
    prod_f32, prod_tf32 = _products(products, precision)
    f32 = 8 * B * N + 12 * params
    nbytes = 4 * (B * E + 3 * B * N + 8 * params)
    return (pool[0] + nbytes, pool[1] + f32 + prod_f32,
            pool[2] + prod_tf32)


def bus_bytes(counted, world: int) -> float:
    """Bytes on the link by NCCL's convention (its ``busbw``): an
    all-reduce of ``S`` bytes moves ``2(n-1)/n·S``, an all-gather or a
    reduce-scatter of ``S`` bytes in all ``(n-1)/n·S``, from the
    collectives' byte counters."""
    n = world
    share = (n - 1) / n
    return (2 * share * counted.get("collectives.all_reduce_bytes", 0)
            + share * counted.get("collectives.all_gather_bytes", 0)
            + share * counted.get("collectives.reduce_scatter_bytes", 0))


def nccl_s(trace) -> float:
    """The device seconds of a trace's NCCL kernels, their intervals
    merged."""
    total, end = 0.0, None
    for s, e in sorted((s, e) for n, s, e in trace.ops
                       if "nccl" in n.lower()):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total
