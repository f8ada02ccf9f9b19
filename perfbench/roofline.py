"""The yardstick's arithmetic: the card's published peaks, the least time
a piece of work can take on it, and the work of each measured function
counted from its shapes.

The same work is counted whatever implements it: a later change to the
program moves the measured time, never these counts.  Frozen copies of the
port's ``chip_smoke._bound`` and of its work tuples (the one-pass step's,
the shared-query forward's).
"""

from __future__ import annotations

from typing import Tuple

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12

Work = Tuple[float, float, float]  # (bytes, f32 operations, TF32 operations)


def bound_s(work: Work) -> Tuple[float, str]:
    """``(seconds, "bytes" | "operations")``: the least time the card could
    take for ``work``, the larger of the bytes' time and the operations'
    (each type of operation at its own peak, summed)."""
    nbytes, flops, tf32_flops = work
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS + tf32_flops / TF32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ops_s(work: Work) -> float:
    """The operations of ``work`` alone at peak, each type at its own."""
    _, flops, tf32_flops = work
    return flops / F32_FLOPS + tf32_flops / TF32_FLOPS


def _products(ops: float, precision: str) -> Tuple[float, float]:
    """``(f32, TF32)`` operations of the E×E products: the TF32 tensor cores
    at ``precision='default'``, the f32 pipes at ``'highest'``."""
    return (0.0, ops) if precision == "default" else (ops, 0.0)


def step_work(B: int, M: int, E: int, C: int, precision: str,
              kv_bytes: int = 4) -> Work:
    """One update of the one-pass pool step with a C-class linear head
    (``train_step.cu``): kv read once; the row kernels' f32 operations; the
    out, logits, ``d_out``, ``d_mix``, G and dW_head products."""
    ee = E * E
    nbytes = (B * M * E * kv_bytes
              + 4 * (2 * ee + 4 * E + 2 * E * C + 2 * C + B * C
                     + 2 * B * M + 2 * B + 3))
    f32 = 4 * B * E * C + 8 * B * M * E
    prod_f32, prod_tf32 = _products(6 * B * ee + 2 * B * E * C, precision)
    return (float(nbytes), float(f32 + prod_f32), float(prod_tf32))


def fwd_chain_work(B: int, M: int, E: int, precision: str,
                   kv_bytes: int = 4) -> Work:
    """One eval call of the shared-query forward chain at H = 1
    (``shared_query_fwd.cu``): kv read once, the row kernel's operations,
    the out product."""
    ee = E * E
    nbytes = B * M * E * kv_bytes + 4 * (ee + 3 * E + 1 + B * E
                                         + 2 * B * M + 2 * B)
    prod_f32, prod_tf32 = _products(2 * B * ee, precision)
    return (float(nbytes), float(4 * B * M * E + prod_f32), float(prod_tf32))


def vl_row_flops(img_dim: int, txt_dim: int, hidden: int,
                 num_classes: int) -> float:
    """Operations of one row of the vision-language forward: the two
    encoders' projections, the pool's per-row work (the shared-query
    chain's, M = 2), the classifier."""
    encoders = 2 * img_dim * hidden + 2 * txt_dim * hidden
    pool = 4 * 2 * hidden + 2 * hidden * hidden
    return float(encoders + pool + 2 * hidden * num_classes)

