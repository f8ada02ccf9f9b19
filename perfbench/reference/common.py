"""What every plain reference shares: the product at a stated precision,
and the switch that keeps the card's float32 products in IEEE float32.

``'f32'`` is IEEE float32 (TF32 off); ``'tf32'`` lets cuBLAS use the TF32
tensor cores; ``'bf16'`` rounds both operands to bfloat16 and multiplies
in float32 — in the forward and in the backward alike.
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("f32", "tf32", "bf16")


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    return x.bfloat16().float() if precision == "bf16" else x


class _Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, precision):
        ctx.save_for_backward(a, b)
        ctx.precision = precision
        return _round(a, precision) @ _round(b, precision)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        p = ctx.precision
        g = _round(g, p)
        return g @ _round(b, p).T, _round(a, p).T @ g, None


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` (2-D) at ``precision``, its gradients at the same."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return _Product.apply(a, b, precision)


@contextlib.contextmanager
def matmul_mode(precision: str):
    """The process's float32 product mode for the block: TF32 for
    ``'tf32'``, IEEE float32 otherwise; the mode before is restored."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])
