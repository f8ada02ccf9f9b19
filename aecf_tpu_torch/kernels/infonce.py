"""InfoNCE's softmax cross-entropy over rows of logits, and its gradient
with respect to the raw product, in one kernel (``csrc/infonce.cu``).

The JAX package leaves this loss to XLA (``examples/train_contrastive.py``:
``z @ t_all.T / τ`` and optax's integer-label softmax cross-entropy), so
the kernel replaces no TPU kernel; it takes the place of ATen's division,
log-softmax, NLL and their backward, about a dozen passes over the ``(B,
N)`` logits, with one read of the raw product and one write of its
gradient.  :func:`infonce_rows` launches it for CUDA tensors and runs
:func:`infonce_rows_plain`, the same arithmetic in PyTorch, for CPU
tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library
from .shared_query import _bind_error_string, _raise_on_error

__all__ = ["infonce_rows", "infonce_rows_plain"]


def _check(raw: torch.Tensor, label_offset: int) -> None:
    if raw.ndim != 2 or raw.dtype != torch.float32:
        raise ValueError(
            f"raw must be a (B, N) float32 tensor, got {raw.dtype} "
            f"{tuple(raw.shape)}"
        )
    if not raw.is_contiguous():
        raise ValueError("raw must be contiguous")
    B, N = raw.shape
    if B < 1 or N < 1 or label_offset < 0 or label_offset + B > N:
        raise ValueError(
            f"the labels label_offset + b of rows b < B must lie in [0, N): "
            f"got label_offset={label_offset}, B={B}, N={N}"
        )
    if N >= 2**31:
        raise ValueError(f"rows of N < 2**31, got N={N}")


def infonce_rows_plain(raw: torch.Tensor, *, label_offset: int,
                       temperature: float, scale: float) -> torch.Tensor:
    """:func:`infonce_rows` in PyTorch, in the kernel's order of
    operations (ATen's for the same route): with ``x = raw / τ``, ``o =
    (x − max x) − log Σ exp(x − max x)``, row ``b``'s loss is
    ``−o[label] · scale`` (``label = label_offset + b``), and ``raw``
    becomes ``(−scale [j == label] + exp(o) · scale) / τ``.  Returns the
    ``(B,)`` losses."""
    B = raw.shape[0]
    x = raw / temperature
    m = x.amax(dim=1, keepdim=True)
    o = (x - m) - torch.log(torch.exp(x - m).sum(dim=1, keepdim=True))
    rows = torch.arange(B, device=raw.device)
    labels = rows + label_offset
    loss = -o[rows, labels] * scale
    g = torch.exp(o) * scale
    g[rows, labels] = -scale + g[rows, labels]
    torch.div(g, temperature, out=raw)
    return loss


def infonce_rows(raw: torch.Tensor, *, label_offset: int, temperature: float,
                 scale: float) -> torch.Tensor:
    """InfoNCE's row losses over the raw product ``raw`` ``(B, N)`` (f32,
    contiguous): row ``b``'s logits are ``raw[b] / temperature`` and its
    label is ``label_offset + b``; the loss is the softmax cross-entropy
    times ``scale``.  Overwrites ``raw`` with the gradient of the losses'
    sum with respect to it and returns the ``(B,)`` losses.

    CPU tensors run :func:`infonce_rows_plain`; CUDA tensors launch the
    kernel on the current stream (it captures inside a CUDA graph) or
    raise.  ``infonce_rows.launches`` counts the kernel's launches (the
    plain version does not count); a chunk graph's replay adds what its
    capture counted."""
    _check(raw, label_offset)
    if raw.device.type == "cpu":
        return infonce_rows_plain(raw, label_offset=label_offset,
                                  temperature=temperature, scale=scale)
    if raw.device.type != "cuda":
        raise ValueError(f"no kernel for device {raw.device}")
    B, N = raw.shape
    loss = torch.empty((B,), dtype=torch.float32, device=raw.device)
    lib = _library()
    with torch.cuda.device(raw.device):
        err = lib.aecf_infonce_rows(
            raw.data_ptr(), B, N, label_offset, temperature, scale,
            loss.data_ptr(), torch.cuda.current_stream(raw.device).cuda_stream,
        )
    _raise_on_error(lib, err, "infonce_rows")
    infonce_rows.launches += 1
    return loss


infonce_rows.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("infonce")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.aecf_infonce_rows.argtypes = [p, i, i, i, f, f, p, p]
    lib.aecf_infonce_rows.restype = ctypes.c_int
    return _bind_error_string(lib)
