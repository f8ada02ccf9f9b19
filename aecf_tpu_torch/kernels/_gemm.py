"""The GEMM block on its own — ``csrc/gemm_f32.cuh``'s SIMT f32 instance
at ``precision='highest'``, ``csrc/gemm_tf32.cuh``'s TF32 tensor-core
instance at ``'default'`` — for its checks and its cuBLAS yardstick
(``chip_smoke.py``); the port's kernels call it from inside their C chains,
never through this module (and the custom-``row_loss`` route's head).

``C[g] = scale · A[g] · W[g] + bias[g]`` with ``a`` ``(G, rows, K)`` or,
``a_trans=True``, ``(G, K, rows)``; ``w`` ``(G, K, N)`` (``w_kmajor=True``)
or ``(G, N, K)``, an ``nn.Linear`` weight read as ``x · Wᵀ``; ``bias``
``(G, N)`` or None.  The kernel takes the layouts the chains run: a
transposed ``a`` only with a k-major ``w``.  Both operands are read in
place, any strides whose last is 1, rows 16-byte aligned.  Built into the
``train_step`` library.

``plan=(bn, splits)`` passes a plan to the kernel verbatim (the library
refuses one the product cannot take, and the call raises); ``None`` is the
kernel's own default, ``gemm_plan``.  The GEMM alone is no launch site of
the plan table: its caller chooses.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..core.precision import matmul_precision, round_tf32
from ._build import load_library
from .shared_query import _precision_code, _ptr, _raise_on_error

_TF32 = _precision_code("default")  # the TF32 instance's gemm::Precision

__all__ = ["gemm_f32", "gemm_f32_plain"]


def gemm_f32_plain(
    a: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    scale: float = 1.0,
    a_trans: bool = False,
    w_kmajor: bool = True,
    tf32: bool = False,
) -> torch.Tensor:
    """The GEMM's function in plain PyTorch: ``(G, rows, N)``, an IEEE f32
    product (whatever the process's matmul mode); with ``tf32`` (the TF32
    instance's function, :func:`gemm_f32` at ``precision='default'``) of
    the operands rounded to TF32 (:func:`round_tf32`), as the tensor cores
    take them — the products of two TF32 values are exact in f32, so only
    the order of the sums differs from the kernel's."""
    A = a.transpose(1, 2) if a_trans else a
    W = w if w_kmajor else w.transpose(1, 2)
    if tf32:
        A, W = round_tf32(A), round_tf32(W)
    with matmul_precision("highest"):
        out = torch.matmul(A, W) * scale
    return out if bias is None else out + bias[:, None, :]


def _dims(a, w, a_trans, w_kmajor):
    if a.ndim != 3 or w.ndim != 3 or a.shape[0] != w.shape[0]:
        raise ValueError(
            f"a and w must be (G, ., .) with one G, got {tuple(a.shape)} and "
            f"{tuple(w.shape)}"
        )
    G = a.shape[0]
    rows, K = (a.shape[2], a.shape[1]) if a_trans else (a.shape[1], a.shape[2])
    Kw, N = (w.shape[1], w.shape[2]) if w_kmajor else (w.shape[2], w.shape[1])
    if K != Kw or min(G, rows, K, N) < 1:
        raise ValueError(
            f"a {tuple(a.shape)} (a_trans={a_trans}) and w {tuple(w.shape)} "
            f"(w_kmajor={w_kmajor}) do not chain"
        )
    return G, rows, K, N


class _GemmCall(ctypes.Structure):
    """``GemmCall`` of ``csrc/train_step.cu``, field for field."""

    _fields_ = [
        ("A", ctypes.c_void_p), ("lda", ctypes.c_longlong),
        ("a_gstride", ctypes.c_longlong),
        ("W", ctypes.c_void_p), ("ldw", ctypes.c_longlong),
        ("w_gstride", ctypes.c_longlong),
        ("bias", ctypes.c_void_p), ("bias_gstride", ctypes.c_longlong),
        ("C", ctypes.c_void_p), ("ldc", ctypes.c_longlong),
        ("c_gstride", ctypes.c_longlong),
        ("partials", ctypes.c_void_p),
    ] + [
        (name, ctypes.c_int)
        for name in ("rows", "N", "K", "groups", "a_trans", "w_kmajor")
    ] + [("scale", ctypes.c_float), ("bn", ctypes.c_int),
         ("splits", ctypes.c_int), ("precision", ctypes.c_int)]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("train_step")
    lib.aecf_gemm_f32_scratch.argtypes = [ctypes.c_int] * 7
    lib.aecf_gemm_f32_scratch.restype = ctypes.c_size_t
    lib.aecf_gemm_f32_plan.argtypes = [ctypes.c_int] * 8 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.aecf_gemm_f32_plan.restype = ctypes.c_int
    lib.aecf_gemm_f32.argtypes = [ctypes.POINTER(_GemmCall), ctypes.c_void_p]
    lib.aecf_gemm_f32.restype = ctypes.c_int
    lib.aecf_cuda_error_string.argtypes = [ctypes.c_int]
    lib.aecf_cuda_error_string.restype = ctypes.c_char_p
    return lib


def gemm_f32(
    a: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    scale: float = 1.0,
    a_trans: bool = False,
    w_kmajor: bool = True,
    plan: Optional[Tuple[int, int]] = None,
    precision: str = "highest",
) -> torch.Tensor:
    """Launches the GEMM on CUDA tensors, or raises (a CPU tensor, a dtype
    other than f32, shapes that do not chain, strides it cannot read, a
    ``plan`` the kernel refuses); operands and result as in
    :func:`gemm_f32_plain`.  ``precision`` picks the instance: the SIMT
    f32 kernel at ``'highest'``, the TF32 tensor-core kernel at
    ``'default'``, under the same plans.  ``gemm_f32.launches`` counts
    calls."""
    code = _precision_code(precision)
    G, rows, K, N = _dims(a, w, a_trans, w_kmajor)
    if a_trans and not w_kmajor:
        raise ValueError("a transposed a takes a k-major w (w_kmajor=True)")
    named = {"a": a, "w": w, "bias": bias}
    for name, t in named.items():
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if bias is not None and (tuple(bias.shape) != (G, N)
                             or bias.stride(1) != 1):
        raise ValueError(f"bias must be ({G}, {N}) with unit last stride")
    gstride = {"a": a.stride(0) if G > 1 else 0,
               "w": w.stride(0) if G > 1 else 0}
    for name, t in (("a", a), ("w", w)):
        if (t.stride(2) != 1 or t.stride(1) % 4 or gstride[name] % 4
                or t.data_ptr() % 16):
            raise ValueError(
                f"{name} must have unit last stride, the others multiples "
                "of 4, and a 16-byte aligned start"
            )
        if code == _TF32 and G > 1 and gstride[name] == 0:
            raise ValueError(
                f"{name} repeats one matrix over its {G} groups (group "
                "stride 0): the TF32 instance's tensor maps step groups by "
                "a nonzero stride; pass a materialised copy"
            )
    for t in named.values():
        if t is not None and t.device.type != "cuda":
            raise ValueError(f"no kernel for device {t.device}")
    bn, splits = plan if plan is not None else (0, 0)
    out = torch.empty((G, rows, N), dtype=torch.float32, device=a.device)
    lib = _library()
    scratch = torch.empty((lib.aecf_gemm_f32_scratch(rows, N, K, G,
                                                     int(w_kmajor), bn,
                                                     splits),),
                          dtype=torch.float32, device=a.device)
    call = _GemmCall(
        _ptr(a), a.stride(1), gstride["a"], _ptr(w), w.stride(1),
        gstride["w"],
        _ptr(bias), 0 if bias is None else bias.stride(0), _ptr(out), N,
        rows * N, _ptr(scratch), rows, N, K, G, int(a_trans), int(w_kmajor),
        float(scale), bn, splits, code,
    )
    with torch.cuda.device(a.device):
        err = lib.aecf_gemm_f32(
            ctypes.byref(call), torch.cuda.current_stream(a.device).cuda_stream
        )
    _raise_on_error(lib, err, "gemm_f32")
    gemm_f32.launches += 1
    return out


gemm_f32.launches = 0
