"""Shared-query fused fusion pool — eval forward, with a CUDA kernel.

Port of the eval path of :mod:`aecf_tpu.kernels.shared_query`.  Every
reference flow expands one learnable ``(1, 1, E)`` fusion query across the
batch, which lets the attention pool be restructured algebraically:

  *  scores:  ``s_h[b, m] = kv[b, m] · u_h + c_h`` with
     ``u_h = scale·(qp_h @ Wk_h)`` and ``c_h = scale·(qp_h · bk_h)``
     computed once per call — the per-sample Q/K projections disappear;
  *  values: softmax weights sum to 1, so
     ``ctx_h = (Σ_m a_h[b, m]·kv[b, m]) Wv_hᵀ + bv_h`` — the V projection
     runs on the M-times-smaller mix.  For H == 1 the V and output
     projections fuse into one precomputed ``W_vo = Wo @ Wv``.

:func:`_prep` (the per-call GEMVs and the ``W_vo`` product) is plain
PyTorch, as the JAX package leaves it to XLA.  The rest — scores, softmax,
head mean, entropy, mix and the context GEMM(s) — is one kernel,
``csrc/shared_query_fwd.cu``, behind :func:`shared_query_fwd`, whose plain
PyTorch version :func:`shared_query_fwd_plain` runs for CPU tensors.

Reassociating ``(kv·Wkᵀ)·qp → kv·(Wkᵀ·qp)`` changes the f32 summation
order, so weights match the naive oracle to ~1e-6, not bitwise.  Padded
slots get a ``-1e30`` score bias (a fully padded row comes out uniform),
where the oracle's ``-inf`` gives NaN.

Not ported yet (see ROADMAP.md): the training branch (in-kernel Bernoulli
masking), the backward kernels, the streamed split for E > 1024 and the
int8 path.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from ..core.attention import AttentionPoolParams
from ._build import load_library

__all__ = [
    "fused_fusion_pool_shared",
    "shared_query_fwd",
    "shared_query_fwd_plain",
]

# E cap of the resident kernel: its (kRows, E) mix tile — two of them for
# H > 1 — lives in shared memory (140 KB at H=2, E=1024 of the 227 KB a
# block may use).  The JAX package streams E > 1024; that split is not
# ported, so the port's cap stops here.
_RESIDENT_E_CAP = 1024
# The JAX streamed split's cap — kept so the capability gate reads like
# the JAX one.
_STREAMED_E_CAP = 8192
# Static bounds of the kernel's per-row register arrays (kMaxM, kMaxH).
_MAX_M = 8
_MAX_H = 2

_NOT_PORTED = "not ported yet (ROADMAP.md, queue 2: {})"


def _split_params(params: AttentionPoolParams, E: int):
    """Per-projection weight rows, the bias triple (zeros when the pool has
    no bias — the kernel always adds biases) and ``W_o``."""
    wq, wk, wv = params.in_proj_weight.chunk(3, dim=0)
    if params.in_proj_bias is not None:
        bq, bk, bv = params.in_proj_bias.chunk(3, dim=0)
    else:
        bq = bk = bv = params.in_proj_weight.new_zeros(E)
    return wq, wk, wv, bq, bk, bv, params.out_proj_weight


def _pad_bias_rows(key_padding_mask: Optional[torch.Tensor]):
    """(B, M) additive score bias: 0 for live slots, -1e30 for padded ones;
    None (no bias) when there is no mask."""
    if key_padding_mask is None:
        return None
    return torch.where(key_padding_mask, -1e30, 0.0).to(torch.float32)


def _prep(params: AttentionPoolParams, qrow: torch.Tensor, num_heads: int):
    """Per-call precompute (tiny GEMVs): score vectors ``u (H, E)``, offsets
    ``c (H,)`` and the context weights — ``W_vo``/``b_ctx`` for H == 1
    (``wo``/``bo`` then None), ``Wv``/``bv`` plus ``Wo``/``bo`` for H > 1."""
    E = qrow.shape[-1]
    H = num_heads
    Dh = E // H
    wq, wk, wv, bq, bk, bv, wo = _split_params(params, E)
    bo = (
        params.out_proj_bias
        if params.out_proj_bias is not None
        else qrow.new_zeros(E)
    )
    scale = Dh ** -0.5
    qp = qrow @ wq.T + bq  # (E,)
    qph = qp.reshape(H, Dh)
    u = scale * torch.einsum("hd,hde->he", qph, wk.reshape(H, Dh, E))
    c = scale * (qph * bk.reshape(H, Dh)).sum(-1)  # (H,)
    if H == 1:
        return u.contiguous(), c, wo @ wv, wo @ bv + bo, None, None
    return u.contiguous(), c, wv.contiguous(), bv.contiguous(), wo, bo


def shared_query_fwd_plain(
    kv: torch.Tensor,  # (B, M, E) f32 or bf16
    u: torch.Tensor,  # (H, E)
    c: torch.Tensor,  # (H,)
    pad_bias: Optional[torch.Tensor],  # (B, M) or None
    wctx: torch.Tensor,  # (E, E): W_vo (H == 1) or Wv (H > 1)
    bctx: torch.Tensor,  # (E,)
    wo: Optional[torch.Tensor],  # (E, E), H > 1 only
    bo: Optional[torch.Tensor],  # (E,), H > 1 only
) -> Tuple[torch.Tensor, ...]:
    """The kernel's function in plain PyTorch: ``(out (B,E), w (B,M),
    mw (B,M), ent (B,), rate (B,))`` with ``mw = w`` and ``rate = 0``."""
    B, M, E = kv.shape
    H = u.shape[0]
    Dh = E // H
    x = kv.float()
    if pad_bias is None:
        pad_bias = x.new_zeros((B, M))
    s = torch.einsum("bme,he->bhm", x, u)
    s = s + c[None, :, None] + pad_bias[:, None, :]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    a = e / e.sum(dim=-1, keepdim=True)  # (B, H, M)
    w = a.sum(dim=1) * (1.0 / H)
    max_entropy = math.log(M) if M > 1 else 0.0
    plogp = torch.where(w > 0, w * torch.log(w.clamp_min(1e-38)), 0.0)
    ent = (-plogp.sum(dim=-1)).clamp(0.0, max_entropy)
    mix = torch.einsum("bhm,bme->bhe", a, x)
    if H == 1:
        out = mix[:, 0] @ wctx.T + bctx
    else:
        ctx = torch.cat(
            [mix[:, h] @ wctx[h * Dh : (h + 1) * Dh].T for h in range(H)],
            dim=-1,
        )
        out = (ctx + bctx) @ wo.T + bo
    return out, w, w, ent, torch.zeros_like(ent)


def _check_operands(kv, u, c, pad_bias, wctx, bctx, wo, bo) -> None:
    if kv.ndim != 3:
        raise ValueError(f"kv must be (B, M, E), got shape {tuple(kv.shape)}")
    B, M, E = kv.shape
    H = u.shape[0] if u.ndim == 2 else -1
    if B < 1:
        raise ValueError("kv must have at least one row")
    if not 1 <= M <= _MAX_M:
        raise ValueError(f"kernel takes 1 <= M <= {_MAX_M}, got M={M}")
    if not 1 <= H <= _MAX_H or E % H:
        raise ValueError(
            f"kernel takes 1 <= H <= {_MAX_H} dividing E={E}, got u "
            f"{tuple(u.shape)}"
        )
    if E > _RESIDENT_E_CAP:
        raise ValueError(f"kernel takes E <= {_RESIDENT_E_CAP}, got E={E}")
    if kv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kv must be float32 or bfloat16, got {kv.dtype}")
    want = {
        "u": (u, (H, E)),
        "c": (c, (H,)),
        "pad_bias": (pad_bias, (B, M)),
        "wctx": (wctx, (E, E)),
        "bctx": (bctx, (E,)),
        "wo": (wo, (E, E) if H > 1 else None),
        "bo": (bo, (E,) if H > 1 else None),
    }
    for name, (t, shape) in want.items():
        if shape is None:
            if t is not None:
                raise ValueError(f"{name} must be None for H == 1")
            continue
        if t is None:
            if name == "pad_bias":
                continue
            raise ValueError(f"{name} is required for H={H}")
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(
                f"{name} must be float32 {shape}, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
        if t.device != kv.device:
            raise ValueError(f"{name} is on {t.device}, kv on {kv.device}")


def shared_query_fwd(
    kv: torch.Tensor,
    u: torch.Tensor,
    c: torch.Tensor,
    pad_bias: Optional[torch.Tensor],
    wctx: torch.Tensor,
    bctx: torch.Tensor,
    wo: Optional[torch.Tensor] = None,
    bo: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Wrapper of ``csrc/shared_query_fwd.cu``; operands as in
    :func:`shared_query_fwd_plain`.

    CPU tensors run the plain version.  CUDA tensors launch the kernel or
    raise — there is no fallback.  ``shared_query_fwd.launches`` counts
    kernel launches (the plain version does not count).
    """
    _check_operands(kv, u, c, pad_bias, wctx, bctx, wo, bo)
    if kv.device.type == "cpu":
        return shared_query_fwd_plain(kv, u, c, pad_bias, wctx, bctx, wo, bo)
    if kv.device.type != "cuda":
        raise ValueError(f"no kernel for device {kv.device}")
    operands = [kv, u, c, pad_bias, wctx, bctx, wo, bo]
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in operands
    ):
        raise RuntimeError(
            "the shared-query kernel has no backward yet "
            + _NOT_PORTED.format("_bwd_kernel")
            + "; run it under torch.no_grad()/inference_mode(), or use "
            "implementation='torch'"
        )
    for name, t in zip("kv u c pad_bias wctx bctx wo bo".split(), operands):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    B, M, E = kv.shape
    H = u.shape[0]
    out = torch.empty((B, E), dtype=torch.float32, device=kv.device)
    w = torch.empty((B, M), dtype=torch.float32, device=kv.device)
    mw = torch.empty_like(w)
    ent = torch.empty((B,), dtype=torch.float32, device=kv.device)
    rate = torch.empty_like(ent)
    lib = _library()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(kv.device):
        err = lib.aecf_shared_query_fwd(
            ptr(kv), int(kv.dtype == torch.bfloat16),
            ptr(u), ptr(c), ptr(pad_bias), ptr(wctx), ptr(wo), ptr(bctx),
            ptr(bo), ptr(out), ptr(w), ptr(mw), ptr(ent), ptr(rate),
            B, M, E, H, math.log(M) if M > 1 else 0.0,
            torch.cuda.current_stream(kv.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"shared_query_fwd launch failed: "
            f"{lib.aecf_cuda_error_string(err).decode()} ({err})"
        )
    shared_query_fwd.launches += 1
    return out, w, mw, ent, rate


shared_query_fwd.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("shared_query_fwd")
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.aecf_shared_query_fwd.argtypes = (
        [p, i] + [p] * 12 + [i, i, i, i, ctypes.c_float, p]
    )
    lib.aecf_shared_query_fwd.restype = i
    lib.aecf_cuda_error_string.argtypes = [i]
    lib.aecf_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _forward(params, qrow, kv, key_padding_mask, *, num_heads):
    u, c, wctx, bctx, wo, bo = _prep(params, qrow, num_heads)
    pad_bias = _pad_bias_rows(key_padding_mask)
    return shared_query_fwd(kv, u, c, pad_bias, wctx, bctx, wo, bo)


def _package_outputs(out, w, mw, ent, rate):
    """Eval packaging: ``(out (B,1,E), weights (B,1,M), masked (B,1,M),
    {entropy, mask_rate})``."""
    info = {"entropy": ent[:, None], "mask_rate": rate[:, None].detach()}
    return out[:, None, :], w[:, None, :], mw[:, None, :].detach(), info


def fused_fusion_pool_shared(
    params: AttentionPoolParams,
    query: torch.Tensor,  # (1, 1, E) — the unexpanded fusion query
    kv: torch.Tensor,  # (B, M, E)
    *,
    num_heads: int = 1,
    training: bool = False,
    key_padding_mask: Optional[torch.Tensor] = None,
    precision: str = "default",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Fused fusion pool for a batch-shared query (eval).

    Returns ``(out (B,1,E), weights (B,1,M), masked (B,1,M), info)`` with
    ``info = {entropy, mask_rate}``, as the JAX function does in eval.
    ``precision`` is ``"default"`` or ``"highest"``; both run full f32 FMAs
    in this kernel (tighter than the JAX package's bf16 ``"default"``).
    """
    if query.shape[:2] != (1, 1):
        raise ValueError(
            f"shared-query kernel expects query (1, 1, E), got "
            f"{tuple(query.shape)}"
        )
    if precision not in ("default", "highest"):
        raise ValueError(
            f"fused kernels support precision 'default' or 'highest', got "
            f"{precision!r} — use implementation='torch' for other modes"
        )
    if training:
        raise NotImplementedError(
            "training=True: in-kernel curriculum masking is "
            + _NOT_PORTED.format("_shared_kernel training branch")
        )
    E = kv.shape[-1]
    if E > _STREAMED_E_CAP:
        raise ValueError(
            f"embed_dim {E} exceeds the streamed-split cap E="
            f"{_STREAMED_E_CAP}; use implementation='torch'"
        )
    if E > _RESIDENT_E_CAP:
        raise NotImplementedError(
            f"E={E} needs the streamed split, "
            + _NOT_PORTED.format("_mix_kernel")
        )
    return _package_outputs(
        *_forward(params, query[0, 0, :], kv, key_padding_mask,
                  num_heads=num_heads)
    )
