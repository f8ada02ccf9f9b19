"""Per-row-query fused fusion pool — forward kernel, torch backward — and
the capability and preference gates of the fused kernels.

Port of :mod:`aecf_tpu.kernels.fused_pool`.  The query is ``(B, 1, E)``,
one row per sample (the README Quick start broadcasts the fusion query per
row, a row stride of 0).  The forward is one call into
``csrc/fused_pool_fwd.cu`` behind :func:`fused_pool_fwd` (the TPU's
``_fusion_kernel``), a chain of kernels on the caller's stream: the Q
projection and the per-head ``u = scale·Wk_hᵀ·qp_h`` as GEMMs (for one row
when the query's row stride is 0), a row kernel for the scores through the
per-row ``u``/``c`` rewrite, softmax, head mean, entropy, the training
mask chain (Philox draw, ``min_active``, renormalisation; :mod:`.draws`)
and the per-head mixes, then the context and output projections as GEMMs
(``csrc/gemm_f32.cuh``, a pipelined SIMT f32 GEMM over the whole batch,
reading the weights as stored), through a workspace this wrapper
allocates.  The launch is the custom op ``aecf_tpu_torch::fused_pool_fwd``
(its plain version on CPU tensors), so ``torch.export`` records it as one
node and a frozen program launches the kernel with the query's row stride
as it finds it.  Its plain PyTorch version,
:func:`fused_pool_fwd_plain`, follows the JAX kernel's op order (project
Q, K and V, then scores), so the two agree to ~1e-6, not bitwise.

The backward is plain torch — the JAX package runs it as XLA einsums
(``_fused_bwd_impl``), not as a Pallas kernel — at IEEE f32 whatever the
process's matmul mode, as JAX runs it under ``"highest"``.  :class:`_FusedPool` ties
the two into one ``torch.autograd.Function``; :func:`fused_fusion_pool`
is the differentiable entry with the JAX function's info contract.

Kernel limits: 1 ≤ M ≤ 8, E ≤ 1024 with E a multiple of 4·H, any H (the
kernel takes the heads one a pass).  Padded slots get a ``-1e30`` score
bias (a fully padded row comes out uniform), where the oracle's ``-inf``
gives NaN.

The gates (:func:`supports_fused`, :func:`prefers_fused`) encode the JAX
package's TPU measurements: ``'auto'`` sends H > 2 to the torch path,
although the kernels take it when forced.  The card's H > 2 times are in
PERF.md §6; re-deriving the gates from them is ROADMAP.md queue 2, item 7.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from ..core.attention import AttentionPoolParams
from ..core.precision import matmul_precision
from ._build import load_library
from ._plan import GemmTile, _pick_plan, dtype_name, fused_fwd_products
from .draws import draw_seed_words
from .shared_query import (
    _FWD_OUTS,
    _MASK_ARGS,
    _MAX_M,
    _RESIDENT_E_CAP,
    _STREAMED_E_CAP,
    _check_f32,
    _entropy,
    _fake_outs,
    _fold_entropy_cotangent,
    _package_outputs,
    _pad_bias_rows,
    _ptr,
    _raise_on_error,
    _require_aligned,
    _require_cuda,
    _require_device,
    _side_outputs,
    _split_params,
)

__all__ = [
    "fused_fusion_pool",
    "fused_pool_fwd",
    "fused_pool_fwd_plain",
    "prefers_fused",
    "supports_fused",
]

_LIMITS = (
    "the per-row-query kernel takes 1 <= M <= {m} and E <= {e} with E a "
    "multiple of 4*H, got H={H}, M={M}, E={E}; other widths take "
    "implementation='torch' (the kernels' limits and gates: ROADMAP.md, "
    "queue 2)"
)


def supports_fused(
    *,
    tgt_len: int,
    num_heads: int,
    embed_dim: int,
    dropout: float = 0.0,
    has_masks: bool = False,
    shared_query: bool = False,
) -> bool:
    """Config gate for the fused kernels; unsupported configs take the
    torch path.  Query length 1, no dropout, no attention masks, heads
    dividing E, and E under the resident cap — or, for a shared query with
    H ≤ 2, under the streamed-split cap."""
    e_cap = (
        _STREAMED_E_CAP
        if shared_query and num_heads <= 2
        else _RESIDENT_E_CAP
    )
    return (
        tgt_len == 1
        and dropout == 0.0
        and not has_masks
        and embed_dim % num_heads == 0
        and embed_dim <= e_cap
    )


def prefers_fused(*, num_heads: int) -> bool:
    """Performance preference (vs capability — :func:`supports_fused`): the
    fused kernels for H ≤ 2, the JAX package's rule (on the TPU the
    per-head GEMMs lost to XLA's batched heads from H=4 up).  The kernels
    take H > 2 when forced; their times on the H100 beside the torch path's
    are in PERF.md §6, and the gate's re-derivation is ROADMAP.md queue 2,
    item 7."""
    return num_heads <= 2


def _kernel_takes(M: int, E: int, H: int) -> bool:
    """Whether :func:`fused_pool_fwd` takes these widths."""
    return H >= 1 and 1 <= M <= _MAX_M and E <= _RESIDENT_E_CAP and (
        E % (4 * H) == 0
    )


def fused_pool_fwd_plain(
    q: torch.Tensor,  # (B, E) f32 or bf16
    kv: torch.Tensor,  # (B, M, E) f32 or bf16
    pad_bias: Optional[torch.Tensor],  # (B, M) or None
    in_w: torch.Tensor,  # (3E, E)
    in_b: Optional[torch.Tensor],  # (3E,)
    out_w: torch.Tensor,  # (E, E)
    out_b: Optional[torch.Tensor],  # (E,)
    *,
    num_heads: int,
    training: bool = False,
    seed: Tuple[int, int] = (0, 0),
    mask_prob: float = 0.15,
    min_active: int = 1,
) -> Tuple[torch.Tensor, ...]:
    """The kernel's function in plain PyTorch, in the JAX kernel's op
    order: ``(out (B,E), w (B,M), mw (B,M), ent (B,), rate (B,))``.  Eval:
    ``mw = w``, ``rate = 0``.  Training (M > 1) masks with the uniforms of
    :func:`.draws.mask_uniforms` for ``seed``."""
    B, M, E = kv.shape
    H = num_heads
    Dh = E // H
    wq, wk, wv, bq, bk, bv = _split_params(in_w, in_b, out_w)
    bo = out_b if out_b is not None else out_w.new_zeros(E)
    x = kv.float()
    qp = q.float() @ wq.T + bq  # (B, E)
    kp = (x @ wk.T + bk).reshape(B, M, H, Dh)
    vp = (x @ wv.T + bv).reshape(B, M, H, Dh)
    s = torch.einsum("bhd,bmhd->bhm", qp.reshape(B, H, Dh), kp) * Dh ** -0.5
    if pad_bias is not None:
        s = s + pad_bias[:, None, :]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    a = e / e.sum(dim=-1, keepdim=True)  # (B, H, M), softmax over M
    w = a.sum(dim=1) * (1.0 / H)
    ent = _entropy(w)
    ctx = torch.einsum("bhm,bmhd->bhd", a, vp).reshape(B, E)
    out = ctx @ out_w.T + bo
    mw, rate = _side_outputs(
        w, ent, training=training, seed=seed, mask_prob=mask_prob,
        min_active=min_active,
    )
    return out, w, mw, ent, rate


def _check_operands(q, kv, pad_bias, in_w, in_b, out_w, out_b, num_heads):
    if kv.ndim != 3 or q.ndim != 2:
        raise ValueError(
            f"q must be (B, E) and kv (B, M, E), got {tuple(q.shape)} and "
            f"{tuple(kv.shape)}"
        )
    B, M, E = kv.shape
    if B < 1 or tuple(q.shape) != (B, E):
        raise ValueError(
            f"q {tuple(q.shape)} must be (B, E) for kv {tuple(kv.shape)}, "
            "B >= 1"
        )
    if not _kernel_takes(M, E, num_heads):
        raise ValueError(
            _LIMITS.format(m=_MAX_M, e=_RESIDENT_E_CAP, H=num_heads, M=M,
                           E=E)
        )
    for name, t in (("q", q), ("kv", kv)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if q.device != kv.device:
        raise ValueError(f"q is on {q.device}, kv on {kv.device}")
    _check_f32(kv, {
        "pad_bias": (pad_bias, (B, M)),
        "in_w": (in_w, (3 * E, E)),
        "in_b": (in_b, (3 * E,)),
        "out_w": (out_w, (E, E)),
        "out_b": (out_b, (E,)),
    }, optional=("pad_bias", "in_b", "out_b"), why="the per-row kernel")


class _FusedParams(ctypes.Structure):
    """``FusedParams`` of ``csrc/fused_pool_fwd.cu``, field for field."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "q", "kv", "pad", "wq", "bq", "wk", "bk", "wv", "bv", "wo",
            "bo", "out", "w", "mw", "ent", "rate", "ws",
        )
    ] + [("ldq", ctypes.c_longlong)] + [
        (name, ctypes.c_int)
        for name in (
            "B", "M", "E", "H", "q_bf16", "kv_bf16", "training", "min_active",
        )
    ] + [(name, ctypes.c_uint32) for name in ("seed0", "seed1")] + [
        (name, ctypes.c_float) for name in ("max_entropy", "mask_prob", "scale")
    ] + [("plans", GemmTile * 4)]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("fused_pool_fwd")
    lib.aecf_fused_pool_fwd.argtypes = [
        ctypes.POINTER(_FusedParams), ctypes.c_void_p,
    ]
    lib.aecf_fused_pool_fwd.restype = ctypes.c_int
    lib.aecf_fused_pool_fwd_smem.argtypes = [ctypes.c_int] * 3
    lib.aecf_fused_pool_fwd_smem.restype = ctypes.c_size_t
    tiles = ctypes.POINTER(GemmTile)
    lib.aecf_fused_pool_fwd_workspace.argtypes = [ctypes.c_int] * 4 + [tiles]
    lib.aecf_fused_pool_fwd_workspace.restype = ctypes.c_size_t
    lib.aecf_fused_pool_fwd_plans.argtypes = [ctypes.c_int] * 4 + [
        tiles, ctypes.POINTER(ctypes.c_int)]
    lib.aecf_fused_pool_fwd_plans.restype = ctypes.c_int
    lib.aecf_cuda_error_string.argtypes = [ctypes.c_int]
    lib.aecf_cuda_error_string.restype = ctypes.c_char_p
    return lib


def fused_pool_fwd(
    q: torch.Tensor,
    kv: torch.Tensor,
    pad_bias: Optional[torch.Tensor],
    in_w: torch.Tensor,
    in_b: Optional[torch.Tensor],
    out_w: torch.Tensor,
    out_b: Optional[torch.Tensor],
    *,
    num_heads: int,
    training: bool = False,
    seed: Tuple[int, int] = (0, 0),
    mask_prob: float = 0.15,
    min_active: int = 1,
) -> Tuple[torch.Tensor, ...]:
    """Wrapper of ``csrc/fused_pool_fwd.cu``; operands and results as in
    :func:`fused_pool_fwd_plain`.

    CUDA tensors only: it launches the kernel chain, through the custom op
    ``aecf_tpu_torch::fused_pool_fwd``, or raises (a CPU tensor, a width
    or dtype the kernel does not take, unaligned ``kv`` or weights, a
    failed build or launch) and never runs the plain version.  ``q`` may
    have any row stride, 0 included (an expanded query: the Q and ``u``
    projections then run for one row); its rows must be contiguous.
    ``fused_pool_fwd.launches`` counts calls (one a call, whatever the
    chain launches).  The outputs carry no autograd graph:
    :func:`fused_fusion_pool` is the differentiable entry.
    """
    if kv.device.type != "cuda":
        raise ValueError(f"no kernel for device {kv.device}")
    return _kernel_fwd(q, kv, pad_bias, in_w, in_b, out_w, out_b, num_heads,
                       training=training, seed=seed, mask_prob=mask_prob,
                       min_active=min_active)


def _kernel_fwd(q, kv, pad_bias, in_w, in_b, out_w, out_b, num_heads, *,
                training, seed, mask_prob, min_active):
    """The operands validated, then the op: the kernel for CUDA tensors,
    the plain version for CPU ones."""
    _check_operands(q, kv, pad_bias, in_w, in_b, out_w, out_b, num_heads)
    if q.stride(1) != 1:
        raise ValueError("q's rows must be contiguous (stride 1 along E)")
    _require_device(kv)
    return _fused_pool_fwd_op(
        q, kv, pad_bias, in_w, in_b, out_w, out_b, int(num_heads),
        bool(training), int(seed[0]), int(seed[1]), float(mask_prob),
        int(min_active),
    )


@torch.library.custom_op(
    "aecf_tpu_torch::fused_pool_fwd", mutates_args=(),
    schema="(Tensor q, Tensor kv, Tensor? pad_bias, Tensor in_w, "
           "Tensor? in_b, Tensor out_w, Tensor? out_b, int num_heads, "
           f"{_MASK_ARGS}) -> {_FWD_OUTS}",
)
def _fused_pool_fwd_op(q, kv, pad_bias, in_w, in_b, out_w, out_b, num_heads,
                       training, seed0, seed1, mask_prob, min_active):
    B, M, E = kv.shape
    H = num_heads
    # resolved in the op's body: a frozen program follows the table of the
    # process that runs it
    plans = _pick_plan(
        "fwd_generic", fused_fwd_products(B, E, H, 1 if q.stride(0) == 0
                                          else B),
        M=M, E=E, H=H, kv_dtype=dtype_name(kv.dtype), device=kv.device)
    if kv.device.type == "cpu":
        return fused_pool_fwd_plain(
            q, kv, pad_bias, in_w, in_b, out_w, out_b, num_heads=num_heads,
            training=training, seed=(seed0, seed1), mask_prob=mask_prob,
            min_active=min_active,
        )
    _require_cuda(kv, dict(kv=kv, pad_bias=pad_bias, in_w=in_w, in_b=in_b,
                           out_w=out_w, out_b=out_b))
    _require_aligned(dict(kv=kv, in_w=in_w, in_b=in_b, out_w=out_w))
    wq, wk, wv, bq, bk, bv = _split_params(in_w, in_b, out_w)
    bo = out_b if out_b is not None else out_w.new_zeros(E)
    dev = kv.device
    out = torch.empty((B, E), dtype=torch.float32, device=dev)
    w = torch.empty((B, M), dtype=torch.float32, device=dev)
    mw = torch.empty_like(w)
    ent = torch.empty((B,), dtype=torch.float32, device=dev)
    rate = torch.empty_like(ent)
    lib = _library()
    ws = torch.empty(
        (lib.aecf_fused_pool_fwd_workspace(B, E, H, int(q.stride(0) == 0),
                                           plans),),
        dtype=torch.float32, device=dev,
    )
    p = _FusedParams(
        _ptr(q), _ptr(kv), _ptr(pad_bias), _ptr(wq), _ptr(bq), _ptr(wk),
        _ptr(bk), _ptr(wv), _ptr(bv), _ptr(out_w), _ptr(bo), _ptr(out),
        _ptr(w), _ptr(mw), _ptr(ent), _ptr(rate), _ptr(ws), q.stride(0),
        B, M, E, H, int(q.dtype == torch.bfloat16),
        int(kv.dtype == torch.bfloat16), int(training), min_active,
        seed0, seed1, math.log(M) if M > 1 else 0.0, mask_prob,
        (E // H) ** -0.5, plans,
    )
    with torch.cuda.device(dev):
        err = lib.aecf_fused_pool_fwd(
            ctypes.byref(p), torch.cuda.current_stream(dev).cuda_stream
        )
    _raise_on_error(lib, err, "fused_pool_fwd")
    fused_pool_fwd.launches += 1
    return out, w, mw, ent, rate


@_fused_pool_fwd_op.register_fake
def _(q, kv, pad_bias, in_w, in_b, out_w, out_b, *rest):
    return _fake_outs(kv, kv.shape[2])


fused_pool_fwd.launches = 0


def _forward(tensors, kpm, num_heads, mask_kw, implementation):
    """The op — the kernel for CUDA tensors, the plain version for CPU
    tensors — or the plain version on any device where
    ``implementation='plain'``."""
    in_w, in_b, out_w, out_b, q, kv = tensors
    args = (q, kv, _pad_bias_rows(kpm), in_w, in_b, out_w, out_b)
    if implementation == "plain":
        _check_operands(*args, num_heads)  # the kernel's limits on any device
        return fused_pool_fwd_plain(*args, num_heads=num_heads, **mask_kw)
    return _kernel_fwd(*args, num_heads, **mask_kw)


def _fused_bwd(tensors, kpm, d_out, d_w, num_heads, want_dkv):
    """Port of ``_fused_bwd_impl``: recompute the projections and the
    softmax, then the einsum backward, f32 throughout.  Returns ``(d_in_w,
    d_in_b, d_out_w, d_out_b, d_q, d_kv)``; ``d_kv`` is None unless
    ``want_dkv`` (frozen features skip its two (B·M, E, E) products)."""
    in_w, in_b, out_w, out_b, q, kv = tensors
    B, M, E = kv.shape
    H = num_heads
    Dh = E // H
    wq, wk, wv, bq, bk, bv = _split_params(in_w, in_b, out_w)
    qf = q.float()
    x = kv.float()
    qp = qf @ wq.T + bq
    kp = x @ wk.T + bk
    vp = x @ wv.T + bv
    scale = Dh ** -0.5
    qh = qp.reshape(B, H, Dh)
    kh = kp.reshape(B, M, H, Dh)
    vh = vp.reshape(B, M, H, Dh)
    scores = torch.einsum("bhd,bmhd->bhm", qh, kh) * scale
    if kpm is not None:
        scores = torch.where(kpm[:, None, :], -1e30, scores)
    attn = torch.softmax(scores, dim=-1)  # (B, H, M)
    ctx = torch.einsum("bhm,bmhd->bhd", attn, vh).reshape(B, E)

    d_ctx = d_out @ out_w
    d_out_w = d_out.T @ ctx
    d_out_b = d_out.sum(0) if out_b is not None else None
    d_ctx_h = d_ctx.reshape(B, H, Dh)
    d_attn = torch.einsum("bhd,bmhd->bhm", d_ctx_h, vh)
    d_vh = torch.einsum("bhm,bhd->bmhd", attn, d_ctx_h)
    if d_w is not None:
        d_attn = d_attn + d_w[:, None, :] / H
    d_scores = attn * (d_attn - (attn * d_attn).sum(dim=-1, keepdim=True))
    d_qp = torch.einsum("bhm,bmhd->bhd", d_scores, kh).reshape(B, E) * scale
    d_kp = torch.einsum("bhm,bhd->bmhd", d_scores, qh).reshape(B * M, E) * scale
    d_vp = d_vh.reshape(B * M, E)
    x2 = x.reshape(B * M, E)
    d_q = d_qp @ wq
    d_kv = None
    if want_dkv:
        d_kv = (d_kp @ wk + d_vp @ wv).reshape(B, M, E).to(kv.dtype)
    d_in_w = torch.cat([d_qp.T @ qf, d_kp.T @ x2, d_vp.T @ x2], dim=0)
    d_in_b = None
    if in_b is not None:
        d_in_b = torch.cat([d_qp.sum(0), d_kp.sum(0), d_vp.sum(0)])
    return d_in_w, d_in_b, d_out_w, d_out_b, d_q.to(q.dtype), d_kv


class _FusedPool(torch.autograd.Function):
    """Forward kernel (plain version on the CPU) + torch backward, the port
    of ``_fused_core``'s custom VJP.  Returns ``(out, w, mw, ent, rate)``;
    ``mw`` and ``rate`` carry no gradient, and the backward folds an entropy
    cotangent into the weights' (``_fold_entropy_cotangent``), as
    ``_fused_bwd`` does.  The output flows through the unmasked weights
    (quirk Q1), so the backward needs no mask."""

    @staticmethod
    def forward(ctx, in_w, in_b, out_w, out_b, q, kv, kpm, num_heads,
                mask_kw, implementation):
        tensors = (in_w, in_b, out_w, out_b, q, kv)
        out, w, mw, ent, rate = _forward(tensors, kpm, num_heads, mask_kw,
                                         implementation)
        ctx.save_for_backward(*tensors, kpm, w)
        ctx.num_heads = num_heads
        ctx.mark_non_differentiable(mw, rate)
        return out, w, mw, ent, rate

    @staticmethod
    def backward(ctx, d_out, d_w, _d_mw, d_ent, _d_rate):
        *tensors, kpm, w = ctx.saved_tensors
        d_w = _fold_entropy_cotangent(d_w, d_ent, w)
        # IEEE f32 whatever the process's mode, as the forward kernel (and
        # JAX's _fused_bwd_impl, under "highest")
        with matmul_precision("highest"):
            grads = _fused_bwd(tensors, kpm, d_out, d_w, ctx.num_heads,
                               want_dkv=ctx.needs_input_grad[5])
        return (*grads, None, None, None, None)


def fused_fusion_pool(
    params: AttentionPoolParams,
    query: torch.Tensor,  # (B, 1, E) — one query row per sample
    kv: torch.Tensor,  # (B, M, E)
    *,
    num_heads: int = 1,
    generator: Optional[torch.Generator] = None,
    training: bool = False,
    base_mask_prob: float = 0.15,
    entropy_target: float = 0.7,
    min_active: int = 1,
    key_padding_mask: Optional[torch.Tensor] = None,
    implementation: str = "kernel",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Fused forward of the full fusion path for a per-row query,
    differentiable.

    Returns ``(out (B,1,E), weights (B,1,M), masked (B,1,M), info)`` with
    the JAX function's info contract: eval ``{entropy, mask_rate}`` (the
    entropy carries gradient), training ``{entropy, mask_rate,
    target_entropy}`` all detached, zeros when M ≤ 1.  ``training=True``
    draws the curriculum mask in the kernel from two seed words taken from
    ``generator`` (a CPU ``torch.Generator``, in place of JAX's ``rng=``).
    Gradients flow to the pool's parameters, ``query`` and ``kv``.

    ``implementation``: ``'kernel'`` runs the CUDA kernel on CUDA tensors
    (its plain version on CPU tensors); ``'plain'`` runs the plain version
    on any device, which is how a check holds the kernel to it.
    """
    if implementation not in ("kernel", "plain"):
        raise ValueError(
            f"unknown implementation {implementation!r} (expected 'kernel' "
            "or 'plain')"
        )
    if query.ndim != 3 or query.shape[1] != 1:
        raise ValueError(
            f"fused kernel requires tgt_len == 1, got query {tuple(query.shape)}"
        )
    M = kv.shape[1]
    # M <= 1 masking is a no-op (reference AECFLayer.py:160-167): no draw,
    # no generator needed.
    if training and generator is None and M > 1:
        raise ValueError(
            "fused_fusion_pool(training=True) needs a `generator=`"
        )
    mask_kw = dict(
        training=training, seed=draw_seed_words(generator),
        mask_prob=float(base_mask_prob), min_active=int(min_active),
    )
    q = query[:, 0, :]
    if q.stride(-1) != 1:
        q = q.contiguous()
    tensors = (params.in_proj_weight, params.in_proj_bias,
               params.out_proj_weight, params.out_proj_bias, q,
               kv.contiguous())
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    ):
        outs = _FusedPool.apply(*tensors, key_padding_mask, num_heads,
                                mask_kw, implementation)
    else:
        outs = _forward(tensors, key_padding_mask, num_heads, mask_kw,
                        implementation)
    return _package_outputs(
        *outs, training=training, M=M, entropy_target=entropy_target
    )
