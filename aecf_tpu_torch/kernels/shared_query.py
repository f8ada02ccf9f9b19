"""Shared-query fused fusion pool — the resident kernels (E ≤ 1024) and the
streamed split (H ≤ 2 up to E = 8192, and H == 2 training from E = 512),
with CUDA kernels.

Port of :mod:`aecf_tpu.kernels.shared_query` (f32, bf16 and int8
features).  Every reference flow expands one learnable ``(1, 1, E)`` fusion
query across the batch, which lets the attention pool be restructured
algebraically:

  *  scores:  ``s_h[b, m] = kv[b, m] · u_h + c_h`` with
     ``u_h = scale·(qp_h @ Wk_h)`` and ``c_h = scale·(qp_h · bk_h)``
     computed once per call — the per-sample Q/K projections disappear;
  *  values: softmax weights sum to 1, so
     ``ctx_h = (Σ_m a_h[b, m]·kv[b, m]) Wv_hᵀ + bv_h`` — the V projection
     runs on the M-times-smaller mix.  For H == 1 the V and output
     projections fuse into one precomputed ``W_vo = Wo @ Wv``.

:func:`_prep` (the per-call GEMVs and the ``W_vo`` product) is plain
PyTorch, as the JAX package leaves it to XLA.  Four kernels:

* ``csrc/shared_query_fwd.cu`` behind :func:`shared_query_fwd` — a chain:
  a row kernel (scores, softmax, head mean, entropy, the training mask
  chain — Philox draw, ``min_active``, renormalisation; :mod:`.draws` —
  and the per-head mixes), then the context GEMM(s) over the whole batch
  (``csrc/gemm_f32.cuh``, or its TF32 tensor-core instance
  ``csrc/gemm_tf32.cuh`` at ``precision='default'``), E ≤ 1024;
* ``csrc/shared_query_bwd.cu`` behind :func:`shared_query_bwd` — the H == 1
  backward of that forward, a chain on the same row kernels
  (``csrc/pool_rows.cuh``, shared with the one-pass step) and GEMM:
  softmax recompute, ``d_mix = d_out·W_vo``, softmax backward with a
  weights cotangent, G / du / Σd_out / Σd_s, optional ``d_kv``;
* ``csrc/stream_mix.cu`` behind :func:`stream_mix` — the streamed forward:
  the same chain, writing the per-head mixes ``(B, H·E)``; the context
  GEMMs run in cuBLAS (:func:`_context`), so no ``(E, E)`` matrix is in a
  kernel;
* ``csrc/stream_bwd.cu`` behind :func:`stream_bwd` (H == 1) and
  :func:`stream_bwd_mh` (H == 2) — the streamed backward: softmax
  recompute and backward, optional ``d_kv`` summed over heads, du/dc from
  one partial row per persistent cluster (``part_sum``); its E×E GEMMs run
  in cuBLAS first.

Both streamed kernels read each kv row (and ``d_mix`` row) from device
memory once, staged in shared memory (``csrc/stream_stage.cuh``).

``precision`` — JAX's rule (``_ctx_prec``, ``_dot_prec``,
``_stream_mix_dtype``).  ``'highest'``: every product in IEEE f32.
``'default'`` on the card: the chains' in-kernel products on TF32 tensor
cores (JAX's dots at ``mxu_precision = None``, which an Ampere or Hopper
GPU runs as TF32), and the prologue (``qp``, ``u``, ``c``, ``W_vo``) and the
glue GEMMs under :func:`~aecf_tpu_torch.core.matmul_precision` (cuBLAS
TF32), the backward re-entering its forward's mode; on the CPU the
products stay IEEE f32, as JAX's CPU backend computes them.  At
``'default'`` on any device the streamed split stores ``mix`` and
``d_mix`` in bf16, an explicit dtype in JAX.  The row kernels (scores,
softmax, entropy, masks, softmax backward) are f32 at both.  The plain
versions take the TF32 emulation as an argument (``tf32=``:
:func:`~aecf_tpu_torch.core.round_tf32` on both operands of each such
product, then an IEEE f32 product), which the wrappers leave off on the
CPU.

Each takes f32, bf16 or int8 features; int8 comes with per-(row,
modality) f32 scales ``kv_scales (B, M)`` (:func:`quantize_features`) and
is dequantized per element in the kernel, ``float(q)·scale``, as every
plain version does through :func:`_dequant` (JAX's ``_kv_tile_slices``).
int8 features are frozen: no kernel writes a ``d_kv`` for them.

Each has a plain version beside it (``*_plain``).  :class:`_SharedPool`
ties them into one ``torch.autograd.Function``; :func:`_vjp_wants_streamed`
chooses the route as the JAX package does.  The resident H > 1 backward is
plain torch, as the JAX package runs that case in XLA.  Each wrapper runs
its plain version for CPU tensors and, for CUDA tensors, launches its
kernel or raises.  The two forwards' wrappers validate their operands and
call a custom op (``aecf_tpu_torch::shared_query_fwd``,
``::stream_mix``) with a fake implementation, so ``torch.export`` can
trace them; everything that reads storage (pointers, alignment, the
workspace size) runs inside the op.

Reassociating ``(kv·Wkᵀ)·qp → kv·(Wkᵀ·qp)`` changes the f32 summation
order, so weights match the naive oracle to ~1e-6, not bitwise.  Padded
slots get a ``-1e30`` score bias (a fully padded row comes out uniform),
where the oracle's ``-inf`` gives NaN.

The resident forward takes any H dividing E (E ≤ 1024), as JAX's kernel
does when forced, and its H == 1 backward any E ≤ 1024 (the chains'
workspace rows run at a multiple of four floats): above H = 2 the row
kernel takes the heads in passes of two (``row_softmax_heads`` in
``csrc/pool_common.cuh``), and its gradients
run through ``_bwd_heads`` in torch, as JAX's XLA backward.  ``'auto'``
keeps H > 2 on the torch path (``prefers_fused``, the JAX package's rule)
until the card's times at H > 2 (PERF.md §6) decide the gate, ROADMAP.md
queue 2, item 7.  The streamed kernels take H ≤ 2, as JAX's.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from ..core.attention import AttentionPoolParams
from ..core.precision import matmul_precision, round_tf32
from ._build import load_library
from ._plan import (
    GemmTile,
    _pick_grid,
    _pick_plan,
    dtype_name,
    sq_bwd_products,
    sq_fwd_products,
)
from .draws import draw_seed_words, mask_and_renorm, mask_uniforms

__all__ = [
    "fused_fusion_pool_shared",
    "quantize_features",
    "shared_query_bwd",
    "shared_query_bwd_plain",
    "shared_query_fwd",
    "shared_query_fwd_plain",
    "stream_bwd",
    "stream_bwd_mh",
    "stream_bwd_plain",
    "stream_mix",
    "stream_mix_plain",
]

# E cap of the resident chains, the JAX package's: no kernel of theirs
# holds an E-sized tile, so what keeps it is the gate (ROADMAP.md queue 2,
# item 7).  Above it, H ≤ 2 takes the streamed split.
_RESIDENT_E_CAP = 1024
# The streamed split's cap, the JAX package's (its kv tile floors at the
# TPU's (8, 128) tile there); the CUDA kernels hold no E-sized tile.
_STREAMED_E_CAP = 8192
# Below the resident cap, H == 2 training streams from this E up.
_STREAMED_H2_MIN_E = 512
# Static bound of the kernels' per-row register arrays (kMaxM).
_MAX_M = 8
# Heads of the streamed kernels (JAX's streamed split is H <= 2 too).
_STREAMED_MAX_H = 2
_HEADS = ("the resident shared-query kernel takes 1 <= H <= E with H "
          "dividing E, got H={H}, E={E}")
# kv_dtype codes of the C interfaces (KvDtype in csrc/pool_common.cuh).
_KV_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# precision codes of the chains' C interfaces (gemm::Precision in
# csrc/gemm_tf32.cuh): which instance of the GEMM block their products run.
_PRECISION = {"highest": 0, "default": 1}


def _precision_code(precision: str) -> int:
    """The C code of a kernel precision, ``'default'`` or ``'highest'``."""
    if precision not in _PRECISION:
        raise ValueError(
            f"fused kernels support precision 'default' or 'highest', got "
            f"{precision!r}"
        )
    return _PRECISION[precision]


def _stream_mix_dtype(precision: str) -> torch.dtype:
    """Storage dtype of the streamed split's ``mix`` / ``d_mix`` round
    trips, JAX's ``_stream_mix_dtype`` without its env override: bf16 at
    ``'default'`` (on every device: an explicit dtype, not the platform's
    dot), f32 at ``'highest'``."""
    return torch.bfloat16 if precision == "default" else torch.float32


def _mm(a: torch.Tensor, b: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """``a @ b`` at the ambient matmul mode, or with ``tf32`` as the
    kernels' TF32 products compute it: both operands rounded
    (:func:`round_tf32`), then an IEEE f32 product — the products of two
    TF32 values are exact in f32, so only the order of the sums differs
    from the tensor cores'."""
    if not tf32:
        return a @ b
    with matmul_precision("highest"):
        return round_tf32(a) @ round_tf32(b)


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor,
            tf32: bool = False) -> torch.Tensor:
    """``torch.einsum(eq, a, b)``, with ``tf32`` as :func:`_mm`."""
    if not tf32:
        return torch.einsum(eq, a, b)
    with matmul_precision("highest"):
        return torch.einsum(eq, round_tf32(a), round_tf32(b))


def _vjp_wants_streamed(num_heads: int, E: int) -> bool:
    """Whether the differentiable forward (and every training forward)
    takes the streamed split — JAX's ``_vjp_wants_streamed``.  Above the
    resident cap it is the only kernel route (H ≤ 2); below it, H == 2
    from E = 512, where the one-pass multi-head backward kernel replaces
    the torch einsum backward.  Gradient-free eval keeps the resident
    kernel below the cap."""
    if num_heads > _STREAMED_MAX_H:
        return False
    if E > _RESIDENT_E_CAP:
        return True
    return num_heads == 2 and E >= _STREAMED_H2_MIN_E


def _shared_takes(num_heads: int, E: int) -> bool:
    """Whether the shared-query kernels take this (H, E): a call that may
    stream needs E divisible by 4 (the streamed kernels' 16-byte
    accesses)."""
    return E % 4 == 0 or not _vjp_wants_streamed(num_heads, E)


def _split_params(in_w, in_b, out_w):
    """Per-projection weight rows and the bias triple (zeros when the pool
    has no bias — the kernels always add biases)."""
    E = out_w.shape[0]
    wq, wk, wv = in_w.chunk(3, dim=0)
    if in_b is not None:
        bq, bk, bv = in_b.chunk(3, dim=0)
    else:
        bq = bk = bv = in_w.new_zeros(E)
    return wq, wk, wv, bq, bk, bv


def _pad_bias_rows(key_padding_mask: Optional[torch.Tensor]):
    """(B, M) additive score bias: 0 for live slots, -1e30 for padded ones;
    None (no bias) when there is no mask."""
    if key_padding_mask is None:
        return None
    return torch.where(key_padding_mask, -1e30, 0.0).to(torch.float32)


def _prep_tensors(in_w, in_b, out_w, out_b, qrow, num_heads: int):
    """:func:`_prep` on the parameter tensors; also returns ``qp`` and the
    score scale, which the backwards need.  Its GEMVs and ``W_vo`` run at
    the ambient matmul mode: its callers run it under their ``precision``
    (:func:`matmul_precision`), forward and backward alike."""
    E = qrow.shape[-1]
    H = num_heads
    Dh = E // H
    wq, wk, wv, bq, bk, bv = _split_params(in_w, in_b, out_w)
    bo = out_b if out_b is not None else qrow.new_zeros(E)
    scale = Dh ** -0.5
    qp = qrow @ wq.T + bq  # (E,)
    qph = qp.reshape(H, Dh)
    u = scale * torch.einsum("hd,hde->he", qph, wk.reshape(H, Dh, E))
    c = scale * (qph * bk.reshape(H, Dh)).sum(-1)  # (H,)
    if H == 1:
        ctxw = (u.contiguous(), c, out_w @ wv, out_w @ bv + bo, None, None)
    else:
        ctxw = (u.contiguous(), c, wv.contiguous(), bv.contiguous(), out_w, bo)
    return ctxw, qp, scale


def _prep(params: AttentionPoolParams, qrow: torch.Tensor, num_heads: int):
    """Per-call precompute (tiny GEMVs): score vectors ``u (H, E)``, offsets
    ``c (H,)`` and the context weights — ``W_vo``/``b_ctx`` for H == 1
    (``wo``/``bo`` then None), ``Wv``/``bv`` plus ``Wo``/``bo`` for H > 1."""
    return _prep_tensors(
        params.in_proj_weight, params.in_proj_bias, params.out_proj_weight,
        params.out_proj_bias, qrow, num_heads,
    )[0]


def _entropy(w: torch.Tensor) -> torch.Tensor:
    """The kernels' epilogue entropy: ``clip(-Σ w log(max(w, 1e-38)),
    0, ln M)`` over the last axis, zero-weight slots contributing 0."""
    M = w.shape[-1]
    max_entropy = math.log(M) if M > 1 else 0.0
    plogp = torch.where(w > 0, w * torch.log(w.clamp_min(1e-38)), 0.0)
    return (-plogp.sum(dim=-1)).clamp(0.0, max_entropy)


def _side_outputs(w, ent, *, training, seed, mask_prob, min_active):
    """``(mw, rate)``: eval passes ``w`` through with rate 0; training runs
    the Philox mask chain (M > 1)."""
    B, M = w.shape
    if not training or M <= 1:
        return w.clone(), torch.zeros_like(ent)  # its own tensor, as the kernel's
    mw, rate, _ = mask_and_renorm(
        w, ent, mask_uniforms(seed, B, M, w.device), mask_prob=mask_prob,
        min_active=min_active,
    )
    return mw, rate


def quantize_features(kv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(row, modality) symmetric int8 quantization of ``(B, M, E)``
    features: ``(kv_int8, scales (B, M) f32)`` for the quantized path of
    :func:`fused_fusion_pool_shared` — JAX's ``quantize_features``, equal
    to it bit for bit (``torch.round`` rounds half to even, as
    ``jnp.round``)."""
    absmax = kv.abs().amax(dim=-1)
    scales = torch.where(absmax > 0, absmax / 127.0, 1.0).to(torch.float32)
    q = torch.clamp(torch.round(kv / scales[..., None]), -127, 127)
    return q.to(torch.int8), scales


def _dequant(kv: torch.Tensor, kv_scales: Optional[torch.Tensor]) -> torch.Tensor:
    """The f32 features every plain version computes on (JAX's
    ``_kv_tile_slices``): ``kv`` upcast, or int8 times its ``(B, M)``
    scales — the values the kernels read."""
    x = kv.float()
    return x if kv_scales is None else x * kv_scales[..., None]


def _check_kv_scales(kv, kv_scales, *, want_dkv=False) -> None:
    """int8 features come with f32 ``(B, M)`` scales on kv's device and
    are frozen; float features take no scales."""
    if kv.dtype == torch.int8:
        if kv_scales is None:
            raise ValueError("int8 kv requires kv_scales (see quantize_features)")
        if want_dkv:
            raise ValueError("int8 features are frozen: no d_kv")
        _check_f32(kv, {"kv_scales": (kv_scales, tuple(kv.shape[:2]))},
                   why="int8 kv")
    elif kv_scales is not None:
        raise ValueError(
            f"kv_scales passed with {kv.dtype} kv — the quantized path needs "
            "int8 features (see quantize_features)"
        )


def _softmax_heads(x, u, c, pad_bias) -> torch.Tensor:
    """Per-head softmax weights ``a (B, H, M)`` of the scores
    ``x·u_h + c_h + pad`` on the f32 features ``x``."""
    s = torch.einsum("bme,he->bhm", x, u) + c[None, :, None]
    if pad_bias is not None:
        s = s + pad_bias[:, None, :]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _context(mix, wctx, bctx, wo, bo, *, tf32: bool = False):
    """The context GEMMs on the per-head mixes ``(B, H·E)`` (f32, or the
    streamed split's bf16, read upcast): ``out = mix W_voᵀ + b_ctx`` (H ==
    1); the per-head V projection, then ``out = ctx Woᵀ + bo`` (H > 1).
    ``tf32``: as the forward chain's TF32 products (:func:`_mm`)."""
    mix = mix.float()
    E = wctx.shape[0]
    B = mix.shape[0]
    H = mix.shape[1] // E
    if H == 1:
        return _mm(mix, wctx.T, tf32) + bctx
    ctx = _einsum(
        "bhe,hde->bhd", mix.reshape(B, H, E), wctx.reshape(H, E // H, E), tf32
    ).reshape(B, E) + bctx
    return _mm(ctx, wo.T, tf32) + bo


def stream_mix_plain(
    kv: torch.Tensor,  # (B, M, E) f32, bf16 or int8
    u: torch.Tensor,  # (H, E)
    c: torch.Tensor,  # (H,)
    pad_bias: Optional[torch.Tensor],  # (B, M) or None
    *,
    kv_scales: Optional[torch.Tensor] = None,  # (B, M), int8 kv only
    training: bool = False,
    seed: Tuple[int, int] = (0, 0),
    mask_prob: float = 0.15,
    min_active: int = 1,
    precision: str = "highest",
) -> Tuple[torch.Tensor, ...]:
    """The streamed forward kernel's function in plain PyTorch: ``(mix
    (B, H·E), w (B,M), mw (B,M), ent (B,), rate (B,))``, ``mix`` the
    per-head ``Σ_m a_hm kv_m`` side by side, summed in f32 and stored in
    f32, or in bf16 at ``precision='default'`` (:func:`_stream_mix_dtype`).
    Eval: ``mw = w``, ``rate = 0``.  Training (M > 1) masks with the
    uniforms of :func:`.draws.mask_uniforms` for ``seed``."""
    B, M, E = kv.shape
    H = u.shape[0]
    x = _dequant(kv, kv_scales)
    a = _softmax_heads(x, u, c, pad_bias)  # (B, H, M)
    w = a.sum(dim=1) * (1.0 / H)
    ent = _entropy(w)
    mix = torch.einsum("bhm,bme->bhe", a, x).reshape(B, H * E)
    mix = mix.to(_stream_mix_dtype(precision))
    mw, rate = _side_outputs(
        w, ent, training=training, seed=seed, mask_prob=mask_prob,
        min_active=min_active,
    )
    return mix, w, mw, ent, rate


def shared_query_fwd_plain(
    kv: torch.Tensor,  # (B, M, E) f32, bf16 or int8 (kv_scales= then)
    u: torch.Tensor,  # (H, E)
    c: torch.Tensor,  # (H,)
    pad_bias: Optional[torch.Tensor],  # (B, M) or None
    wctx: torch.Tensor,  # (E, E): W_vo (H == 1) or Wv (H > 1)
    bctx: torch.Tensor,  # (E,)
    wo: Optional[torch.Tensor],  # (E, E), H > 1 only
    bo: Optional[torch.Tensor],  # (E,), H > 1 only
    *,
    tf32: bool = False,
    **mask_kw,
) -> Tuple[torch.Tensor, ...]:
    """The kernel's function in plain PyTorch: ``(out (B,E), w (B,M),
    mw (B,M), ent (B,), rate (B,))`` — :func:`stream_mix_plain` (whose
    ``kv_scales``, ``training``, ``seed``, ``mask_prob`` and
    ``min_active`` it takes) with an f32 ``mix``, then the context GEMMs,
    with ``tf32`` as the chain computes them at ``precision='default'``
    on the card."""
    mix, w, mw, ent, rate = stream_mix_plain(kv, u, c, pad_bias, **mask_kw)
    return _context(mix, wctx, bctx, wo, bo, tf32=tf32), w, mw, ent, rate


def _check_operands(kv, u, c, pad_bias, wctx, bctx, wo, bo,
                    kv_scales) -> None:
    if kv.ndim != 3:
        raise ValueError(f"kv must be (B, M, E), got shape {tuple(kv.shape)}")
    B, M, E = kv.shape
    H = u.shape[0] if u.ndim == 2 else -1
    if B < 1:
        raise ValueError("kv must have at least one row")
    if not 1 <= M <= _MAX_M:
        raise ValueError(f"kernel takes 1 <= M <= {_MAX_M}, got M={M}")
    if H < 1 or E % H:
        raise ValueError(_HEADS.format(H=H, E=E))
    if E > _RESIDENT_E_CAP:
        raise ValueError(f"kernel takes E <= {_RESIDENT_E_CAP}, got E={E}")
    if kv.dtype not in _KV_DTYPE:
        raise TypeError(
            f"kv must be float32 or bfloat16, or int8 with kv_scales, got "
            f"{kv.dtype}")
    _check_kv_scales(kv, kv_scales)
    _check_f32(kv, {
        "u": (u, (H, E)),
        "c": (c, (H,)),
        "pad_bias": (pad_bias, (B, M)),
        "wctx": (wctx, (E, E)),
        "bctx": (bctx, (E,)),
        "wo": (wo, (E, E) if H > 1 else None),
        "bo": (bo, (E,) if H > 1 else None),
    }, optional=("pad_bias",), why=f"H == {H}")


def _check_f32(kv, want, *, optional=(), why=""):
    """Each named operand is f32 of its shape on kv's device; ``None``
    shapes must be absent, names in ``optional`` may be."""
    for name, (t, shape) in want.items():
        if shape is None:
            if t is not None:
                raise ValueError(f"{name} must be None for {why}")
            continue
        if t is None:
            if name in optional:
                continue
            raise ValueError(f"{name} is required for {why}")
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(
                f"{name} must be float32 {shape}, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
        if t.device != kv.device:
            raise ValueError(f"{name} is on {t.device}, kv on {kv.device}")


def _require_cuda(kv, operands: Dict[str, Optional[torch.Tensor]]) -> None:
    if kv.device.type != "cuda":
        raise ValueError(f"no kernel for device {kv.device}")
    for name, t in operands.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _aligned16(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t``, or a copy of it that starts on 16 bytes: the chains' GEMMs
    read their operands in 16-byte chunks."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def _require_aligned(operands: Dict[str, Optional[torch.Tensor]]) -> None:
    """The streamed kernels access these four elements at a time: 16 bytes
    of f32, 8 of bf16."""
    for name, t in operands.items():
        if t is not None and t.data_ptr() % (4 * t.element_size()):
            raise ValueError(
                f"{name} must be aligned to {4 * t.element_size()} bytes"
            )


def _raise_on_error(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} launch failed: "
            f"{lib.aecf_cuda_error_string(err).decode()} ({err})"
        )


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _count_launch(wrapper, kv: torch.Tensor) -> None:
    """One launch on ``wrapper``'s count: ``launches_q8`` for int8
    features, ``launches`` for f32/bf16."""
    if kv.dtype == torch.int8:
        wrapper.launches_q8 += 1
    else:
        wrapper.launches += 1


def _require_device(kv: torch.Tensor) -> None:
    """Only the CPU (the plain version) and CUDA (the kernel) have an
    implementation: a tensor elsewhere raises before it reaches an op,
    whose fake implementation would otherwise answer for the meta
    device."""
    if kv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {kv.device}")


# The five outputs of the forward ops: (out or mix, w, mw, ent, rate).
_FWD_OUTS = "(Tensor, Tensor, Tensor, Tensor, Tensor)"
_MASK_ARGS = "bool training, int seed0, int seed1, float mask_prob, int min_active"


def _fake_outs(kv: torch.Tensor, width: int) -> Tuple[torch.Tensor, ...]:
    """The forward ops' outputs as empty tensors on ``kv``'s device: ``(B,
    width)``, ``(B, M)`` twice, ``(B,)`` twice, f32."""
    B, M = kv.shape[0], kv.shape[1]
    f = lambda *shape: kv.new_empty(shape, dtype=torch.float32)  # noqa: E731
    return f(B, width), f(B, M), f(B, M), f(B), f(B)


def shared_query_fwd(
    kv: torch.Tensor,
    u: torch.Tensor,
    c: torch.Tensor,
    pad_bias: Optional[torch.Tensor],
    wctx: torch.Tensor,
    bctx: torch.Tensor,
    wo: Optional[torch.Tensor] = None,
    bo: Optional[torch.Tensor] = None,
    *,
    kv_scales: Optional[torch.Tensor] = None,
    training: bool = False,
    seed: Tuple[int, int] = (0, 0),
    mask_prob: float = 0.15,
    min_active: int = 1,
    precision: str = "highest",
) -> Tuple[torch.Tensor, ...]:
    """Wrapper of ``csrc/shared_query_fwd.cu`` (``_shared_kernel``, and
    ``_shared_kernel_q8`` for int8 ``kv`` with ``kv_scales``); operands as
    in :func:`shared_query_fwd_plain`, any E ≤ 1024 that H divides.
    ``precision='default'`` runs the chain's products on the TF32 tensor
    cores (the plain version with ``tf32=True`` is their function); the
    CPU's plain version computes them in IEEE f32 at both.

    It validates the operands and calls the custom op
    ``aecf_tpu_torch::shared_query_fwd``, so ``torch.export`` records the
    kernel as one node.  CPU tensors run the plain version.  CUDA tensors
    launch the kernel chain or raise — there is no fallback.
    ``shared_query_fwd.launches`` counts f32/bf16 calls and
    ``shared_query_fwd.launches_q8`` int8 ones, one a call whatever the
    chain launches (the plain version does not count).  The outputs carry
    no autograd graph: :func:`fused_fusion_pool_shared` is the
    differentiable entry.
    """
    _check_operands(kv, u, c, pad_bias, wctx, bctx, wo, bo, kv_scales)
    _require_device(kv)
    return _shared_query_fwd_op(
        kv, u, c, pad_bias, wctx, bctx, wo, bo, kv_scales, bool(training),
        int(seed[0]), int(seed[1]), float(mask_prob), int(min_active),
        _precision_code(precision),
    )


@torch.library.custom_op(
    "aecf_tpu_torch::shared_query_fwd", mutates_args=(),
    schema="(Tensor kv, Tensor u, Tensor c, Tensor? pad_bias, Tensor wctx, "
           "Tensor bctx, Tensor? wo, Tensor? bo, Tensor? kv_scales, "
           f"{_MASK_ARGS}, int precision=0) -> {_FWD_OUTS}",
)
def _shared_query_fwd_op(kv, u, c, pad_bias, wctx, bctx, wo, bo, kv_scales,
                         training, seed0, seed1, mask_prob, min_active,
                         precision=0):
    B, M, E = kv.shape
    H = u.shape[0]
    # resolved in the op's body: a frozen program follows the table of the
    # process that runs it
    plans = _pick_plan("fwd_resident", sq_fwd_products(B, E, H), M=M, E=E,
                       H=H, kv_dtype=dtype_name(kv.dtype), device=kv.device)
    if kv.device.type == "cpu":
        return shared_query_fwd_plain(
            kv, u, c, pad_bias, wctx, bctx, wo, bo, kv_scales=kv_scales,
            training=training, seed=(seed0, seed1), mask_prob=mask_prob,
            min_active=min_active,
        )
    _require_cuda(kv, dict(kv=kv, kv_scales=kv_scales, u=u, c=c,
                           pad_bias=pad_bias, wctx=wctx, bctx=bctx, wo=wo,
                           bo=bo))
    out = torch.empty((B, E), dtype=torch.float32, device=kv.device)
    w = torch.empty((B, M), dtype=torch.float32, device=kv.device)
    mw = torch.empty_like(w)
    ent = torch.empty((B,), dtype=torch.float32, device=kv.device)
    rate = torch.empty_like(ent)
    lib = _fwd_library()
    ws = torch.empty((lib.aecf_shared_query_fwd_workspace(B, M, E, H, plans),),
                     dtype=torch.float32, device=kv.device)
    wctx, wo = _aligned16(wctx), _aligned16(wo)
    with torch.cuda.device(kv.device):
        err = lib.aecf_shared_query_fwd(
            _ptr(kv), _KV_DTYPE[kv.dtype], _ptr(kv_scales),
            _ptr(u), _ptr(c), _ptr(pad_bias), _ptr(wctx), _ptr(wo),
            _ptr(bctx), _ptr(bo), _ptr(out), _ptr(w), _ptr(mw), _ptr(ent),
            _ptr(rate), _ptr(ws), B, M, E, H,
            math.log(M) if M > 1 else 0.0,
            int(training), seed0, seed1, mask_prob, min_active, precision,
            plans, torch.cuda.current_stream(kv.device).cuda_stream,
        )
    _raise_on_error(lib, err, "shared_query_fwd")
    _count_launch(shared_query_fwd, kv)
    return out, w, mw, ent, rate


@_shared_query_fwd_op.register_fake
def _(kv, u, c, pad_bias, wctx, bctx, wo, bo, kv_scales, *mask):
    return _fake_outs(kv, kv.shape[2])


shared_query_fwd.launches = shared_query_fwd.launches_q8 = 0


def philox_on_device(rows: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 of each ``(c0, c1, c2, c3, k0, k1)`` row of ``rows``
    (int64 words) computed by the CUDA kernels' device code; returns the
    ``(n, 4)`` words as int64.  The known-answer check of the generator
    the kernels draw with."""
    if rows.device.type != "cuda":
        raise ValueError("the device generator runs on a CUDA tensor")
    words = rows.to(torch.int32).contiguous()  # two's-complement uint32
    out = torch.empty((rows.shape[0], 4), dtype=torch.int32,
                      device=rows.device)
    lib = _fwd_library()
    with torch.cuda.device(rows.device):
        err = lib.aecf_philox4x32_10(
            words.data_ptr(), out.data_ptr(), rows.shape[0],
            torch.cuda.current_stream(rows.device).cuda_stream,
        )
    _raise_on_error(lib, err, "philox4x32_10")
    return out.to(torch.int64) & 0xFFFFFFFF


def _bind_error_string(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.aecf_cuda_error_string.argtypes = [ctypes.c_int]
    lib.aecf_cuda_error_string.restype = ctypes.c_char_p
    return lib


# (kv, kv_dtype, scales, *pointers, B, M, E, H, max_entropy, training,
# seed0, seed1, mask_prob, min_active, precision or mix dtype, plan, stream)
# of the two forward kernels' C entries; `plan` is of type `plan`
def _fwd_argtypes(pointers: int, plan):
    p, i, u32, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    return ([p, i, p] + [p] * pointers
            + [i, i, i, i, f, i, u32, u32, f, i, i, plan, p])


_TILES = ctypes.POINTER(GemmTile)


@functools.cache
def _fwd_library() -> ctypes.CDLL:
    lib = load_library("shared_query_fwd")
    lib.aecf_shared_query_fwd_workspace.argtypes = [ctypes.c_int] * 4 + [
        _TILES]
    lib.aecf_shared_query_fwd_workspace.restype = ctypes.c_size_t
    lib.aecf_shared_query_fwd_plans.argtypes = [ctypes.c_int] * 3 + [
        _TILES, ctypes.POINTER(ctypes.c_int)]
    lib.aecf_shared_query_fwd_plans.restype = ctypes.c_int
    lib.aecf_shared_query_fwd.argtypes = _fwd_argtypes(13, _TILES)
    lib.aecf_shared_query_fwd.restype = ctypes.c_int
    lib.aecf_philox4x32_10.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.aecf_philox4x32_10.restype = ctypes.c_int
    return _bind_error_string(lib)


# ---- the streamed forward ----------------------------------------------------


def _check_stream(kv: torch.Tensor, H: int) -> Tuple[int, int, int]:
    """Widths every streamed kernel takes; returns ``(B, M, E)``."""
    if kv.ndim != 3 or kv.dtype not in _KV_DTYPE:
        raise ValueError(
            f"kv must be float32/bfloat16/int8 (B, M, E), got {kv.dtype} "
            f"{tuple(kv.shape)}"
        )
    B, M, E = kv.shape
    if (B < 1 or not 1 <= M <= _MAX_M or not 1 <= H <= _STREAMED_MAX_H
            or E % 4):
        raise ValueError(
            f"the streamed kernels take B >= 1, 1 <= M <= {_MAX_M}, "
            f"1 <= H <= {_STREAMED_MAX_H} and E divisible by 4, got B={B}, "
            f"M={M}, H={H}, E={E}"
        )
    return B, M, E


def stream_mix(
    kv: torch.Tensor,
    u: torch.Tensor,
    c: torch.Tensor,
    pad_bias: Optional[torch.Tensor],
    *,
    kv_scales: Optional[torch.Tensor] = None,
    training: bool = False,
    seed: Tuple[int, int] = (0, 0),
    mask_prob: float = 0.15,
    min_active: int = 1,
    precision: str = "highest",
) -> Tuple[torch.Tensor, ...]:
    """Wrapper of ``csrc/stream_mix.cu``; operands and results as in
    :func:`stream_mix_plain` (``mix`` in bf16 at ``precision='default'``).
    It validates the operands and calls the custom op
    ``aecf_tpu_torch::stream_mix``: CPU tensors run the plain version; CUDA
    tensors launch the kernel or raise.
    ``stream_mix.launches`` counts f32/bf16 launches,
    ``stream_mix.launches_q8`` int8 ones."""
    H = u.shape[0] if u.ndim == 2 else -1
    B, M, E = _check_stream(kv, H)
    _check_kv_scales(kv, kv_scales)
    _check_f32(kv, {"u": (u, (H, E)), "c": (c, (H,)),
                    "pad_bias": (pad_bias, (B, M))},
               optional=("pad_bias",), why="the streamed forward")
    _require_device(kv)
    _precision_code(precision)
    return _stream_mix_op(kv, u, c, pad_bias, kv_scales, bool(training),
                          int(seed[0]), int(seed[1]), float(mask_prob),
                          int(min_active),
                          _KV_DTYPE[_stream_mix_dtype(precision)])


@torch.library.custom_op(
    "aecf_tpu_torch::stream_mix", mutates_args=(),
    schema="(Tensor kv, Tensor u, Tensor c, Tensor? pad_bias, "
           f"Tensor? kv_scales, {_MASK_ARGS}, int mix_dtype=0) -> {_FWD_OUTS}",
)
def _stream_mix_op(kv, u, c, pad_bias, kv_scales, training, seed0, seed1,
                   mask_prob, min_active, mix_dtype=0):
    B, M, E = kv.shape
    H = u.shape[0]
    per_sm = _pick_grid("fwd_streamed", M=M, E=E, H=H,
                        kv_dtype=dtype_name(kv.dtype))
    if kv.device.type == "cpu":
        return stream_mix_plain(
            kv, u, c, pad_bias, kv_scales=kv_scales, training=training,
            seed=(seed0, seed1), mask_prob=mask_prob, min_active=min_active,
            precision="default" if mix_dtype else "highest",
        )
    _require_cuda(kv, dict(kv=kv, kv_scales=kv_scales, u=u, c=c,
                           pad_bias=pad_bias))
    _require_aligned(dict(kv=kv, u=u))
    dev = kv.device
    mix = torch.empty((B, H * E), device=dev,
                      dtype=torch.bfloat16 if mix_dtype else torch.float32)
    w = torch.empty((B, M), dtype=torch.float32, device=dev)
    mw = torch.empty_like(w)
    ent = torch.empty((B,), dtype=torch.float32, device=dev)
    rate = torch.empty_like(ent)
    lib = _mix_library()
    with torch.cuda.device(dev):
        err = lib.aecf_stream_mix(
            _ptr(kv), _KV_DTYPE[kv.dtype], _ptr(kv_scales), _ptr(u), _ptr(c),
            _ptr(pad_bias), _ptr(mix), _ptr(w), _ptr(mw), _ptr(ent),
            _ptr(rate), B, M, E, H, math.log(M) if M > 1 else 0.0,
            int(training), seed0, seed1, mask_prob, min_active, mix_dtype,
            per_sm, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on_error(lib, err, "stream_mix")
    _count_launch(stream_mix, kv)
    return mix, w, mw, ent, rate


@_stream_mix_op.register_fake
def _(kv, u, c, pad_bias, kv_scales, training, seed0, seed1, mask_prob,
      min_active, mix_dtype=0):
    mix, *rest = _fake_outs(kv, u.shape[0] * kv.shape[2])
    return (mix.to(torch.bfloat16) if mix_dtype else mix, *rest)


stream_mix.launches = stream_mix.launches_q8 = 0


@functools.cache
def _mix_library() -> ctypes.CDLL:
    lib = load_library("stream_mix")
    lib.aecf_stream_mix.argtypes = _fwd_argtypes(8, ctypes.c_int)
    lib.aecf_stream_mix.restype = ctypes.c_int
    lib.aecf_stream_mix_occupancy.argtypes = [ctypes.c_int] * 5
    lib.aecf_stream_mix_occupancy.restype = ctypes.c_int
    return _bind_error_string(lib)


# ---- the backwards -----------------------------------------------------------


def stream_bwd_plain(
    kv: torch.Tensor,  # (B, M, E) f32, bf16 or int8
    d_mix: torch.Tensor,  # (B, H·E)
    d_w: Optional[torch.Tensor],  # (B, M) or None
    pad_bias: Optional[torch.Tensor],  # (B, M) or None
    u: torch.Tensor,  # (H, E)
    c: torch.Tensor,  # (H,)
    *,
    want_dkv: bool,
    kv_scales: Optional[torch.Tensor] = None,  # (B, M), int8 kv only
) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """The streamed backward kernels' function in plain PyTorch: from the
    mix cotangent ``d_mix`` (f32, or bf16 at ``precision='default'``, read
    upcast) and the head-mean weights cotangent ``d_w`` (``d_w / H`` on
    each head), ``(d_kv (B,M,E) in kv's dtype or None, du (H,E) = Σ_b Σ_m
    d_s·kv, dc (H,) = Σ d_s)``, ``d_kv`` summed over heads (float features
    only)."""
    B, M, E = kv.shape
    H = u.shape[0]
    x = _dequant(kv, kv_scales)
    a = _softmax_heads(x, u, c, pad_bias)  # (B, H, M)
    dm = d_mix.float().reshape(B, H, E)
    d_a = torch.einsum("bhe,bme->bhm", dm, x)
    if d_w is not None:
        d_a = d_a + d_w[:, None, :] / H
    d_s = a * (d_a - (a * d_a).sum(dim=-1, keepdim=True))
    d_kv = None
    if want_dkv:
        d_kv = (
            torch.einsum("bhm,bhe->bme", a, dm)
            + torch.einsum("bhm,he->bme", d_s, u)
        ).to(kv.dtype)
    return d_kv, torch.einsum("bhm,bme->he", d_s, x), d_s.sum(dim=(0, 2))


class _StreamBwdParams(ctypes.Structure):
    """``StreamBwdParams`` of ``csrc/stream_bwd.cu``, field for field."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in ("kv", "scales", "dmix", "dw", "pad", "u", "c", "dkv",
                     "acc", "ws")
    ] + [(name, ctypes.c_int)
         for name in ("B", "M", "E", "kv_dtype", "dmix_dtype",
                      "blocks_per_sm")]


def _stream_bwd(entry, H, kv, d_mix, d_w, pad_bias, u, c, want_dkv,
                kv_scales):
    """Checks and the launch behind :func:`stream_bwd` (``H == 1``) and
    :func:`stream_bwd_mh` (``H == 2``); None for CPU tensors."""
    if u.ndim != 2 or u.shape[0] != H:
        raise ValueError(f"{entry} takes u (H, E) with H == {H}, got "
                         f"{tuple(u.shape)}")
    B, M, E = _check_stream(kv, H)
    _check_kv_scales(kv, kv_scales, want_dkv=want_dkv)
    if (d_mix.dtype not in (torch.float32, torch.bfloat16)
            or tuple(d_mix.shape) != (B, H * E) or d_mix.device != kv.device):
        raise ValueError(
            f"d_mix must be float32 or bfloat16 {(B, H * E)} on {kv.device}, "
            f"got {d_mix.dtype} {tuple(d_mix.shape)} on {d_mix.device}"
        )
    _check_f32(kv, {
        "d_w": (d_w, (B, M)), "pad_bias": (pad_bias, (B, M)),
        "u": (u, (H, E)), "c": (c, (H,)),
    }, optional=("d_w", "pad_bias"), why="the streamed backward")
    # the f32 call's key whatever the dtype: the grid sets the order of the
    # batch sums, which an int8 or bf16 call takes from the f32 call
    per_sm = _pick_grid("bwd_streamed", M=M, E=E, H=H, kv_dtype="float32",
                        want_dkv=want_dkv)
    if kv.device.type == "cpu":
        return None
    _require_cuda(kv, dict(kv=kv, kv_scales=kv_scales, d_mix=d_mix, d_w=d_w,
                           pad_bias=pad_bias, u=u, c=c))
    _require_aligned(dict(kv=kv, d_mix=d_mix, u=u))
    lib = _stream_bwd_library()
    dev = kv.device
    d_kv = torch.empty_like(kv) if want_dkv else None
    acc = torch.empty((H * E + H,), dtype=torch.float32, device=dev)
    ws = torch.empty((lib.aecf_stream_bwd_workspace(B, M, E, H, per_sm),),
                     dtype=torch.float32, device=dev)
    params = _StreamBwdParams(
        _ptr(kv), _ptr(kv_scales), _ptr(d_mix), _ptr(d_w), _ptr(pad_bias),
        _ptr(u), _ptr(c), _ptr(d_kv), _ptr(acc), _ptr(ws), B, M, E,
        _KV_DTYPE[kv.dtype], _KV_DTYPE[d_mix.dtype], per_sm,
    )
    with torch.cuda.device(dev):
        err = getattr(lib, f"aecf_{entry}")(
            ctypes.byref(params), torch.cuda.current_stream(dev).cuda_stream
        )
    _raise_on_error(lib, err, entry)
    return d_kv, acc[: H * E].view(H, E), acc[H * E :]


def stream_bwd(
    kv: torch.Tensor,
    d_mix: torch.Tensor,
    d_w: Optional[torch.Tensor],
    pad_bias: Optional[torch.Tensor],
    u: torch.Tensor,
    c: torch.Tensor,
    *,
    want_dkv: bool,
    kv_scales: Optional[torch.Tensor] = None,
) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Wrapper of ``csrc/stream_bwd.cu`` at H == 1 (the port of
    ``_bwd_kernel_streamed``); operands and results as in
    :func:`stream_bwd_plain`, ``d_mix`` f32 or bf16 (its instance of the
    kernel stages the bf16 row).  CPU tensors run the plain version; CUDA
    tensors launch the kernel or raise.  ``stream_bwd.launches`` counts
    f32/bf16 launches, ``stream_bwd.launches_q8`` int8 ones."""
    got = _stream_bwd("stream_bwd", 1, kv, d_mix, d_w, pad_bias, u, c,
                      want_dkv, kv_scales)
    if got is None:
        return stream_bwd_plain(kv, d_mix, d_w, pad_bias, u, c,
                                want_dkv=want_dkv, kv_scales=kv_scales)
    _count_launch(stream_bwd, kv)
    return got


def stream_bwd_mh(
    kv: torch.Tensor,
    d_mix: torch.Tensor,
    d_w: Optional[torch.Tensor],
    pad_bias: Optional[torch.Tensor],
    u: torch.Tensor,
    c: torch.Tensor,
    *,
    want_dkv: bool,
    kv_scales: Optional[torch.Tensor] = None,
) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Wrapper of ``csrc/stream_bwd.cu`` at H == 2 (the port of
    ``_bwd_kernel_streamed_mh``); as :func:`stream_bwd`, counting in
    ``stream_bwd_mh.launches`` and ``stream_bwd_mh.launches_q8``."""
    got = _stream_bwd("stream_bwd_mh", 2, kv, d_mix, d_w, pad_bias, u, c,
                      want_dkv, kv_scales)
    if got is None:
        return stream_bwd_plain(kv, d_mix, d_w, pad_bias, u, c,
                                want_dkv=want_dkv, kv_scales=kv_scales)
    _count_launch(stream_bwd_mh, kv)
    return got


stream_bwd.launches = stream_bwd.launches_q8 = 0
stream_bwd_mh.launches = stream_bwd_mh.launches_q8 = 0


@functools.cache
def _stream_bwd_library() -> ctypes.CDLL:
    lib = load_library("stream_bwd")
    lib.aecf_stream_bwd_workspace.argtypes = [ctypes.c_int] * 5
    lib.aecf_stream_bwd_workspace.restype = ctypes.c_size_t
    lib.aecf_stream_bwd_occupancy.argtypes = [ctypes.c_int] * 3
    lib.aecf_stream_bwd_occupancy.restype = ctypes.c_int
    for entry in (lib.aecf_stream_bwd, lib.aecf_stream_bwd_mh):
        entry.argtypes = [ctypes.POINTER(_StreamBwdParams), ctypes.c_void_p]
        entry.restype = ctypes.c_int
    return _bind_error_string(lib)


def shared_query_bwd_plain(
    kv: torch.Tensor,  # (B, M, E) f32, bf16 or int8
    u: torch.Tensor,  # (E,)
    c: torch.Tensor,  # (1,)
    pad_bias: Optional[torch.Tensor],  # (B, M) or None
    d_out: torch.Tensor,  # (B, E)
    d_w: Optional[torch.Tensor],  # (B, M) or None
    wvo: torch.Tensor,  # (E, E)
    *,
    want_dkv: bool,
    kv_scales: Optional[torch.Tensor] = None,  # (B, M), int8 kv only
    tf32: bool = False,
) -> Tuple[Optional[torch.Tensor], ...]:
    """The backward kernel's function in plain PyTorch.  Returns ``(d_kv
    (B,M,E) in kv's dtype or None, G (E,E) = Σ_b d_outᵀ mix, du (E,),
    Σ_b d_out (E,), dc = Σ d_s (0-d))``; ``tf32``: ``d_mix`` and G as the
    chain computes them at ``precision='default'`` on the card
    (:func:`_mm`)."""
    mix = stream_mix_plain(kv, u[None], c, pad_bias, kv_scales=kv_scales)[0]
    d_kv, du, dc = stream_bwd_plain(kv, _mm(d_out, wvo, tf32), d_w, pad_bias,
                                    u[None], c, want_dkv=want_dkv,
                                    kv_scales=kv_scales)
    return d_kv, _mm(d_out.T, mix, tf32), du[0], d_out.sum(dim=0), dc[0]


def shared_query_bwd(
    kv: torch.Tensor,
    u: torch.Tensor,
    c: torch.Tensor,
    pad_bias: Optional[torch.Tensor],
    d_out: torch.Tensor,
    d_w: Optional[torch.Tensor],
    wvo: torch.Tensor,
    *,
    want_dkv: bool,
    kv_scales: Optional[torch.Tensor] = None,
    precision: str = "highest",
) -> Tuple[Optional[torch.Tensor], ...]:
    """Wrapper of ``csrc/shared_query_bwd.cu`` (``_bwd_kernel``, and its
    ``quantized=True`` branch for int8 ``kv`` with ``kv_scales``); operands
    and results as in :func:`shared_query_bwd_plain`, every width the
    forward takes at H == 1 (any E ≤ 1024); ``precision='default'`` runs
    ``d_mix`` and G on the TF32 tensor cores.  Every limit is checked
    before the dispatch: CPU tensors run the plain version (IEEE f32 at
    both precisions); CUDA tensors launch the kernel chain or raise.  ``shared_query_bwd.launches`` counts
    f32/bf16 calls, ``shared_query_bwd.launches_q8`` int8 ones, one a
    call."""
    if kv.ndim != 3 or kv.dtype not in _KV_DTYPE:
        raise ValueError(
            f"kv must be float32/bfloat16/int8 (B, M, E), got {kv.dtype} "
            f"{tuple(kv.shape)}"
        )
    B, M, E = kv.shape
    if B < 1 or not 1 <= M <= _MAX_M or E > _RESIDENT_E_CAP:
        raise ValueError(
            f"kernel takes B >= 1, 1 <= M <= {_MAX_M} and E <= "
            f"{_RESIDENT_E_CAP}, got B={B}, M={M}, E={E}"
        )
    _check_f32(kv, {
        "u": (u, (E,)), "c": (c, (1,)), "pad_bias": (pad_bias, (B, M)),
        "d_out": (d_out, (B, E)), "d_w": (d_w, (B, M)),
        "wvo": (wvo, (E, E)),
    }, optional=("pad_bias", "d_w"), why="the backward")
    _check_kv_scales(kv, kv_scales, want_dkv=want_dkv)
    code = _precision_code(precision)
    plans = _pick_plan("bwd_resident", sq_bwd_products(B, E), M=M, E=E, H=1,
                       kv_dtype=dtype_name(kv.dtype), want_dkv=want_dkv,
                       device=kv.device)
    if kv.device.type == "cpu":
        return shared_query_bwd_plain(kv, u, c, pad_bias, d_out, d_w, wvo,
                                      want_dkv=want_dkv, kv_scales=kv_scales)
    _require_cuda(kv, dict(kv=kv, kv_scales=kv_scales, u=u, c=c,
                           pad_bias=pad_bias, d_out=d_out, d_w=d_w, wvo=wvo))
    d_out, wvo = _aligned16(d_out), _aligned16(wvo)
    lib = _bwd_library()
    dev = kv.device
    d_kv = torch.empty_like(kv) if want_dkv else None
    G = torch.empty((E, E), dtype=torch.float32, device=dev)
    sums = torch.empty((2 * E + 1,), dtype=torch.float32, device=dev)
    ws = torch.empty((lib.aecf_shared_query_bwd_workspace(B, E, plans),),
                     dtype=torch.float32, device=dev)
    params = _BwdParams(
        _ptr(kv), _ptr(kv_scales), _ptr(u), _ptr(c), _ptr(pad_bias),
        _ptr(d_out), _ptr(d_w), _ptr(wvo), _ptr(d_kv), _ptr(G), _ptr(sums),
        _ptr(ws), B, M, E, _KV_DTYPE[kv.dtype], code, plans,
    )
    with torch.cuda.device(dev):
        err = lib.aecf_shared_query_bwd(
            ctypes.byref(params), torch.cuda.current_stream(dev).cuda_stream
        )
    _raise_on_error(lib, err, "shared_query_bwd")
    _count_launch(shared_query_bwd, kv)
    return d_kv, G, sums[:E], sums[E : 2 * E], sums[2 * E]


shared_query_bwd.launches = shared_query_bwd.launches_q8 = 0


class _BwdParams(ctypes.Structure):
    """``BwdParams`` of ``csrc/shared_query_bwd.cu``, field for field."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "kv", "scales", "u", "c", "pad", "dout", "dw", "wvo", "dkv", "g",
            "sums", "ws",
        )
    ] + [(name, ctypes.c_int)
         for name in ("B", "M", "E", "kv_dtype", "precision")] + [
        ("plans", GemmTile * 2)]


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = load_library("shared_query_bwd")
    lib.aecf_shared_query_bwd_workspace.argtypes = [ctypes.c_int] * 2 + [
        _TILES]
    lib.aecf_shared_query_bwd_workspace.restype = ctypes.c_size_t
    lib.aecf_shared_query_bwd_plans.argtypes = [ctypes.c_int] * 2 + [
        _TILES, ctypes.POINTER(ctypes.c_int)]
    lib.aecf_shared_query_bwd_plans.restype = ctypes.c_int
    lib.aecf_shared_query_bwd.argtypes = [
        ctypes.POINTER(_BwdParams), ctypes.c_void_p,
    ]
    lib.aecf_shared_query_bwd.restype = ctypes.c_int
    return _bind_error_string(lib)


def _g_epilogue(G, dsum_out, wv, wo, bv, has_out_bias):
    """``(dWo, dWv, d_bv, dbo)`` from ``G = Σ_b d_out ⊗ mix`` — two E×E
    GEMMs once per call (plain torch, as the JAX package leaves them to
    XLA)."""
    dWo = G @ wv.T + torch.outer(dsum_out, bv)
    dWv = wo.T @ G
    d_bv = dsum_out @ wo
    return dWo, dWv, d_bv, (dsum_out if has_out_bias else None)


def _out_vproj_bwd(d_out, mixh, wvh, wo, bv, has_out_bias):
    """Backward through ``ctx = Σ_h mix_h·Wv_hᵀ + bv; out = ctx Woᵀ + bo``
    (torch GEMMs, as JAX's ``_out_vproj_bwd`` is XLA).  ``mixh`` (B, H, E),
    ``wvh`` (H, Dh, E).  Returns ``(d_mix (B, H, E), dWo, dbo, dWv,
    d_bv)``."""
    B = d_out.shape[0]
    H, Dh, E = wvh.shape
    ctx = torch.einsum("bhe,hde->bhd", mixh, wvh).reshape(B, E) + bv
    d_ctx = d_out @ wo
    d_ctx_h = d_ctx.reshape(B, H, Dh)
    d_mix = torch.einsum("bhd,hde->bhe", d_ctx_h, wvh)
    dWv = torch.einsum("bhd,bhe->hde", d_ctx_h, mixh).reshape(E, E)
    dbo = d_out.sum(0) if has_out_bias else None
    return d_mix, d_out.T @ ctx, dbo, dWv, d_ctx.sum(0)


def _query_path_grads(scale, qph, wkh, bk, du, dc, wq, qrow, has_bias):
    """Query/key-projection backward: ``u_h = scale·(qp_h @ Wk_h)``,
    ``c_h = scale·(qp_h · bk_h)`` ⇒ grads for qp, Wk, bk, Wq and the query
    row.  ``qph`` (H, Dh), ``wkh`` (H, Dh, E), ``du`` (H, E), ``dc`` (H,)."""
    H, Dh = qph.shape
    E = wkh.shape[2]
    bkh = bk.reshape(H, Dh)
    d_qph = scale * (
        torch.einsum("he,hde->hd", du, wkh) + dc[:, None] * bkh
    )
    dWk = (scale * torch.einsum("hd,he->hde", qph, du)).reshape(H * Dh, E)
    d_bk = (scale * dc[:, None] * qph).reshape(H * Dh) if has_bias else None
    d_qp = d_qph.reshape(H * Dh)
    return d_qp, dWk, d_bk, torch.outer(d_qp, qrow), d_qp @ wq


def _assemble_d_params(dWq, dWk, dWv, dWo, d_qp, d_bk, d_bv, dbo, has_bias):
    """Gradients keyed like the pool's parameters (packed in-projection)."""
    return {
        "in_proj_weight": torch.cat([dWq, dWk, dWv], dim=0),
        "out_proj_weight": dWo,
        "in_proj_bias": (
            torch.cat([d_qp, d_bk, d_bv]) if has_bias else None
        ),
        "out_proj_bias": dbo,
    }


def _fold_entropy_cotangent(d_w, d_ent, w):
    """Route an entropy cotangent into the weights cotangent with the
    analytic jacobian ``∂ent/∂w_m = -(log w_m + 1)`` (w > 0), gated by the
    clip interval — never autograd of ``log(max(w, 1e-38))``, whose
    reciprocal of the subnormal floor is infinite."""
    if d_ent is None:
        return d_w
    M = w.shape[-1]
    max_entropy = math.log(M) if M > 1 else 0.0
    safe_w = w.clamp_min(1e-30)  # normal f32: the reciprocal stays finite
    dplogp = torch.where(w > 0, torch.log(safe_w) + 1.0, 0.0)
    ent_raw = -torch.where(w > 0, w * torch.log(safe_w), 0.0).sum(
        dim=-1, keepdim=True
    )
    inside = (ent_raw >= 0.0) & (ent_raw <= max_entropy)
    extra = torch.where(inside, -d_ent[:, None], 0.0) * dplogp
    return extra if d_w is None else d_w + extra


def _bwd_h1(tensors, kpm, d_out, d_w, want_dkv, mix, precision):
    """H == 1 backward: the resident backward kernel (``_bwd_pallas``), or,
    after a streamed forward (``mix`` saved), the ``d_mix``/G GEMMs in
    torch and the streamed kernel (``_bwd_streamed``; ``d_mix`` stored as
    ``mix`` is).  int8 features take the kernels' quantized branches
    (JAX's ``_shared_q8_bwd``).  Called under the forward's matmul mode."""
    in_w, in_b, out_w, out_b, qrow, kv, kv_scales = tensors
    E = kv.shape[-1]
    wq, wk, wv, _, bk, bv = _split_params(in_w, in_b, out_w)
    (u, c, wvo, _, _, _), qp, scale = _prep_tensors(
        in_w, in_b, out_w, out_b, qrow, 1
    )
    pad = _pad_bias_rows(kpm)
    d_out = d_out.contiguous()
    d_w = None if d_w is None else d_w.contiguous()
    if mix is None:
        d_kv, G, du, dsum_out, dc = shared_query_bwd(
            kv, u[0], c, pad, d_out, d_w, wvo, want_dkv=want_dkv,
            kv_scales=kv_scales, precision=precision,
        )
        du, dc = du.reshape(1, E), dc.reshape(1)
    else:
        d_mix = (d_out @ wvo).to(_stream_mix_dtype(precision))
        d_kv, du, dc = stream_bwd(kv, d_mix, d_w, pad, u, c,
                                  want_dkv=want_dkv, kv_scales=kv_scales)
        G, dsum_out = d_out.T @ mix.float(), d_out.sum(dim=0)
    dWo, dWv, d_bv, dbo = _g_epilogue(
        G, dsum_out, wv, out_w, bv, out_b is not None
    )
    d_qp, dWk, d_bk, dWq, d_qrow = _query_path_grads(
        scale, qp.reshape(1, E), wk.reshape(1, E, E), bk, du, dc, wq, qrow,
        in_b is not None,
    )
    d_params = _assemble_d_params(
        dWq, dWk, dWv, dWo, d_qp, d_bk, d_bv, dbo, in_b is not None
    )
    return d_params, d_qrow, d_kv


def _bwd_heads(tensors, kpm, d_out, d_w, want_dkv, num_heads, mix,
               precision):
    """H > 1 backward: the out/V-projection backward in torch, then the
    softmax backward — after a resident forward in plain torch, as the
    JAX package runs it in XLA (``_shared_bwd_impl``: ``mix`` recomputed),
    after a streamed one in the multi-head kernel (``_bwd_streamed_mh``;
    ``d_mix`` stored as ``mix`` is); int8 features: the plain torch on the
    dequantized features, or the kernel's quantized branch.  Called under
    the forward's matmul mode."""
    in_w, in_b, out_w, out_b, qrow, kv, kv_scales = tensors
    B, M, E = kv.shape
    H = num_heads
    Dh = E // H
    wq, wk, wv, _, bk, bv = _split_params(in_w, in_b, out_w)
    (u, c, _, _, _, _), qp, scale = _prep_tensors(
        in_w, in_b, out_w, out_b, qrow, H
    )
    pad = _pad_bias_rows(kpm)
    softmax_bwd, d_mix_dtype = stream_bwd_mh, _stream_mix_dtype(precision)
    if mix is None:
        mix = stream_mix_plain(kv, u, c, pad, kv_scales=kv_scales)[0]
        softmax_bwd, d_mix_dtype = stream_bwd_plain, torch.float32
    d_mix, dWo, dbo, dWv, d_bv = _out_vproj_bwd(
        d_out, mix.float().reshape(B, H, E), wv.reshape(H, Dh, E), out_w, bv,
        out_b is not None,
    )
    d_kv, d_u, d_c = softmax_bwd(
        kv, d_mix.reshape(B, H * E).to(d_mix_dtype).contiguous(),
        None if d_w is None else d_w.contiguous(),
        pad, u, c, want_dkv=want_dkv, kv_scales=kv_scales,
    )
    d_qp, dWk, d_bk, dWq, d_qrow = _query_path_grads(
        scale, qp.reshape(H, Dh), wk.reshape(H, Dh, E), bk, d_u, d_c, wq,
        qrow, in_b is not None,
    )
    d_params = _assemble_d_params(
        dWq, dWk, dWv, dWo, d_qp, d_bk, d_bv, dbo, in_b is not None
    )
    return d_params, d_qrow, d_kv


def _forward(tensors, kpm, num_heads, mask_kw, *, streamed, precision):
    """``((out, w, mw, ent, rate), mix)``: the resident forward kernel
    (``mix`` None), or the streamed one and the context GEMMs in torch
    (``_forward_streamed``; ``mix`` kept for the backward), the prologue
    and the glue under ``precision``'s matmul mode."""
    in_w, in_b, out_w, out_b, qrow, kv, kv_scales = tensors
    with matmul_precision(precision):
        u, c, wctx, bctx, wo, bo = _prep_tensors(
            in_w, in_b, out_w, out_b, qrow, num_heads
        )[0]
        pad = _pad_bias_rows(kpm)
        if not streamed:
            outs = shared_query_fwd(kv, u, c, pad, wctx, bctx, wo, bo,
                                    kv_scales=kv_scales, precision=precision,
                                    **mask_kw)
            return outs, None
        mix, w, mw, ent, rate = stream_mix(kv, u, c, pad, kv_scales=kv_scales,
                                           precision=precision, **mask_kw)
        return (_context(mix, wctx, bctx, wo, bo), w, mw, ent, rate), mix


class _SharedPool(torch.autograd.Function):
    """Forward kernel + backward, the port of ``_shared_core``'s custom
    VJP: the streamed route where :func:`_vjp_wants_streamed` says so
    (``mix`` saved for the backward), else the resident one.  Returns
    ``(out, w, mw, ent, rate)``; ``mw`` and ``rate`` carry no gradient,
    and the backward folds an entropy cotangent into the weights'
    (``_fold_entropy_cotangent``).  The backward needs no mask and no
    draw: the output flows through the unmasked weights (quirk Q1).  With
    int8 ``kv`` and its ``kv_scales`` (``_shared_core_q8``) both get None
    gradients: int8 features are frozen.  The backward runs under the
    forward's ``precision`` itself (saved on ``ctx``): autograd calls it
    outside the forward's block, and a backward that recomputed ``u`` in
    another mode than its forward would drift from the returned primal
    (the lesson of JAX's ``_ctx_prec``)."""

    @staticmethod
    def forward(ctx, in_w, in_b, out_w, out_b, qrow, kv, kv_scales, kpm,
                num_heads, mask_kw, precision):
        tensors = (in_w, in_b, out_w, out_b, qrow, kv, kv_scales)
        outs, mix = _forward(
            tensors, kpm, num_heads, mask_kw,
            streamed=_vjp_wants_streamed(num_heads, kv.shape[-1]),
            precision=precision,
        )
        ctx.save_for_backward(*tensors, kpm, outs[1], mix)
        ctx.num_heads = num_heads
        ctx.precision = precision
        ctx.mark_non_differentiable(outs[2], outs[4])
        return outs

    @staticmethod
    def backward(ctx, d_out, d_w, _d_mw, d_ent, _d_rate):
        *tensors, kpm, w, mix = ctx.saved_tensors
        d_w = _fold_entropy_cotangent(d_w, d_ent, w)
        want_dkv = ctx.needs_input_grad[5]  # never for int8 kv
        with matmul_precision(ctx.precision):
            if ctx.num_heads == 1:
                d_params, d_qrow, d_kv = _bwd_h1(tensors, kpm, d_out, d_w,
                                                 want_dkv, mix, ctx.precision)
            else:
                d_params, d_qrow, d_kv = _bwd_heads(
                    tensors, kpm, d_out, d_w, want_dkv, ctx.num_heads, mix,
                    ctx.precision,
                )
        return (
            d_params["in_proj_weight"], d_params["in_proj_bias"],
            d_params["out_proj_weight"], d_params["out_proj_bias"],
            d_qrow, d_kv, None, None, None, None, None,
        )


def _package_outputs(out, w, mw, ent, rate, *, training, M, entropy_target):
    """``(out (B,1,E), weights (B,1,M), masked (B,1,M), info)`` with the
    JAX package's info contract: eval ``{entropy, mask_rate}`` (entropy
    differentiable); training ``{entropy, mask_rate, target_entropy}``,
    all detached (quirk Q2), zeros when M == 1."""
    entropy = ent[:, None].detach()
    mask_rate = rate[:, None].detach()
    if training and M > 1:
        info = {
            "entropy": entropy,
            "mask_rate": mask_rate,
            "target_entropy": torch.full_like(
                entropy, math.log(M) * float(entropy_target)
            ),
        }
    elif training:
        zeros = torch.zeros_like(entropy)
        info = {"entropy": zeros, "mask_rate": zeros, "target_entropy": zeros}
    else:
        info = {"entropy": ent[:, None], "mask_rate": mask_rate}
    return out[:, None, :], w[:, None, :], mw[:, None, :].detach(), info


def fused_fusion_pool_shared(
    params: AttentionPoolParams,
    query: torch.Tensor,  # (1, 1, E) — the unexpanded fusion query
    kv: torch.Tensor,  # (B, M, E)
    *,
    num_heads: int = 1,
    generator: Optional[torch.Generator] = None,
    training: bool = False,
    base_mask_prob: float = 0.15,
    entropy_target: float = 0.7,
    min_active: int = 1,
    key_padding_mask: Optional[torch.Tensor] = None,
    precision: str = "default",
    kv_scales: Optional[torch.Tensor] = None,  # (B, M) f32, int8 kv only
    kv_grad: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Fused fusion pool for a batch-shared query, differentiable.

    Returns ``(out (B,1,E), weights (B,1,M), masked (B,1,M), info)`` with
    the JAX function's info contract.  ``training=True`` draws the
    curriculum mask in the kernel from two seed words taken from
    ``generator`` (a CPU ``torch.Generator``, in place of JAX's ``rng=``).
    Gradients flow to the pool's parameters, ``query`` (its ``(1, 1, E)``
    shape: a batch sum) and, unless ``kv_grad=False``, ``kv``.
    ``precision`` is ``"default"`` or ``"highest"``: ``'highest'`` runs
    every product in IEEE f32; ``'default'`` on the card runs the chains'
    products on the TF32 tensor cores and the prologue and glue GEMMs in
    cuBLAS TF32 (JAX's ``DEFAULT`` on an Ampere or Hopper GPU; IEEE f32 on
    the CPU, as JAX's CPU backend), forward and backward, and on any
    device stores the streamed split's ``mix`` and ``d_mix`` in bf16, as
    the JAX package does.  Up to E = 1024 the resident kernels run, at any H
    dividing E; above it (to E = 8192, H ≤ 2), and for H == 2 training or
    gradients from E = 512, the streamed split
    (:func:`_vjp_wants_streamed`).

    Quantized path: int8 ``kv`` with ``kv_scales (B, M)``
    (:func:`quantize_features`) — a quarter of the f32 feature bytes in
    every kernel, forward and backward, on the same routes.  int8 features
    are frozen by construction: gradients flow to the parameters and the
    query only, and no backward computes a ``d_kv``.
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
    M = kv.shape[1]
    E = kv.shape[-1]
    if E > _STREAMED_E_CAP:
        raise ValueError(
            f"embed_dim {E} exceeds the streamed-split cap E="
            f"{_STREAMED_E_CAP}; use implementation='torch'"
        )
    if num_heads < 1 or E % num_heads:
        raise ValueError(_HEADS.format(H=num_heads, E=E))
    if E > _RESIDENT_E_CAP and num_heads > _STREAMED_MAX_H:
        raise ValueError(
            f"E={E} above the resident cap E={_RESIDENT_E_CAP} needs "
            "num_heads<=2 (the streamed split); use implementation='torch' "
            "for H > 2"
        )
    if training and generator is None and M > 1:
        raise ValueError(
            "fused_fusion_pool_shared(training=True) needs a `generator=`"
        )
    _check_kv_scales(kv, kv_scales)
    mask_kw = dict(
        training=training, seed=draw_seed_words(generator),
        mask_prob=float(base_mask_prob), min_active=int(min_active),
    )
    if not kv_grad:
        kv = kv.detach()
    tensors = (params.in_proj_weight, params.in_proj_bias,
               params.out_proj_weight, params.out_proj_bias, query[0, 0, :],
               kv, kv_scales)
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    ):
        outs = _SharedPool.apply(*tensors, key_padding_mask, num_heads,
                                 mask_kw, precision)
    else:
        # as JAX's _shared_core: training draws as the differentiable
        # forward would; gradient-free eval keeps the resident kernel
        # below the cap
        streamed = E > _RESIDENT_E_CAP or (
            training and _vjp_wants_streamed(num_heads, E)
        )
        outs, _ = _forward(tensors, key_padding_mask, num_heads, mask_kw,
                           streamed=streamed, precision=precision)
    return _package_outputs(
        *outs, training=training, M=M, entropy_target=entropy_target
    )
