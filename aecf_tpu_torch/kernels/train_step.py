"""One-pass fused TRAIN STEP for the H == 1 shared-query pool, with a CUDA
kernel.

Port of :mod:`aecf_tpu.kernels.train_step`.  The two-pass training step
(forward kernel, then the backward kernel) reads the ``(B, M, E)``
features twice; the one-pass step reads them once, because of the
reference's own semantics:

  * **Q1** — curriculum masking never touches the output: the pooled output
    flows through the UNMASKED attention weights, so the backward needs no
    mask and no draw;
  * **Q2** — ``info['entropy']`` is detached in training, so the entropy
    regularizer contributes no gradient.

For the two built-in row-local losses — the benchmark protocol's
quadratic ``(out²).mean()·loss_scale`` and the X3 linear head with mean
BCE-with-logits — the whole step is one call into ``csrc/train_step.cu``
behind :func:`train_step` (plain version :func:`train_step_plain`), a
chain of kernels on the caller's stream: a row kernel (scores → softmax →
entropy → mask chain, side outputs, mix), the out GEMM with the loss in
its epilogue (or a head kernel for logits, BCE and ``d_out``), the
``d_mix`` GEMM, a row kernel for the softmax backward [→ ``d_kv``] and the
per-block partial sums, and the batch reductions G (and dW_head) as split
GEMMs, then du, Σd_out, Σd_s, Σloss (and db_head).  The E×E products run
in ``csrc/gemm_f32.cuh``, a pipelined SIMT f32 GEMM over the whole batch,
at ``precision='highest'``, and in its TF32 tensor-core instance
``csrc/gemm_tf32.cuh`` at ``'default'`` on the card (JAX's dots at
``mxu_precision = None``; the head kernel's logits and ``d_out`` then take
TF32-rounded operands).  The E×E weight-gradient reconstruction
(``_g_epilogue`` / ``_query_path_grads``) stays in torch, as the JAX
package leaves it to XLA, under the step's matmul mode with the prologue.

Draws are Philox (:mod:`.draws`) with tile-independent counters, so the
step draws the same mask as the training forward kernel for the same seed
words — with no condition on tile sizes.

int8 features (``kv_scales``, the kernel's ``quantized=True`` branch) are
dequantized per element in the kernel and are frozen: no ``d_kv``.

The chain takes any E up to the resident cap (workspace rows of a multiple
of four floats) and a ``kv`` at any element offset, so a staged batch —
``row_offset``/``batch_rows`` into ``(S·B, M, E)`` or packed ``(S·B,
M·E)`` features, JAX's in-kernel offset — is a zero-copy view.  The seed
words come by value or, with ``seed_words=``, from a ``(2,)`` int32 device
tensor that the kernel reads (a replayed CUDA graph's steps).  A custom
``row_loss`` — a Python callable, which cannot run inside the chain — goes
through the two-pass kernels: the forward (``shared_query_fwd.cu``), the
callable in torch (with a head, the head's products on the GEMM block of
``csrc/gemm_f32.cuh`` around it), the backward (``shared_query_bwd.cu``);
the forward draws the step's mask for the same seed words.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..core.attention import AttentionPoolParams
from ..core.precision import matmul_precision
from ._build import load_library
from ._gemm import gemm_f32, gemm_f32_plain
from ._plan import GemmTile, _pick_plan, dtype_name, step_products
from .draws import draw_seed_words
from .shared_query import (
    _KV_DTYPE,
    _MAX_M,
    _RESIDENT_E_CAP,
    _aligned16,
    _assemble_d_params,
    _check_f32,
    _check_kv_scales,
    _count_launch,
    _dequant,
    _entropy,
    _g_epilogue,
    _mm,
    _pad_bias_rows,
    _precision_code,
    _prep_tensors,
    _ptr,
    _query_path_grads,
    _raise_on_error,
    _require_cuda,
    _side_outputs,
    _split_params,
    shared_query_bwd,
    shared_query_fwd,
)

__all__ = [
    "fused_pool_head_train_step",
    "fused_pool_train_step",
    "step_tile",
    "supports_fused_step",
    "train_step",
    "train_step_plain",
]

# Batch rows one block tile of the step's GEMMs covers (kBM in
# csrc/gemm_f32.cuh); its row kernels take one row a warp.
_STEP_ROWS = 128
# Shared memory of a block of the chain (csrc/train_step.cu): the GEMMs'
# ring (gemm::kMaxSmemBytes: 3 stages of 128 x 36 + 32 x 128 floats), or
# the head kernel's W_head when E C <= kHeadStageFloats and 8 warps' C
# logits (head_smem_bytes) — against the H100's 227 KB.  The sources hold
# the same constants (a test reads them there) and the library reports its
# own sum (aecf_train_step_smem, held to this one on the card).
_GEMM_SMEM = 4 * 3 * (128 * 36 + 32 * 128)
_HEAD_STAGE_FLOATS = 24576
_HEAD_WARPS = 8
_SMEM_CAP = 227 * 1024


def _step_smem(E: int, C: int) -> int:
    staged = E * C if E * C <= _HEAD_STAGE_FLOATS else 0
    return max(_GEMM_SMEM, 4 * (staged + _HEAD_WARPS * C) if C else 0)


def supports_fused_step(num_heads: int, embed_dim: int) -> bool:
    """True when :func:`fused_pool_train_step` covers the config: H == 1
    and the resident E cap (the cap of the resident kernels; the step's
    chain itself keeps no batch tile resident)."""
    return num_heads == 1 and embed_dim <= _RESIDENT_E_CAP


def step_tile(
    batch: int,
    modalities: int,
    embed: int,
    *,
    kv_dtype: str = "float32",
    kv_grad: bool = False,
) -> int:
    """The batch rows one block tile of the step's GEMMs covers: a
    constant (128, compiled; the row kernels take a row a warp).  The
    kernels mask a ragged last tile themselves, so any batch size runs.
    What a card tunes is not this tile but the step's plan — each
    product's column tile and K splits (:func:`step_plan`, recorded under
    the ``step_resident`` site of :mod:`.tiles`)."""
    return _STEP_ROWS


def step_plan(B: int, M: int, E: int, C: int, kv_dtype: torch.dtype,
              want_dkv: bool, device, *, record: bool = True):
    """The plan of the step's chain at one call (:func:`._plan._pick_plan`
    at the ``step_resident`` site): four ``GemmTile`` slots, out, d_mix, G,
    dW_head (``{0, 0}`` where the chain takes its default)."""
    return _pick_plan("step_resident", step_products(B, E, C), M=M, E=E, H=1,
                      kv_dtype=dtype_name(kv_dtype), want_dkv=want_dkv,
                      device=device, slots=4, record=record)


def _bce_rows(logits, labels, inv):
    """Stable mean-BCE-with-logits pieces: per-row loss (B,) and
    ``d_logits`` (B, C), both scaled by ``inv``."""
    bce = (
        logits.clamp_min(0.0) - logits * labels
        + torch.log1p(torch.exp(-logits.abs()))
    )
    return bce.sum(dim=-1) * inv, (torch.sigmoid(logits) - labels) * inv


def train_step_plain(
    kv: torch.Tensor,  # (B, M, E) f32, bf16 or int8 (kv_scales= then)
    u: torch.Tensor,  # (E,)
    c: torch.Tensor,  # (1,)
    pad_bias: Optional[torch.Tensor],  # (B, M) or None
    wvo: torch.Tensor,  # (E, E)
    bctx: torch.Tensor,  # (E,)
    *,
    inv: float,
    want_dkv: bool,
    training: bool = True,
    seed: Tuple[int, int] = (0, 0),
    mask_prob: float = 0.15,
    min_active: int = 1,
    head_w: Optional[torch.Tensor] = None,  # (E, C)
    head_b: Optional[torch.Tensor] = None,  # (C,)
    labels: Optional[torch.Tensor] = None,  # (B, C)
    row_loss: Optional[Callable] = None,
    row_extras: Tuple[torch.Tensor, ...] = (),
    kv_scales: Optional[torch.Tensor] = None,  # (B, M), int8 kv only
    tf32: bool = False,
) -> Dict[str, Optional[torch.Tensor]]:
    """The step kernel's function in plain PyTorch.

    Returns a dict: side outputs ``w``, ``mw`` (B, M), ``ent``, ``rate``
    (B,); ``d_kv`` (kv's dtype, or None); the batch sums ``G`` (E, E),
    ``du``, ``dsum_out`` (E,), ``dc`` and ``loss`` (0-d); with a head,
    ``dW_head`` (E, C) and ``db_head`` (C,).  ``inv`` is the mean-loss
    normaliser (``loss_scale/(B·E)``, or ``loss_scale/(B·C)`` with the
    head).  ``row_loss(x, *row_extras) -> (loss_rows (B, 1), d_x)`` — on
    ``out``, or on the logits then (``labels`` first among the extras) —
    replaces the built-in loss.  ``tf32``: out, the logits, the head's
    ``d_out``, dW_head, ``d_mix`` and G as the chain computes them at
    ``precision='default'`` on the card (:func:`~.shared_query._mm`).
    """
    B, M, E = kv.shape
    x = _dequant(kv, kv_scales)
    s = torch.einsum("bme,e->bm", x, u) + c
    if pad_bias is not None:
        s = s + pad_bias
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    a = e / e.sum(dim=-1, keepdim=True)  # (B, M), H == 1: w == a
    ent = _entropy(a)
    mw, rate = _side_outputs(
        a, ent, training=training, seed=seed, mask_prob=mask_prob,
        min_active=min_active,
    )
    mix = torch.einsum("bm,bme->be", a, x)
    out = _mm(mix, wvo.T, tf32) + bctx
    res: Dict[str, Optional[torch.Tensor]] = {}
    if head_w is not None:
        logits = _mm(out, head_w, tf32) + head_b
        if row_loss is not None:
            extras = ((labels,) if labels is not None else ()) + tuple(row_extras)
            loss_rows, d_logits = row_loss(logits, *extras)
            loss_rows = loss_rows.reshape(B)
        else:
            loss_rows, d_logits = _bce_rows(logits, labels, inv)
        d_out = _mm(d_logits, head_w.T, tf32)
        res["dW_head"] = _mm(out.T, d_logits, tf32)
        res["db_head"] = d_logits.sum(dim=0)
    elif row_loss is not None:
        loss_rows, d_out = row_loss(out, *row_extras)
        loss_rows = loss_rows.reshape(B)
    else:
        loss_rows = (out * out).sum(dim=-1) * inv
        d_out = out * (2.0 * inv)
    d_mix = _mm(d_out, wvo, tf32)
    d_a = torch.einsum("be,bme->bm", d_mix, x)
    d_s = a * (d_a - (a * d_a).sum(dim=-1, keepdim=True))
    res.update(
        w=a, mw=mw, ent=ent, rate=rate,
        d_kv=(
            (a[..., None] * d_mix[:, None, :] + d_s[..., None] * u).to(kv.dtype)
            if want_dkv else None
        ),
        G=_mm(d_out.T, mix, tf32),
        du=torch.einsum("bm,bme->e", d_s, x),
        dsum_out=d_out.sum(dim=0),
        dc=d_s.sum(),
        loss=loss_rows.sum(),
    )
    return res


def train_step(
    kv: torch.Tensor,
    u: torch.Tensor,
    c: torch.Tensor,
    pad_bias: Optional[torch.Tensor],
    wvo: torch.Tensor,
    bctx: torch.Tensor,
    *,
    inv: float,
    want_dkv: bool,
    training: bool = True,
    seed: Tuple[int, int] = (0, 0),
    mask_prob: float = 0.15,
    min_active: int = 1,
    head_w: Optional[torch.Tensor] = None,
    head_b: Optional[torch.Tensor] = None,
    labels: Optional[torch.Tensor] = None,
    row_loss: Optional[Callable] = None,
    row_extras: Tuple[torch.Tensor, ...] = (),
    kv_scales: Optional[torch.Tensor] = None,
    seed_words: Optional[torch.Tensor] = None,
    precision: str = "highest",
) -> Dict[str, Optional[torch.Tensor]]:
    """Wrapper of ``csrc/train_step.cu`` (``_step_kernel``, and its
    ``quantized=True`` branch for int8 ``kv`` with ``kv_scales``); operands
    and results as in :func:`train_step_plain`, any E ≤ 1024, ``kv`` at any
    element offset (a view into a staged batch).  ``precision='default'``
    runs the chain's products on the TF32 tensor cores (the plain version
    with ``tf32=True``); the CPU's plain version computes them in IEEE f32
    at both.  ``seed_words``, a ``(2,)``
    int32 tensor on kv's device, replaces ``seed``: the kernel reads the
    words from it, so a captured CUDA graph draws what the tensor holds at
    replay.

    Every limit is checked first; then a custom ``row_loss`` (chosen by the
    arguments, on any device) runs the two-pass route: the forward
    (:func:`shared_query_fwd`), the callable in torch on ``out`` or the
    logits, the backward (:func:`shared_query_bwd`), each counting its own
    launches (with a head, its products on the GEMM block count in
    ``gemm_f32.launches``).  Otherwise CPU tensors run the plain version,
    and CUDA tensors launch the step's chain or raise.  ``train_step.launches``
    counts f32/bf16 calls of the chain, ``train_step.launches_q8`` int8
    ones: one a call, whatever the chain launches."""
    if kv.ndim != 3 or kv.dtype not in _KV_DTYPE:
        raise ValueError(
            f"kv must be float32/bfloat16/int8 (B, M, E), got {kv.dtype} "
            f"{tuple(kv.shape)}"
        )
    B, M, E = kv.shape
    if B < 1 or not 1 <= M <= _MAX_M or E > _RESIDENT_E_CAP:
        raise ValueError(
            f"kernel takes B >= 1, 1 <= M <= {_MAX_M} and E <= "
            f"{_RESIDENT_E_CAP}, got {tuple(kv.shape)}"
        )
    C = head_w.shape[1] if head_w is not None and head_w.ndim == 2 else 0
    want = {
        "u": (u, (E,)), "c": (c, (1,)), "pad_bias": (pad_bias, (B, M)),
        "wvo": (wvo, (E, E)), "bctx": (bctx, (E,)),
    }
    if head_w is not None:
        want.update(head_w=(head_w, (E, C)), head_b=(head_b, (C,)))
        if labels is not None:
            want["labels"] = (labels, (B, C))
    _check_f32(kv, want, optional=("pad_bias", "labels"), why="the step")
    _check_kv_scales(kv, kv_scales, want_dkv=want_dkv)
    code = _precision_code(precision)
    if head_w is not None and labels is None and row_loss is None:
        raise ValueError("the step kernel's head loss needs labels")
    if _step_smem(E, C) > _SMEM_CAP:
        raise ValueError(
            f"E={E}, C={C} needs {_step_smem(E, C)} bytes of shared memory "
            "a block, above the H100's 227 KB"
        )
    if seed_words is not None:
        if (tuple(seed_words.shape) != (2,) or seed_words.dtype != torch.int32
                or seed_words.device != kv.device):
            raise ValueError(
                f"seed_words must be a (2,) int32 tensor on {kv.device}, got "
                f"{seed_words.dtype} {tuple(seed_words.shape)} on "
                f"{seed_words.device}"
            )
        if row_loss is not None or kv.device.type == "cpu":
            seed = tuple(int(x) & 0xFFFFFFFF for x in seed_words.tolist())
    operands = dict(kv=kv, kv_scales=kv_scales, u=u, c=c, pad_bias=pad_bias,
                    wvo=wvo, bctx=bctx, head_w=head_w, head_b=head_b,
                    labels=labels)
    for name, t in operands.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    kw = dict(want_dkv=want_dkv, training=training, seed=seed,
              mask_prob=mask_prob, min_active=min_active, head_w=head_w,
              head_b=head_b, labels=labels, kv_scales=kv_scales)
    if row_loss is not None or row_extras:
        if row_loss is None:
            raise ValueError("row_extras without a row_loss")
        return _row_loss_step(kv, u, c, pad_bias, wvo, bctx, row_loss=row_loss,
                              row_extras=tuple(row_extras),
                              precision=precision, **kw)
    plans = step_plan(B, M, E, C, kv.dtype, want_dkv, kv.device)
    if kv.device.type == "cpu":
        return train_step_plain(kv, u, c, pad_bias, wvo, bctx, inv=inv, **kw)
    _require_cuda(kv, operands)
    wvo = _aligned16(wvo)
    lib = _library()
    dev = kv.device
    f32 = dict(dtype=torch.float32, device=dev)
    res: Dict[str, Optional[torch.Tensor]] = {
        "w": torch.empty((B, M), **f32),
        "mw": torch.empty((B, M), **f32),
        "ent": torch.empty((B,), **f32),
        "rate": torch.empty((B,), **f32),
        "d_kv": torch.empty_like(kv) if want_dkv else None,
        "G": torch.empty((E, E), **f32),
    }
    dhead_w = torch.empty((E, C), **f32) if C else None
    sums = torch.empty((2 * E + 2 + C,), **f32)
    ws = torch.empty((lib.aecf_train_step_workspace(B, E, C, plans),), **f32)
    params = _StepParams(
        _ptr(kv), _ptr(kv_scales), _ptr(u), _ptr(c), _ptr(pad_bias),
        _ptr(wvo), _ptr(bctx),
        _ptr(head_w), _ptr(head_b), _ptr(labels), _ptr(res["w"]),
        _ptr(res["mw"]), _ptr(res["ent"]), _ptr(res["rate"]),
        _ptr(res["d_kv"]), _ptr(res["G"]), _ptr(dhead_w), _ptr(sums),
        _ptr(ws), _ptr(seed_words), B, M, E, C, _KV_DTYPE[kv.dtype],
        int(bool(training)), int(min_active), code, seed[0], seed[1],
        math.log(M) if M > 1 else 0.0, float(mask_prob), float(inv),
        float(2.0 * inv), plans,
    )
    with torch.cuda.device(dev):
        err = lib.aecf_train_step(
            ctypes.byref(params), torch.cuda.current_stream(dev).cuda_stream
        )
    _raise_on_error(lib, err, "train_step")
    _count_launch(train_step, kv)
    res.update(du=sums[:E], dsum_out=sums[E : 2 * E], dc=sums[2 * E],
               loss=sums[2 * E + 1])
    if C:
        res.update(dW_head=dhead_w, db_head=sums[2 * E + 2 :])
    return res


def _row_loss_step(kv, u, c, pad_bias, wvo, bctx, *, want_dkv, training,
                   seed, mask_prob, min_active, head_w, head_b, labels,
                   row_loss, row_extras, kv_scales, precision):
    """:func:`train_step` with a custom ``row_loss``, through the two-pass
    kernels (their plain versions on CPU tensors): the training forward
    gives ``out`` and the side outputs (the step's mask for the same seed
    words), ``row_loss`` gives the row losses and ``d_out`` (through the
    head's logits when there is one: the head's products run on the GEMM
    block, three launches of :func:`~._gemm.gemm_f32`), and the H=1
    backward gives ``d_kv`` and the batch sums.  The same results as
    :func:`train_step_plain`."""
    B = kv.shape[0]
    out, w, mw, ent, rate = shared_query_fwd(
        kv, u[None], c, pad_bias, wvo, bctx, kv_scales=kv_scales,
        training=training, seed=seed, mask_prob=mask_prob,
        min_active=min_active, precision=precision,
    )
    res: Dict[str, Optional[torch.Tensor]] = {}
    if head_w is not None:
        # The head's three products on the GEMM block, its operands in
        # rows of a multiple of four floats (zeros past the data).  A ones
        # column after out's E makes the last product give db_head as row E
        # of dW_head; head_w's zero rows there keep it out of the logits.
        E, C = head_w.shape
        E1, C4 = -(-(E + 1) // 4) * 4, -(-C // 4) * 4
        out1 = _padded(out, B, E1)
        out1[:, E] = 1.0
        w4 = _padded(head_w, E1, C4)
        logits = _head_gemm(out1, w4, _padded(head_b[None], 1, C4)[0],
                            precision=precision)
        extras = ((labels,) if labels is not None else ()) + row_extras
        loss_rows, d_logits = row_loss(logits[:, :C].contiguous(), *extras)
        d4 = _padded(d_logits.float(), B, C4)
        d_out = _head_gemm(d4, w4[:E], w_kmajor=False, precision=precision)
        dwb = _head_gemm(out1, d4, a_trans=True, precision=precision)
        res["dW_head"] = dwb[:E, :C].contiguous()
        res["db_head"] = dwb[E, :C].contiguous()
    else:
        loss_rows, d_out = row_loss(out, *row_extras)
    d_kv, G, du, dsum_out, dc = shared_query_bwd(
        kv, u, c, pad_bias, d_out.float().contiguous(), None, wvo,
        want_dkv=want_dkv, kv_scales=kv_scales, precision=precision,
    )
    res.update(w=w, mw=mw, ent=ent, rate=rate, d_kv=d_kv, G=G, du=du,
               dsum_out=dsum_out, dc=dc, loss=loss_rows.reshape(B).sum())
    return res


def _padded(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``t`` (2-D) in the top left of a zero f32 ``(rows, cols)`` tensor."""
    out = t.new_zeros((rows, cols), dtype=torch.float32)
    out[: t.shape[0], : t.shape[1]] = t
    return out


def _head_gemm(a, w, bias=None, *, a_trans=False, w_kmajor=True,
               precision="highest"):
    """One product of the custom-``row_loss`` route's head on the GEMM
    block (``csrc/gemm_f32.cuh``, or its TF32 instance at ``'default'``;
    the plain version, IEEE f32, on CPU tensors), operands as
    :func:`~._gemm.gemm_f32` takes them, one group."""
    bias = None if bias is None else bias[None]
    if a.device.type == "cpu":
        return gemm_f32_plain(a[None], w[None], bias, a_trans=a_trans,
                              w_kmajor=w_kmajor)[0]
    return gemm_f32(a[None], w[None], bias, a_trans=a_trans,
                    w_kmajor=w_kmajor, precision=precision)[0]


train_step.launches = train_step.launches_q8 = 0


class _StepParams(ctypes.Structure):
    """``StepParams`` of ``csrc/train_step.cu``, field for field."""

    _fields_ = (
        [
            (name, ctypes.c_void_p)
            for name in (
                "kv", "scales", "u", "c", "pad", "wvo", "bctx",
                "head_w", "head_b",
                "labels", "w", "mw", "ent", "rate", "dkv", "g", "dhead_w",
                "sums", "ws", "seeds",
            )
        ]
        + [
            (name, ctypes.c_int)
            for name in ("B", "M", "E", "C", "kv_dtype", "training",
                         "min_active", "precision")
        ]
        + [("seed0", ctypes.c_uint32), ("seed1", ctypes.c_uint32)]
        + [
            (name, ctypes.c_float)
            for name in ("max_entropy", "mask_prob", "inv", "two_inv")
        ]
        + [("plans", GemmTile * 4)]
    )


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("train_step")
    tiles = ctypes.POINTER(GemmTile)
    lib.aecf_train_step_workspace.argtypes = [ctypes.c_int] * 3 + [tiles]
    lib.aecf_train_step_workspace.restype = ctypes.c_size_t
    lib.aecf_train_step_plans.argtypes = [ctypes.c_int] * 3 + [
        tiles, ctypes.POINTER(ctypes.c_int)]
    lib.aecf_train_step_plans.restype = ctypes.c_int
    lib.aecf_train_step_smem.argtypes = [ctypes.c_int] * 2
    lib.aecf_train_step_smem.restype = ctypes.c_size_t
    lib.aecf_train_step.argtypes = [
        ctypes.POINTER(_StepParams), ctypes.c_void_p,
    ]
    lib.aecf_train_step.restype = ctypes.c_int
    lib.aecf_cuda_error_string.argtypes = [ctypes.c_int]
    lib.aecf_cuda_error_string.restype = ctypes.c_char_p
    return lib


def fused_pool_train_step(
    params: AttentionPoolParams,
    query: torch.Tensor,  # (1, 1, E) — the unexpanded fusion query
    kv: torch.Tensor,  # (B, M, E) f32 / bf16 / int8 (with kv_scales)
    *,
    generator: Optional[torch.Generator] = None,
    training: bool = True,
    base_mask_prob: float = 0.15,
    entropy_target: float = 0.7,
    min_active: int = 1,
    key_padding_mask: Optional[torch.Tensor] = None,
    precision: str = "default",
    kv_grad: bool = False,
    kv_scales: Optional[torch.Tensor] = None,
    row_loss: Optional[Callable] = None,
    row_extras: Tuple[torch.Tensor, ...] = (),
    head_w: Optional[torch.Tensor] = None,
    head_b: Optional[torch.Tensor] = None,
    labels: Optional[torch.Tensor] = None,
    loss_scale: float = 1.0,
    row_offset: Optional[int] = None,
    batch_rows: Optional[int] = None,
    seed_words: Optional[torch.Tensor] = None,
) -> Tuple[Any, ...]:
    """One-pass fused training step: loss and gradients in one kv read.

    Returns ``(loss, d_params, d_query, d_kv, info)`` — with ``head_w``,
    ``(loss, d_params, d_query, d_head, d_kv, info)`` — as the JAX
    function does:

    * ``loss`` — 0-d tensor, Σ over rows of the row loss (for the default
      quadratic loss this IS ``(out²).mean()·loss_scale``; with the head,
      mean BCE-with-logits against ``labels (B, C)``·loss_scale).
    * ``d_params`` — gradients keyed like the pool's parameters
      (``in_proj_weight``, ``out_proj_weight``, ``in_proj_bias``,
      ``out_proj_bias``; None for an absent bias); ``d_query`` (1, 1, E).
    * ``d_head = {'w': (E, C), 'b': (C,) | None}`` — ``head_w`` keeps the
      JAX layout ``(E, C)`` (logits = out @ head_w + head_b), not
      ``nn.Linear``'s ``(C, E)``.
    * ``d_kv`` — the feature cotangent when ``kv_grad=True``, else None
      (int8 features, with ``kv_scales (B, M)`` from
      :func:`~aecf_tpu_torch.kernels.quantize_features`, are frozen:
      ``kv_grad=True`` raises).
    * ``info`` — the training info contract (``entropy``, ``mask_rate``,
      ``target_entropy`` as (B, 1) values, plus ``attention_weights`` and
      ``masked_attention_weights`` (B, 1, M)); all detached (Q1/Q2).

    ``generator`` (a CPU ``torch.Generator``, or the two seed words as a
    tuple) gives the two seed words of the draw; ``seed_words``, a ``(2,)``
    int32 tensor on kv's device, gives them instead, read by the kernel
    (the CUDA-graph chunk's steps).  ``training=False`` skips the draw
    (eval info contract; identical gradients, Q1).  ``loss_scale``
    multiplies the built-in losses' mean normaliser.  ``precision`` is
    ``"default"`` or ``"highest"``: ``'highest'`` runs every product in
    IEEE f32; ``'default'`` on the card runs the chain's products (out,
    logits, ``d_out``, dW_head, ``d_mix``, G) with TF32 operands and the
    prologue (``qp``, ``u``, ``c``, ``W_vo``) and the weight-gradient GEMMs in
    cuBLAS TF32 — JAX's ``DEFAULT`` on an Ampere or Hopper GPU; on the CPU
    both are IEEE f32, as JAX's CPU backend computes them.

    ``row_offset``/``batch_rows`` — staged-batch addressing (JAX's
    in-kernel tile offset): ``kv`` holds S steps' batches stacked on axis 0,
    ``(S·B, M, E)`` or packed ``(S·B, M·E)``, as do ``labels``,
    ``kv_scales``, ``key_padding_mask`` and ``row_extras``; the step runs on
    rows ``row_offset .. row_offset + batch_rows`` of each, as zero-copy
    views (a view whose start is not on 16 bytes takes the kernel's
    one-feature reads).  Any ``batch_rows`` dividing the staged rows: the
    chain masks a ragged last tile itself.
    """
    if query.shape[:2] != (1, 1):
        raise ValueError(
            f"shared-query step expects query (1, 1, E), got "
            f"{tuple(query.shape)}"
        )
    if kv.ndim == 2:  # packed (rows, M·E): modalities side by side
        E = query.shape[-1]
        if kv.shape[1] % E:
            raise ValueError(
                f"2-D kv columns {kv.shape[1]} not a multiple of embed dim {E}"
            )
        kv = kv.view(kv.shape[0], kv.shape[1] // E, E)
    if row_offset is not None:
        if batch_rows is None:
            raise ValueError("row_offset requires batch_rows")
        S_rows = kv.shape[0]
        if batch_rows < 1 or S_rows % batch_rows:
            raise ValueError(
                f"staged kv rows {S_rows} not a multiple of "
                f"batch_rows={batch_rows}"
            )
        if not 0 <= row_offset <= S_rows - batch_rows:
            raise ValueError(
                f"row_offset={row_offset} outside the {S_rows} staged rows"
            )
        rows = slice(row_offset, row_offset + batch_rows)

        def step_rows(name, t):
            if t is None:
                return None
            if t.shape[0] != S_rows:
                raise ValueError(
                    f"staged {name} must hold the {S_rows} staged rows, got "
                    f"{tuple(t.shape)}"
                )
            return t[rows]

        kv = kv[rows]
        labels = step_rows("labels", labels)
        kv_scales = step_rows("kv_scales", kv_scales)
        key_padding_mask = step_rows("key_padding_mask", key_padding_mask)
        row_extras = tuple(step_rows("row_extras", t) for t in row_extras)
    elif batch_rows is not None and batch_rows != kv.shape[0]:
        raise ValueError("batch_rows without row_offset must match kv.shape[0]")
    B, M, E = kv.shape
    if E > _RESIDENT_E_CAP:
        raise ValueError(
            f"fused_pool_train_step covers E <= {_RESIDENT_E_CAP}, got "
            f"E={E}; use the two-pass path"
        )
    if precision not in ("default", "highest"):
        raise ValueError(
            f"fused kernels support precision 'default' or 'highest', got "
            f"{precision!r} — use the torch path for other modes"
        )
    _check_kv_scales(kv, kv_scales, want_dkv=kv_grad)
    if training and generator is None and seed_words is None and M > 1:
        raise ValueError(
            "fused_pool_train_step(training=True) needs a `generator=`"
        )
    with_head = head_w is not None
    C = 0
    if with_head:
        if head_w.ndim != 2 or head_w.shape[0] != E:
            raise ValueError(
                f"head_w must be (E, C) with E={E}, got {tuple(head_w.shape)}"
            )
        C = head_w.shape[1]
        if head_b is not None and tuple(head_b.shape) != (C,):
            raise ValueError(f"head_b must be ({C},), got {tuple(head_b.shape)}")
        if labels is None and row_loss is None:
            raise ValueError(
                "head_w without labels needs a custom row_loss on logits"
            )
        if labels is not None and tuple(labels.shape) != (B, C):
            raise ValueError(
                f"labels must be ({B}, {C}), got {tuple(labels.shape)}"
            )

    seed = (draw_seed_words(generator)
            if training and seed_words is None else (0, 0))
    qrow = query[0, 0, :]
    in_w, in_b = params.in_proj_weight, params.in_proj_bias
    out_w, out_b = params.out_proj_weight, params.out_proj_bias
    with torch.no_grad(), matmul_precision(precision):
        wq, wk, wv, _, bk, bv = _split_params(in_w, in_b, out_w)
        (u, c, wvo, bctx, _, _), qp, scale = _prep_tensors(
            in_w, in_b, out_w, out_b, qrow, 1
        )
        res = train_step(
            kv.detach(), u[0], c, _pad_bias_rows(key_padding_mask), wvo,
            bctx, inv=loss_scale / (B * (C if with_head else E)),
            want_dkv=kv_grad, training=training, seed=seed,
            mask_prob=float(base_mask_prob), min_active=int(min_active),
            head_w=head_w.detach().float().contiguous() if with_head else None,
            head_b=(
                (head_b.detach().float() if head_b is not None
                 else head_w.new_zeros(C, dtype=torch.float32))
                if with_head else None
            ),
            labels=labels.float().contiguous() if labels is not None else None,
            row_loss=row_loss, row_extras=tuple(row_extras),
            kv_scales=kv_scales,
            seed_words=seed_words if training else None,
            precision=precision,
        )
        dWo, dWv, d_bv, dbo = _g_epilogue(
            res["G"], res["dsum_out"], wv, out_w, bv, out_b is not None
        )
        d_qp, dWk, d_bk, dWq, d_qrow = _query_path_grads(
            scale, qp.reshape(1, E), wk.reshape(1, E, E), bk,
            res["du"].reshape(1, E), res["dc"].reshape(1), wq, qrow,
            in_b is not None,
        )
        d_params = _assemble_d_params(
            dWq, dWk, dWv, dWo, d_qp, d_bk, d_bv, dbo, in_b is not None
        )
    d_query = d_qrow.reshape(1, 1, E)

    ent, rate = res["ent"][:, None], res["rate"][:, None]
    if training and M > 1:
        info: Dict[str, Any] = {
            "entropy": ent,
            "mask_rate": rate,
            "target_entropy": torch.full_like(
                ent, math.log(M) * float(entropy_target)
            ),
        }
    elif training:
        zeros = torch.zeros_like(ent)
        info = {"entropy": zeros, "mask_rate": zeros, "target_entropy": zeros}
    else:
        info = {"entropy": ent, "mask_rate": rate}
    info["attention_weights"] = res["w"][:, None, :]
    info["masked_attention_weights"] = res["mw"][:, None, :]
    if with_head:
        d_head = {
            "w": res["dW_head"],
            "b": res["db_head"] if head_b is not None else None,
        }
        return res["loss"], d_params, d_query, d_head, res["d_kv"], info
    return res["loss"], d_params, d_query, res["d_kv"], info


def fused_pool_head_train_step(
    params: AttentionPoolParams,
    query: torch.Tensor,
    head: Dict[str, Optional[torch.Tensor]],
    kv: torch.Tensor,
    labels: torch.Tensor,
    **kwargs,
) -> Tuple[torch.Tensor, Dict[str, Any], Optional[torch.Tensor],
           Dict[str, Any]]:
    """Product-shaped wrapper of the one-pass step with a trainable head.

    ``head = {'w': (E, C), 'b': (C,) | None}`` — the linear classifier of
    the X3 protocol (frozen features → pool → head → BCE).  Returns
    ``(loss, grads, d_kv, info)`` with ``grads = {'pool': d_params,
    'query': (1, 1, E), 'head': {'w'[, 'b']}}``, aligned with the
    ``{'pool', 'query', 'head'}`` parameters the train-step builders use.
    Every keyword of :func:`fused_pool_train_step` passes through.
    """
    loss, d_params, d_query, d_head, d_kv, info = fused_pool_train_step(
        params, query, kv,
        head_w=head["w"], head_b=head.get("b"), labels=labels, **kwargs,
    )
    if head.get("b") is None:
        d_head = {"w": d_head["w"]}
    grads = {"pool": d_params, "query": d_query, "head": d_head}
    return loss, grads, d_kv, info
