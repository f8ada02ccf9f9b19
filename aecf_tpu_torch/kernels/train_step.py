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
in ``csrc/gemm_f32.cuh``, a pipelined SIMT f32 GEMM over the whole batch.
The E×E weight-gradient reconstruction (``_g_epilogue`` /
``_query_path_grads``) stays in torch, as the JAX package leaves it to
XLA.

Draws are Philox (:mod:`.draws`) with tile-independent counters, so the
step draws the same mask as the training forward kernel for the same seed
words — with no condition on tile sizes.

int8 features (``kv_scales``, the kernel's ``quantized=True`` branch) are
dequantized per element in the kernel and are frozen: no ``d_kv``.

Not ported (each raises, naming its ROADMAP.md item): staged-batch
addressing (``row_offset``/``batch_rows``, packed 2-D ``kv``) and a custom
``row_loss`` on CUDA tensors (a Python callable cannot run inside a CUDA
kernel; the plain version runs one on CPU tensors).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..core.attention import AttentionPoolParams
from ._build import load_library
from .draws import draw_seed_words
from .shared_query import (
    _KV_DTYPE,
    _MAX_M,
    _RESIDENT_E_CAP,
    _assemble_d_params,
    _check_f32,
    _check_kv_scales,
    _count_launch,
    _dequant,
    _entropy,
    _g_epilogue,
    _pad_bias_rows,
    _prep_tensors,
    _ptr,
    _query_path_grads,
    _raise_on_error,
    _require_aligned,
    _require_cuda,
    _side_outputs,
    _split_params,
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
_ROADMAP = "not ported yet (ROADMAP.md, queue 1, item 1: {})"


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
    constant (128; the row kernels take a row a warp) — the per-device
    tile table is ROADMAP.md, queue 1, item 8.  The kernels mask a ragged
    last tile themselves, so any batch size runs."""
    return _STEP_ROWS


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
) -> Dict[str, Optional[torch.Tensor]]:
    """The step kernel's function in plain PyTorch.

    Returns a dict: side outputs ``w``, ``mw`` (B, M), ``ent``, ``rate``
    (B,); ``d_kv`` (kv's dtype, or None); the batch sums ``G`` (E, E),
    ``du``, ``dsum_out`` (E,), ``dc`` and ``loss`` (0-d); with a head,
    ``dW_head`` (E, C) and ``db_head`` (C,).  ``inv`` is the mean-loss
    normaliser (``loss_scale/(B·E)``, or ``loss_scale/(B·C)`` with the
    head).  ``row_loss(x, *row_extras) -> (loss_rows (B, 1), d_x)`` — on
    ``out``, or on the logits then (``labels`` first among the extras) —
    replaces the built-in loss.
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
    out = mix @ wvo.T + bctx
    res: Dict[str, Optional[torch.Tensor]] = {}
    if head_w is not None:
        logits = out @ head_w + head_b
        if row_loss is not None:
            extras = ((labels,) if labels is not None else ()) + tuple(row_extras)
            loss_rows, d_logits = row_loss(logits, *extras)
            loss_rows = loss_rows.reshape(B)
        else:
            loss_rows, d_logits = _bce_rows(logits, labels, inv)
        d_out = d_logits @ head_w.T
        res["dW_head"] = out.T @ d_logits
        res["db_head"] = d_logits.sum(dim=0)
    elif row_loss is not None:
        loss_rows, d_out = row_loss(out, *row_extras)
        loss_rows = loss_rows.reshape(B)
    else:
        loss_rows = (out * out).sum(dim=-1) * inv
        d_out = out * (2.0 * inv)
    d_mix = d_out @ wvo
    d_a = torch.einsum("be,bme->bm", d_mix, x)
    d_s = a * (d_a - (a * d_a).sum(dim=-1, keepdim=True))
    res.update(
        w=a, mw=mw, ent=ent, rate=rate,
        d_kv=(
            (a[..., None] * d_mix[:, None, :] + d_s[..., None] * u).to(kv.dtype)
            if want_dkv else None
        ),
        G=d_out.T @ mix,
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
) -> Dict[str, Optional[torch.Tensor]]:
    """Wrapper of ``csrc/train_step.cu`` (``_step_kernel``, and its
    ``quantized=True`` branch for int8 ``kv`` with ``kv_scales``); operands
    and results as in :func:`train_step_plain`.  CPU tensors run the plain
    version; CUDA tensors launch the kernel chain or raise (a custom
    ``row_loss`` raises; ``kv`` must be aligned to four features and
    ``wvo`` to 16 bytes).
    ``train_step.launches`` counts f32/bf16 calls, ``train_step.launches_q8``
    int8 ones: one a call, whatever the chain launches."""
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
    kw = dict(inv=inv, want_dkv=want_dkv, training=training, seed=seed,
              mask_prob=mask_prob, min_active=min_active, head_w=head_w,
              head_b=head_b, labels=labels, kv_scales=kv_scales)
    if kv.device.type == "cpu":
        return train_step_plain(kv, u, c, pad_bias, wvo, bctx,
                                row_loss=row_loss, row_extras=row_extras, **kw)
    if row_loss is not None or row_extras:
        raise NotImplementedError(
            "a custom row_loss on CUDA tensors is "
            + _ROADMAP.format("custom row_loss in the step kernel")
            + "; the kernel has the quadratic and the BCE-head losses"
        )
    if head_w is not None and labels is None:
        raise ValueError("the step kernel's head loss needs labels")
    if E % 4:
        raise ValueError(f"the step kernel takes E divisible by 4, got E={E}")
    _require_cuda(kv, dict(kv=kv, kv_scales=kv_scales, u=u, c=c,
                           pad_bias=pad_bias, wvo=wvo, bctx=bctx,
                           head_w=head_w, head_b=head_b, labels=labels))
    _require_aligned(dict(kv=kv, wvo=wvo))
    lib = _library()
    dev = kv.device
    f32 = dict(dtype=torch.float32, device=dev)
    smem = lib.aecf_train_step_smem(E, C)
    if smem > 227 * 1024:
        raise ValueError(
            f"E={E}, C={C} needs {smem} bytes of shared memory a block, "
            "above the H100's 227 KB"
        )
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
    ws = torch.empty((lib.aecf_train_step_workspace(B, E, C),), **f32)
    params = _StepParams(
        _ptr(kv), _ptr(kv_scales), _ptr(u), _ptr(c), _ptr(pad_bias),
        _ptr(wvo), _ptr(bctx),
        _ptr(head_w), _ptr(head_b), _ptr(labels), _ptr(res["w"]),
        _ptr(res["mw"]), _ptr(res["ent"]), _ptr(res["rate"]),
        _ptr(res["d_kv"]), _ptr(res["G"]), _ptr(dhead_w), _ptr(sums),
        _ptr(ws), B, M, E, C, _KV_DTYPE[kv.dtype],
        int(bool(training)), int(min_active), seed[0], seed[1],
        math.log(M) if M > 1 else 0.0, float(mask_prob), float(inv),
        float(2.0 * inv),
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
                "sums", "ws",
            )
        ]
        + [
            (name, ctypes.c_int)
            for name in ("B", "M", "E", "C", "kv_dtype", "training",
                         "min_active")
        ]
        + [("seed0", ctypes.c_uint32), ("seed1", ctypes.c_uint32)]
        + [
            (name, ctypes.c_float)
            for name in ("max_entropy", "mask_prob", "inv", "two_inv")
        ]
    )


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("train_step")
    lib.aecf_train_step_workspace.argtypes = [ctypes.c_int] * 3
    lib.aecf_train_step_workspace.restype = ctypes.c_size_t
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

    ``generator`` (a CPU ``torch.Generator``) gives the two seed words of
    the draw; ``training=False`` skips it (eval info contract; identical
    gradients, Q1).  ``loss_scale`` multiplies the built-in losses' mean
    normaliser.  ``precision`` is ``"default"`` or ``"highest"``; the
    kernel runs full f32 FMAs for both.
    """
    if row_offset is not None or batch_rows is not None or kv.ndim == 2:
        raise NotImplementedError(
            "staged-batch addressing (row_offset/batch_rows, packed 2-D kv) "
            "is " + _ROADMAP.format("staged row_offset in the step kernel")
        )
    if query.shape[:2] != (1, 1):
        raise ValueError(
            f"shared-query step expects query (1, 1, E), got "
            f"{tuple(query.shape)}"
        )
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
    if training and generator is None and M > 1:
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

    seed = draw_seed_words(generator) if training else (0, 0)
    qrow = query[0, 0, :]
    in_w, in_b = params.in_proj_weight, params.in_proj_bias
    out_w, out_b = params.out_proj_weight, params.out_proj_bias
    with torch.no_grad():
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
