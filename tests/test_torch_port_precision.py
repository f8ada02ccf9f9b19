"""``precision='default'`` in the port against the JAX package's.

The JAX package's ``'default'`` runs every in-kernel product at
``mxu_precision = None`` — on an Ampere or Hopper GPU an f32 dot runs as
TF32 — and its prologue and glue under ``jax.default_matmul_precision``;
its streamed split stores ``mix`` and ``d_mix`` in bf16.  On the card the
port runs those products on TF32 tensor cores (``csrc/gemm_tf32.cuh``);
their plain versions emulate that with ``tf32=True`` (``round_tf32`` on
both operands, then an IEEE f32 product), which the wrappers leave off on
the CPU, as JAX's CPU backend computes ``'default'`` in f32.

Here, on the CPU, with the same numpy inputs made from a seed:

* ``round_tf32`` against an independent numpy reference of PTX
  ``cvt.rna.tf32.f32`` (round to nearest at bit 13, ties away from zero),
  bit for bit;
* the GEMM block's plain version with ``tf32=True`` against float64 of the
  rounded operands, within ``K 2^-24 sum|a||w|`` (f32 sums of exact
  products), and against JAX's ``HIGHEST`` within the TF32 tolerance
  ``(2^-10 + 2^-22 + 2 K 2^-24) sum|a||w|`` (each operand moves by at most
  half a TF32 step, 2^-11, so each product by at most 2^-10 + 2^-22 of
  itself);
* each chain with its TF32 emulation on (the plain versions given
  ``tf32=True``) against the JAX function at ``'highest'`` in interpret
  mode: the step (#8) with the quadratic loss and the BCE head, the
  forward (#1) at H = 1 and 4, eval and training (the port's Philox mask
  injected into JAX's ``curriculum_mask``), the H = 1 backward (#4) —
  outputs and gradients within ``TF32_REL`` of the reference's largest
  entry;
* the streamed split at ``'default'`` against JAX's streamed Pallas
  kernels at ``'default'`` in interpret mode: both store bf16 ``mix`` and
  ``d_mix`` and run f32 GEMMs on the CPU, so only a ``mix`` element that
  the two f32 sums round to neighbouring bf16 values separates them
  (``STREAM_REL``); and, training, against the f32 torch oracle with the
  port's mask injected, ``out`` within one bf16 step;
* ``matmul_precision``'s nesting and threads, read through
  ``torch.get_float32_matmul_precision()``; the backward seeing its
  forward's mode; the per-row kernel (#7) equal at both precisions.

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds the
TF32 instance and every chain at ``'default'`` to these plain versions.
"""

import contextlib
import functools
import importlib
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aecf_tpu.core.attention import AttentionPoolParams as JaxParams
from aecf_tpu.kernels import fused_fusion_pool_shared as jax_shared
from aecf_tpu.kernels import fused_pool_head_train_step as jax_head_step
from aecf_tpu.kernels import fused_pool_train_step as jax_step
from aecf_tpu_torch.core import (
    AttentionPoolParams,
    matmul_precision,
    round_tf32,
)
from aecf_tpu_torch.kernels import (
    fused_fusion_pool_shared,
    fused_pool_head_train_step,
    fused_pool_train_step,
    shared_query_bwd,
    shared_query_fwd,
    stream_bwd,
    stream_bwd_plain,
    stream_mix,
    stream_mix_plain,
    train_step,
)
from aecf_tpu_torch.kernels import shared_query as sq
from aecf_tpu_torch.kernels._gemm import gemm_f32_plain
from aecf_tpu_torch.ops import fusion_pool

ts = importlib.import_module("aecf_tpu_torch.kernels.train_step")

POOL = ("in_proj_weight", "out_proj_weight", "in_proj_bias", "out_proj_bias")
# Outputs and gradients behind TF32 products against JAX's IEEE f32: each
# product's operands move by at most half a TF32 step (2^-11) each, and
# the errors of a sum's terms mostly cancel; held to 2^-8 of the
# reference's largest entry.
TF32_REL = 2.0 ** -8
# The streamed split at 'default', port against JAX: a mix element may
# round to the neighbouring bf16 value (2^-8 of itself) where the two f32
# sums straddle a rounding boundary; everything else is f32 sums in other
# orders.
STREAM_REL = 2.0 ** -12


def rel_close(got, want, rel, name=""):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               atol=rel * scale, rtol=0, err_msg=name)


# ---- round_tf32 --------------------------------------------------------------


def _rna13(bits: np.ndarray) -> np.ndarray:
    """Independent reference of ``cvt.rna.tf32.f32`` on uint32 patterns,
    in float64 arithmetic: a finite value rounds to the nearest multiple
    of its TF32 quantum 2^(e - 10) (e its binade, at least -126, so
    subnormals share the smallest normal binade's quantum), ties away from
    zero; past the largest finite f32 it is inf; NaN and inf keep their
    bits."""
    out = bits.copy()
    with np.errstate(invalid="ignore"):  # NaN patterns, kept as they are
        x = bits.view(np.float32).astype(np.float64)
    for i, v in enumerate(x):
        if not np.isfinite(v):
            continue
        mag = abs(v)
        if mag == 0.0:
            continue
        e = max(np.frexp(mag)[1] - 1, -126)
        q = 2.0 ** (e - 10)
        r = math.floor(mag / q + 0.5) * q
        r = np.float32(r) if r < 2.0 ** 128 else np.float32(np.inf)
        out[i] = np.array([math.copysign(r, v)], np.float32).view(np.uint32)[0]
    return out


BIT_PATTERNS = {
    "one": 0x3F800000,
    "tf32 exact (1 + 2^-10)": 0x3F802000,
    "tie, even below (1 + 2^-11)": 0x3F801000,
    "tie, odd below (1 + 3 2^-11)": 0x3F803000,
    "just below a tie": 0x3F800FFF,
    "just above a tie": 0x3F801001,
    "negative tie": 0xBF801000,
    "negative tie, odd below": 0xBF803000,
    "carry into the exponent (2 - 2^-23)": 0x3FFFFFFF,
    "carry into the exponent, negative": 0xBFFFF000,
    "largest finite f32 rounds to inf": 0x7F7FFFFF,
    "largest tf32 below the overflow tie": 0x7F7FE000,
    "overflow tie": 0x7F7FF000,
    "+0": 0x00000000,
    "-0": 0x80000000,
    "+inf": 0x7F800000,
    "-inf": 0xFF800000,
    "quiet NaN": 0x7FC00000,
    "NaN with low payload bits": 0x7F800001,
    "negative NaN": 0xFFC01234,
    "smallest subnormal rounds to 0": 0x00000001,
    "subnormal tie": 0x00001000,
    "negative subnormal tie": 0x80003000,
    "largest subnormal carries into the smallest normal": 0x007FFFFF,
    "smallest normal": 0x00800000,
}


@pytest.mark.parametrize("name", list(BIT_PATTERNS))
def test_round_tf32_bit_patterns(name):
    bits = np.array([BIT_PATTERNS[name]], np.uint32)
    got = round_tf32(torch.from_numpy(bits.view(np.float32).copy()))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), _rna13(bits))


def test_round_tf32_random_bits():
    """Random patterns of every class (normal, subnormal, inf, NaN), in a
    2-D view of another shape: equal to the reference bit for bit, and the
    low 13 bits of every finite result cleared."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2 ** 32, 6000, dtype=np.uint64).astype(np.uint32)
    bits[:500] &= 0x807FFFFF  # subnormals and zeros
    bits[500:600] |= 0x7F800000  # inf and NaN
    x = torch.from_numpy(bits.view(np.float32).copy()).reshape(60, 100)
    got = round_tf32(x.T).T  # a transposed view goes in
    assert tuple(got.shape) == (60, 100)
    gbits = got.reshape(-1).numpy().view(np.uint32)
    np.testing.assert_array_equal(gbits, _rna13(bits))
    finite = np.isfinite(got.reshape(-1).numpy())
    assert not (gbits[finite] & 0x1FFF).any()
    with pytest.raises(TypeError, match="float32"):
        round_tf32(x.double())


# ---- the GEMM block's plain version ------------------------------------------

GEMM_SHAPES = [(1, 130, 37, 45), (3, 7, 68, 20), (1, 1, 70, 300),
               (2, 5, 14, 300)]


def _gemm_operands(seed, G, rows, N, K, a_trans, w_kmajor):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((G, K, rows) if a_trans else (G, rows, K))
    w = rng.standard_normal((G, K, N) if w_kmajor else (G, N, K))
    a, w = a.astype(np.float32), w.astype(np.float32)
    A = a.transpose(0, 2, 1) if a_trans else a
    W = w if w_kmajor else w.transpose(0, 2, 1)
    return torch.from_numpy(a), torch.from_numpy(w), A, W


@pytest.mark.parametrize("w_kmajor", [True, False])
@pytest.mark.parametrize("a_trans", [False, True])
@pytest.mark.parametrize("G,rows,N,K", GEMM_SHAPES)
def test_gemm_plain_default_is_the_tf32_product(G, rows, N, K, a_trans,
                                                w_kmajor):
    """At 'default': float64 of the rounded operands within K 2^-24
    sum|a||w|; against JAX's HIGHEST (IEEE f32 of the unrounded ones)
    within the TF32 tolerance — and farther from it than 'highest' is."""
    a, w, A, W = _gemm_operands(G + rows + N + K, G, rows, N, K, a_trans,
                                w_kmajor)
    kw = dict(a_trans=a_trans, w_kmajor=w_kmajor)
    got = gemm_f32_plain(a, w, tf32=True, **kw).numpy()
    Ar = round_tf32(torch.from_numpy(A.copy())).numpy().astype(np.float64)
    Wr = round_tf32(torch.from_numpy(W.copy())).numpy().astype(np.float64)
    mag = np.abs(Ar) @ np.abs(Wr)
    assert (np.abs(got - Ar @ Wr) <= K * 2.0 ** -24 * mag).all()
    ieee = np.asarray(jnp.matmul(jnp.asarray(A), jnp.asarray(W),
                                 precision=jax.lax.Precision.HIGHEST))
    tol = (2.0 ** -10 + 2.0 ** -22 + 2 * K * 2.0 ** -24) * mag
    assert (np.abs(got - ieee) <= tol).all()
    highest = gemm_f32_plain(a, w, **kw).numpy()
    assert np.abs(highest - ieee).max() < np.abs(got - ieee).max()


def test_gemm_plain_default_reads_the_process_mode_never():
    """The plain version is IEEE f32 without ``tf32`` and the TF32
    emulation with it, whatever the process's matmul mode."""
    a, w, _, _ = _gemm_operands(3, 1, 40, 24, 64, False, True)
    want = {t: gemm_f32_plain(a, w, tf32=t) for t in (False, True)}
    for mode in ("medium", "high"):
        before = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision(mode)
        try:
            for t, v in want.items():
                assert torch.equal(gemm_f32_plain(a, w, tf32=t), v)
        finally:
            torch.set_float32_matmul_precision(before)


# ---- the chains with their TF32 emulation, against JAX at 'highest' ---------

E, M, C = 64, 3, 6


@contextlib.contextmanager
def tf32_emulated():
    """The chains' CPU branches with the TF32 emulation passed on
    (``tf32=True``), as the card runs their products at 'default'; a
    'highest' reference is computed outside the block."""
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((sq, "shared_query_fwd_plain"),
                          (sq, "shared_query_bwd_plain"),
                          (ts, "train_step_plain")):
            mp.setattr(mod, name, functools.partial(getattr(mod, name),
                                                    tf32=True))
        yield


def _arrays(seed, B=100, head=False):
    rng = np.random.default_rng(seed)
    arrs = {
        "in_proj_weight": rng.uniform(-0.2, 0.2, (3 * E, E)),
        "out_proj_weight": rng.uniform(-0.2, 0.2, (E, E)),
        "in_proj_bias": 0.1 * rng.standard_normal(3 * E),
        "out_proj_bias": 0.1 * rng.standard_normal(E),
    }
    x = {k: v.astype(np.float32) for k, v in arrs.items()}
    x["q"] = (np.sqrt(2.0 / E) * rng.standard_normal((1, 1, E))).astype(
        np.float32)
    x["kv"] = rng.standard_normal((B, M, E)).astype(np.float32)
    if head:
        x["hw"] = rng.uniform(-0.1, 0.1, (E, C)).astype(np.float32)
        x["hb"] = rng.uniform(-0.1, 0.1, C).astype(np.float32)
        x["labels"] = (rng.random((B, C)) < 0.3).astype(np.float32)
    return x


def _jp(x):
    return JaxParams(**{k: jnp.asarray(x[k]) for k in POOL})


def _tp(x, grad=False):
    return AttentionPoolParams(**{
        k: torch.from_numpy(x[k].copy()).requires_grad_(grad) for k in POOL})


def _port_step(x, precision, head):
    kw = dict(training=False, precision=precision)
    if head:
        loss, grads, _, _ = fused_pool_head_train_step(
            _tp(x), torch.from_numpy(x["q"]),
            {"w": torch.from_numpy(x["hw"]), "b": torch.from_numpy(x["hb"])},
            torch.from_numpy(x["kv"]), torch.from_numpy(x["labels"]), **kw)
        return loss, grads["pool"], grads["query"], grads["head"]
    loss, d_pool, d_query, _, _ = fused_pool_train_step(
        _tp(x), torch.from_numpy(x["q"]), torch.from_numpy(x["kv"]), **kw)
    return loss, d_pool, d_query, None


@pytest.mark.parametrize("head", [False, True], ids=["quadratic", "bce_head"])
def test_step_tf32_matches_jax_highest(head):
    """The one-pass step (#8) at 'default' with the chain's TF32 products
    emulated: loss, pool, query and head gradients within TF32_REL of
    JAX's IEEE f32 step (training=False: the gradients do not depend on
    the draw, quirk Q1) — and not equal to the port's 'highest' step."""
    x = _arrays(1 + head, head=head)
    jkw = dict(rng=None, training=False, precision="highest", interpret=True)
    if head:
        loss_j, grads_j, _, _ = jax_head_step(
            _jp(x), jnp.asarray(x["q"]),
            {"w": jnp.asarray(x["hw"]), "b": jnp.asarray(x["hb"])},
            jnp.asarray(x["kv"]), jnp.asarray(x["labels"]), **jkw)
        dp_j, dq_j, dh_j = grads_j["pool"], grads_j["query"], grads_j["head"]
    else:
        loss_j, dp_j, dq_j, _, _ = jax_step(
            _jp(x), jnp.asarray(x["q"]), jnp.asarray(x["kv"]), **jkw)
        dh_j = None
    with tf32_emulated():
        loss, dp, dq, dh = _port_step(x, "default", head)
    rel_close(float(loss), float(loss_j), TF32_REL, "loss")
    for k in POOL:
        rel_close(dp[k].numpy(), getattr(dp_j, k), TF32_REL, k)
    rel_close(dq.numpy(), dq_j, TF32_REL, "query")
    if head:
        rel_close(dh["w"].numpy(), dh_j["w"], TF32_REL, "head w")
        rel_close(dh["b"].numpy(), dh_j["b"], TF32_REL, "head b")
    ieee = _port_step(x, "highest", head)[1]
    assert not torch.equal(dp["out_proj_weight"], ieee["out_proj_weight"])


@pytest.mark.parametrize("H", [1, 4])
def test_forward_tf32_matches_jax_highest(H):
    """The resident forward (#1) at 'default', eval, with its context GEMMs
    emulated in TF32: out within TF32_REL, the weights and entropy (f32
    row work on the same u and c) within 1e-6, of JAX's HIGHEST forward."""
    x = _arrays(10 + H, B=37)
    kpm = np.random.default_rng(H).random((37, M)) < 0.3
    kpm[:, 0] = False
    j_out, j_w, _, j_info = jax_shared(
        _jp(x), jnp.asarray(x["q"]), jnp.asarray(x["kv"]), num_heads=H,
        training=False, interpret=True, precision="highest",
        key_padding_mask=jnp.asarray(kpm))
    with torch.no_grad():
        with tf32_emulated():
            out, w, _, info = fused_fusion_pool_shared(
                _tp(x), torch.from_numpy(x["q"]), torch.from_numpy(x["kv"]),
                num_heads=H, precision="default",
                key_padding_mask=torch.from_numpy(kpm))
        ieee = fused_fusion_pool_shared(
            _tp(x), torch.from_numpy(x["q"]), torch.from_numpy(x["kv"]),
            num_heads=H, precision="highest",
            key_padding_mask=torch.from_numpy(kpm))[0]
    rel_close(out.numpy(), j_out, TF32_REL, "out")
    np.testing.assert_allclose(w.numpy(), j_w, atol=1e-6)
    np.testing.assert_allclose(info["entropy"].numpy(), j_info["entropy"],
                               atol=1e-6)
    assert not torch.equal(out, ieee)


@pytest.mark.parametrize("H", [1, 4])
def test_training_forward_tf32_matches_jax_with_injected_mask(H):
    """The training forward (#1) at 'default', TF32 emulated, against JAX's
    HIGHEST forward and ``curriculum_mask`` fed the port's own Philox
    draw (``mask_override``: the TPU PRNG has no interpret lowering): out
    within TF32_REL, weights, masked weights, entropy and rate within
    1e-6."""
    from aecf_tpu.core.masking import curriculum_mask as jax_mask
    from aecf_tpu_torch.kernels.draws import draw_seed_words, mask_uniforms

    x = _arrays(70 + H, B=40)
    j_out, j_w, _, _ = jax_shared(
        _jp(x), jnp.asarray(x["q"]), jnp.asarray(x["kv"]), num_heads=H,
        training=False, interpret=True, precision="highest")
    with torch.no_grad(), tf32_emulated():
        out, w, mw, info = fused_fusion_pool_shared(
            _tp(x), torch.from_numpy(x["q"]), torch.from_numpy(x["kv"]),
            num_heads=H, training=True, base_mask_prob=0.9, min_active=2,
            generator=torch.Generator().manual_seed(H), precision="default")
    seed = draw_seed_words(torch.Generator().manual_seed(H))
    keep = 1.0 - 0.9 * (info["entropy"][:, 0] / math.log(M)).clamp(0.0, 1.0)
    drawn = (mask_uniforms(seed, 40, M) < keep[:, None]).float().numpy()
    j_mw, j_info = jax_mask(j_w, training=True, base_mask_prob=0.9,
                            min_active=2, mask_override=drawn[:, None, :])
    rel_close(out.numpy(), j_out, TF32_REL, "out")
    np.testing.assert_allclose(w.numpy(), j_w, atol=1e-6)
    np.testing.assert_allclose(mw.numpy(), j_mw, atol=1e-6)
    for k in ("entropy", "mask_rate"):
        np.testing.assert_allclose(info[k].numpy(), j_info[k], atol=1e-6,
                                   err_msg=k)
    assert float(info["mask_rate"].mean()) > 0.1


def test_backward_tf32_matches_jax_highest():
    """Gradients through the resident forward and the H = 1 backward (#4)
    at 'default', d_mix and G emulated in TF32, against JAX's HIGHEST
    gradients (interpret mode), padded slots, d_kv included."""
    x = _arrays(21, B=50)
    kpm = np.random.default_rng(5).random((50, M)) < 0.3
    kpm[:, 0] = False

    def loss_of(o, w):
        return (o * o).mean() + (w[:, 0, 0] * w[:, 0, 1]).sum()

    def jax_loss(p, q, kv):
        o, w, _, _ = jax_shared(p, q, kv, num_heads=1, training=False,
                                interpret=True, precision="highest",
                                key_padding_mask=jnp.asarray(kpm))
        return loss_of(o, w)

    grads_j = jax.grad(jax_loss, (0, 1, 2))(
        _jp(x), jnp.asarray(x["q"]), jnp.asarray(x["kv"]))
    tp = _tp(x, grad=True)
    tq = torch.from_numpy(x["q"].copy()).requires_grad_()
    tkv = torch.from_numpy(x["kv"].copy()).requires_grad_()
    with tf32_emulated():
        o, w, _, _ = fused_fusion_pool_shared(
            tp, tq, tkv, num_heads=1, precision="default",
            key_padding_mask=torch.from_numpy(kpm))
        loss_of(o, w).backward()
    for k in POOL:
        rel_close(getattr(tp, k).grad.numpy(), getattr(grads_j[0], k),
                  TF32_REL, k)
    rel_close(tq.grad.numpy(), grads_j[1], TF32_REL, "query")
    rel_close(tkv.grad.numpy(), grads_j[2], TF32_REL, "kv")


def test_cpu_default_is_ieee_f32():
    """Without the emulation the wrappers' CPU branches compute 'default'
    as 'highest' (JAX's CPU backend runs f32 dots in f32): the forward, the
    backward and the step equal their 'highest' calls bit for bit."""
    x = _arrays(30, B=40, head=True)
    with torch.no_grad():
        u, c, wctx, bctx, wo, bo = sq._prep(_tp(x), torch.from_numpy(
            x["q"])[0, 0], 1)
    kv = torch.from_numpy(x["kv"])
    d_out = torch.from_numpy(
        np.random.default_rng(1).standard_normal((40, E)).astype(np.float32))
    fwd = {p: shared_query_fwd(kv, u, c, None, wctx, bctx, precision=p)
           for p in ("highest", "default")}
    bwd = {p: shared_query_bwd(kv, u[0], c, None, d_out, None, wctx,
                               want_dkv=True, precision=p)
           for p in ("highest", "default")}
    step = {p: train_step(kv, u[0], c, None, wctx, bctx, inv=0.01,
                          want_dkv=True, head_w=torch.from_numpy(x["hw"]),
                          head_b=torch.from_numpy(x["hb"]),
                          labels=torch.from_numpy(x["labels"]), precision=p)
            for p in ("highest", "default")}
    assert all(torch.equal(a, b) for a, b in zip(*fwd.values()))
    assert all(torch.equal(a, b) for a, b in zip(*bwd.values()))
    assert all(v is None or torch.equal(v, step["default"][k])
               for k, v in step["highest"].items())


@pytest.mark.parametrize("entry", ["shared_query_fwd", "train_step",
                                   "stream_mix"])
def test_wrappers_take_default_or_highest(entry):
    kv = torch.zeros(4, 2, 8)
    u, c = torch.zeros(1, 8), torch.zeros(1)
    with pytest.raises(ValueError, match="'default' or 'highest'"):
        if entry == "shared_query_fwd":
            shared_query_fwd(kv, u, c, None, torch.zeros(8, 8), torch.zeros(8),
                             precision="high")
        elif entry == "train_step":
            train_step(kv, u[0], c, None, torch.zeros(8, 8), torch.zeros(8),
                       inv=1.0, want_dkv=False, precision="high")
        else:
            stream_mix(kv, u, c, None, precision="high")


# ---- the streamed split at 'default', against JAX's at 'default' -------------


def _streamed_arrays(seed, B, E_, padded=False):
    rng = np.random.default_rng(seed)
    bound = math.sqrt(6.0 / (4 * E_))
    x = {
        "in_proj_weight": rng.uniform(-bound, bound, (3 * E_, E_)),
        "out_proj_weight": rng.uniform(-E_ ** -0.5, E_ ** -0.5, (E_, E_)),
        "in_proj_bias": 0.1 * rng.standard_normal(3 * E_),
        "out_proj_bias": 0.1 * rng.standard_normal(E_),
    }
    x = {k: v.astype(np.float32) for k, v in x.items()}
    x["q"] = rng.standard_normal((1, 1, E_)).astype(np.float32)
    x["kv"] = rng.standard_normal((B, M, E_)).astype(np.float32)
    x["kpm"] = None
    if padded:
        x["kpm"] = rng.random((B, M)) < 0.3
        x["kpm"][:, 0] = False
    return x


@pytest.mark.parametrize("H,E_", [(1, 2048), (2, 2048), (2, 512)])
def test_streamed_default_matches_jax_default(H, E_):
    """Loss, out and every gradient through the streamed split at
    'default' (bf16 mix and d_mix on both sides; at H = 2, E = 512 the
    gradients' route) within STREAM_REL of JAX's streamed Pallas kernels at
    'default', padded slots; the port's 'default' differs from its
    'highest' (the bf16 round trips are on)."""
    x = _streamed_arrays(40 + H + E_, 8, E_, padded=True)
    kpm = x["kpm"]

    def loss_of(o, w):
        return (o * o).mean() + (w * w).sum()

    def jax_loss(p, q, kv):
        o, w, _, _ = jax_shared(p, q, kv, num_heads=H, training=False,
                                interpret=True, precision="default",
                                key_padding_mask=jnp.asarray(kpm))
        return loss_of(o, w), o

    (loss_j, out_j), grads_j = jax.value_and_grad(
        jax_loss, (0, 1, 2), has_aux=True)(
        _jp(x), jnp.asarray(x["q"]), jnp.asarray(x["kv"]))
    outs = {}
    for precision in ("default", "highest"):
        tp = _tp(x, grad=True)
        tq = torch.from_numpy(x["q"].copy()).requires_grad_()
        tkv = torch.from_numpy(x["kv"].copy()).requires_grad_()
        o, w, _, _ = fused_fusion_pool_shared(
            tp, tq, tkv, num_heads=H, precision=precision,
            key_padding_mask=torch.from_numpy(kpm))
        loss = loss_of(o, w)
        loss.backward()
        outs[precision] = (loss, o, tp, tq, tkv)
    loss, o, tp, tq, tkv = outs["default"]
    rel_close(loss.item(), float(loss_j), STREAM_REL, "loss")
    rel_close(o.detach().numpy(), out_j, STREAM_REL, "out")
    for k in POOL:
        rel_close(getattr(tp, k).grad.numpy(), getattr(grads_j[0], k),
                  STREAM_REL, k)
    rel_close(tq.grad.numpy(), grads_j[1], STREAM_REL, "query")
    rel_close(tkv.grad.numpy(), grads_j[2], STREAM_REL, "kv")
    assert not torch.equal(o, outs["highest"][1])


@pytest.mark.parametrize("H", [1, 2])
def test_streamed_default_matches_the_torch_oracle_with_mask_injection(H):
    """Training through the streamed split at 'default' against
    ``attention_pool_core`` + ``curriculum_mask`` fed the port's own
    Bernoulli draw (``mask_override``): weights, masked weights, entropy
    and rate within 1e-6 (f32 row work at both precisions); out within one
    bf16 step, 2^-8, of the oracle's largest entry (each mix element moves
    by at most 2^-9 of itself, and the errors of the E terms of an output
    mostly cancel)."""
    from aecf_tpu_torch.core import attention_pool_core
    from aecf_tpu_torch.core.masking import curriculum_mask
    from aecf_tpu_torch.kernels.draws import draw_seed_words, mask_uniforms

    B, M_, E_ = 40, 4, 1028
    rng = np.random.default_rng(80 + H)
    bound = math.sqrt(6.0 / (4 * E_))
    arrs = {
        "in_proj_weight": rng.uniform(-bound, bound, (3 * E_, E_)),
        "out_proj_weight": rng.uniform(-E_ ** -0.5, E_ ** -0.5, (E_, E_)),
        "in_proj_bias": 0.1 * rng.standard_normal(3 * E_),
        "out_proj_bias": 0.1 * rng.standard_normal(E_),
    }
    tp = AttentionPoolParams(**{k: torch.from_numpy(v.astype(np.float32))
                                for k, v in arrs.items()})
    q = torch.from_numpy(rng.standard_normal((1, 1, E_)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((B, M_, E_)).astype(np.float32))
    with torch.no_grad():
        out, w, mw, info = fused_fusion_pool_shared(
            tp, q, kv, num_heads=H, training=True, base_mask_prob=0.9,
            min_active=2, generator=torch.Generator().manual_seed(H),
            precision="default")
        ieee = fused_fusion_pool_shared(
            tp, q, kv, num_heads=H, training=True, base_mask_prob=0.9,
            min_active=2, generator=torch.Generator().manual_seed(H),
            precision="highest")[0]
        out_o, w_o = attention_pool_core(tp, q.expand(B, 1, E_), kv, kv,
                                         num_heads=H, need_weights=True)
    seed = draw_seed_words(torch.Generator().manual_seed(H))
    keep = 1.0 - 0.9 * (info["entropy"][:, 0] / math.log(M_)).clamp(0.0, 1.0)
    drawn = (mask_uniforms(seed, B, M_) < keep[:, None]).float()
    mw_o, info_o = curriculum_mask(w_o, training=True, base_mask_prob=0.9,
                                   min_active=2,
                                   mask_override=drawn[:, None, :])
    rel_close(out.numpy(), out_o.numpy(), 2.0 ** -8, "out")
    np.testing.assert_allclose(w.numpy(), w_o.numpy(), atol=1e-6)
    np.testing.assert_allclose(mw.numpy(), mw_o.numpy(), atol=1e-6)
    for k in ("entropy", "mask_rate"):
        np.testing.assert_allclose(info[k].numpy(), info_o[k].numpy(),
                                   atol=1e-6, err_msg=k)
    assert float(info["mask_rate"].mean()) > 0.1
    assert not torch.equal(out, ieee)


def test_streamed_kernels_store_and_take_bf16():
    """``stream_mix`` stores mix in bf16 at 'default' (the f32 sum rounded
    to nearest even) and f32 at 'highest'; ``stream_bwd`` takes a bf16
    d_mix, equal to its plain version on the upcast values."""
    rng = np.random.default_rng(7)
    kv = torch.from_numpy(rng.standard_normal((5, 3, 16)).astype(np.float32))
    u = torch.from_numpy(0.3 * rng.standard_normal((1, 16)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal(1).astype(np.float32))
    hi = stream_mix(kv, u, c, None)
    de = stream_mix(kv, u, c, None, precision="default")
    assert hi[0].dtype == torch.float32 and de[0].dtype == torch.bfloat16
    assert torch.equal(de[0], hi[0].bfloat16())
    assert all(torch.equal(a, b) for a, b in zip(de[1:], hi[1:]))
    assert torch.equal(stream_mix_plain(kv, u, c, None,
                                        precision="default")[0], de[0])
    d_mix = torch.from_numpy(rng.standard_normal((5, 16)).astype(
        np.float32)).bfloat16()
    got = stream_bwd(kv, d_mix, None, None, u, c, want_dkv=True)
    want = stream_bwd_plain(kv, d_mix.float(), None, None, u, c,
                            want_dkv=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---- matmul_precision --------------------------------------------------------


@pytest.fixture
def process_mode():
    before = torch.get_float32_matmul_precision()
    yield
    torch.set_float32_matmul_precision(before)


@pytest.mark.parametrize("start", ["highest", "medium"])
def test_matmul_precision_nests_more_precise_never_less(process_mode, start):
    """'default' runs under TF32 ('high'); a 'highest' block nested in it
    is IEEE and a 'default' block nested in that stays IEEE; each exit
    gives back what the enclosing blocks ask for, the last the process's
    own mode — also when a block raises."""
    torch.set_float32_matmul_precision(start)
    mode = torch.get_float32_matmul_precision
    with matmul_precision("default"):
        assert mode() == "high"
        with matmul_precision("highest"):
            assert mode() == "highest"
            with matmul_precision("default"):
                assert mode() == "highest"
            assert mode() == "highest"
        assert mode() == "high"
        with pytest.raises(RuntimeError):
            with matmul_precision("high"):
                assert mode() == "high"
                raise RuntimeError("inside")
        assert mode() == "high"
    assert mode() == start
    with pytest.raises(ValueError, match="precision"):
        with matmul_precision("fast"):
            pass
    assert mode() == start


def test_matmul_precision_threads_share_one_count_a_mode(process_mode):
    """Thread a holds 'highest' while thread b enters 'default': the
    process stays IEEE; a leaves and b, still inside, gets TF32; b leaves
    and the mode the first block found comes back."""
    torch.set_float32_matmul_precision("medium")
    a_in, b_in, a_out, b_read = (threading.Event() for _ in range(4))
    seen, errors = {}, []

    def run_a():
        try:
            with matmul_precision("highest"):
                a_in.set()
                assert b_in.wait(10)
                seen["a, b inside"] = torch.get_float32_matmul_precision()
        except BaseException as e:  # reported in the test's thread
            errors.append(e)
        finally:
            a_out.set()

    def run_b():
        try:
            assert a_in.wait(10)
            with matmul_precision("default"):
                seen["b, a inside"] = torch.get_float32_matmul_precision()
                b_in.set()
                assert a_out.wait(10)
                seen["b alone"] = torch.get_float32_matmul_precision()
        except BaseException as e:
            errors.append(e)
            b_in.set()
        finally:
            b_read.set()

    threads = [threading.Thread(target=f) for f in (run_a, run_b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errors, errors
    assert seen == {"b, a inside": "highest", "a, b inside": "highest",
                    "b alone": "high"}
    assert torch.get_float32_matmul_precision() == "medium"


@pytest.mark.parametrize("precision,process", [("default", "highest"),
                                               ("highest", "high")])
def test_backward_runs_in_its_forwards_mode(monkeypatch, process_mode,
                                            precision, process):
    """Autograd calls the backward outside the forward's block: it enters
    the forward's mode itself, and its chain gets the forward's precision
    — a 'default' forward under an IEEE process, a 'highest' forward under
    a TF32 one."""
    torch.set_float32_matmul_precision(process)
    seen = []
    real = sq.shared_query_bwd

    def spy(*args, **kwargs):
        seen.append((torch.get_float32_matmul_precision(),
                     kwargs["precision"]))
        return real(*args, **kwargs)

    monkeypatch.setattr(sq, "shared_query_bwd", spy)
    x = _arrays(50, B=20)
    tp = _tp(x, grad=True)
    out, _, _, _ = fused_fusion_pool_shared(
        tp, torch.from_numpy(x["q"]), torch.from_numpy(x["kv"]),
        precision=precision)
    assert torch.get_float32_matmul_precision() == process
    (out ** 2).sum().backward()
    assert seen == [("highest" if precision == "highest" else "high",
                     precision)]
    assert torch.get_float32_matmul_precision() == process


def test_per_row_kernel_is_the_same_at_both_precisions(monkeypatch):
    """Kernel #7 (the per-row query) runs IEEE f32 at every precision, as
    JAX's: ``ops.fusion_pool`` passes it no precision, and its outputs at
    'default' equal those at 'highest' bit for bit."""
    from aecf_tpu_torch import ops

    calls = []
    real = ops.fused_fusion_pool

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(ops, "fused_fusion_pool", spy)
    x = _arrays(60, B=24)
    rows = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (24, 1, E)).astype(np.float32))
    outs = {p: fusion_pool(_tp(x), rows, torch.from_numpy(x["kv"]),
                           implementation="kernel", precision=p)
            for p in ("highest", "default")}
    assert len(calls) == 2 and all("precision" not in kw for kw in calls)
    assert all(torch.equal(a, b) for a, b in zip(outs["highest"][:3],
                                                 outs["default"][:3]))
