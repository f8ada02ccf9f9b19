"""The resident forwards above two heads against the JAX package's kernels.

The port's shared-query forward (``_shared_kernel`` / ``_shared_kernel_q8``)
and per-row forward (``_fusion_kernel``) take any H dividing E (the
per-row one with E a multiple of 4·H), as JAX's kernels do when forced.
On the CPU the port runs the kernels' plain versions; the JAX reference
runs its Pallas kernels in interpret mode at ``precision="highest"``, as
``test_kernels_interpret.py`` does.  Same numpy inputs, made from a seed.

JAX's Pallas training branch has no interpret lowering (``prng_seed``), so
training holds ``out``, the weights and the entropy to JAX's XLA path and
the masks to the port's ``mask_and_renorm`` on the same Philox uniforms.

Tolerances, those the H <= 2 port tests use for the same outputs: weights
and entropy 1e-5 (f32 sums in other orders), outputs 2e-5 of their
largest entry, ``mw == w`` exactly in eval; bf16 features 1e-5 on the
weights (both sides round the same f32 values to bf16); gradients rtol
2e-4 / atol 2e-5 (the JAX q8 tests' own); masks 1e-6.

The CUDA kernels themselves run only on the card, where ``chip_smoke.py``
holds them to their plain versions at H in {3, 4, 8}.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aecf_tpu.core.attention import AttentionPoolParams as JaxParams
from aecf_tpu.kernels import fused_fusion_pool as jax_fused
from aecf_tpu.kernels import fused_fusion_pool_shared as jax_shared
from aecf_tpu.ops import fusion_pool as jax_fusion_pool
from aecf_tpu_torch.core import AttentionPoolParams
from aecf_tpu_torch.kernels import (
    fused_fusion_pool,
    fused_fusion_pool_shared,
    quantize_features,
    shared_query_fwd,
)
from aecf_tpu_torch.kernels.draws import (
    draw_seed_words,
    mask_and_renorm,
    mask_uniforms,
)
from aecf_tpu_torch.ops import _wants_kernel

W_TOL = 1e-5
OUT_REL = 2e-5
# E for each head count: H divides E (E=96 for H=3)
WIDTH = {3: 96, 4: 64, 8: 64}


def _inputs(seed, B, M, E, padded=False, query_rows=1):
    """Pool parameters at the reference's init scales (biases nonzero), a
    query of ``query_rows`` rows, f32 features; ``padded`` pads ~30% of
    the slots, never slot 0."""
    rng = np.random.default_rng(seed)
    bound = math.sqrt(6.0 / (4 * E))
    arrs = {
        "in_proj_weight": rng.uniform(-bound, bound, (3 * E, E)),
        "out_proj_weight": rng.uniform(-E ** -0.5, E ** -0.5, (E, E)),
        "in_proj_bias": 0.1 * rng.standard_normal(3 * E),
        "out_proj_bias": 0.1 * rng.standard_normal(E),
    }
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    q = rng.standard_normal((query_rows, 1, E)).astype(np.float32)
    kv = rng.standard_normal((B, M, E)).astype(np.float32)
    kpm = None
    if padded:
        kpm = rng.random((B, M)) < 0.3
        kpm[:, 0] = False
    return arrs, q, kv, kpm


def _jax_params(arrs):
    return JaxParams(**{k: jnp.asarray(v) for k, v in arrs.items()})


def _torch_params(arrs, grad=False):
    return AttentionPoolParams(**{
        k: torch.from_numpy(v).requires_grad_(grad) for k, v in arrs.items()
    })


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _features(kv, dtype):
    """``(port kv, port scales, JAX kv, JAX scales)`` in ``dtype``: bf16 a
    cast on both sides (round to nearest even); int8 from the port's
    ``quantize_features`` (equal to JAX's bit for bit)."""
    x = torch.from_numpy(kv)
    if dtype == "int8":
        q, s = quantize_features(x)
        return q, s, jnp.asarray(q.numpy()), jnp.asarray(s.numpy())
    if dtype == "bf16":
        return x.bfloat16(), None, jnp.asarray(kv, jnp.bfloat16), None
    return x, None, jnp.asarray(kv), None


def _close_out(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want,
                               atol=OUT_REL * float(np.abs(want).max()))


# ---- the shared-query forward (#1, #2) ---------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("H", [3, 4, 8])
def test_shared_eval_matches_jax_interpret(H, dtype):
    """Eval, with and without ``key_padding_mask``: out, weights and
    entropy against JAX's Pallas kernel (``_shared_kernel``, or
    ``_shared_kernel_q8`` for int8 with ``kv_scales``)."""
    B, M, E = 13, 3, WIDTH[H]
    for padded in (False, True):
        arrs, q, kv, kpm = _inputs(10 * H + padded, B, M, E, padded)
        kv_t, s_t, kv_j, s_j = _features(kv, dtype)
        j_out, j_w, _, j_info = jax_shared(
            _jax_params(arrs), jnp.asarray(q), kv_j, num_heads=H,
            training=False, key_padding_mask=_j(kpm), kv_scales=s_j,
            interpret=True, precision="highest",
        )
        with torch.no_grad():
            out, w, mw, info = fused_fusion_pool_shared(
                _torch_params(arrs), _t(q), kv_t, num_heads=H,
                key_padding_mask=_t(kpm), kv_scales=s_t, precision="highest",
            )
        assert tuple(out.shape) == (B, 1, E) and tuple(w.shape) == (B, 1, M)
        _close_out(out.numpy(), j_out)
        np.testing.assert_allclose(w.numpy(), j_w, atol=W_TOL)
        np.testing.assert_allclose(info["entropy"].numpy(), j_info["entropy"],
                                   atol=W_TOL)
        np.testing.assert_array_equal(mw.numpy(), w.numpy())
        assert (info["mask_rate"] == 0).all()
        if padded:
            assert float(w[_t(kpm)[:, None, :]].abs().max()) == 0.0


@pytest.mark.parametrize("H", [3, 4, 8])
def test_shared_training_matches_xla_and_the_mask_chain(H):
    """Training: out, weights and entropy against JAX's XLA path (the mask
    does not enter them, quirk Q1); the masks against ``mask_and_renorm``
    on the Philox uniforms of the call's seed words.  The H <= 2 cases run
    the same way in ``test_training_heads_up_to_two``."""
    _check_training(H, 60 + H)


@pytest.mark.parametrize("H", [1, 2])
def test_training_heads_up_to_two(H):
    _check_training(H, 70 + H)


def _check_training(H, seed):
    B, M, E = 24, 3, WIDTH.get(H, 64)
    arrs, q, kv, kpm = _inputs(seed, B, M, E, padded=True)
    j_out, j_w, _, j_info = jax_fusion_pool(
        _jax_params(arrs), jnp.asarray(q), jnp.asarray(kv), num_heads=H,
        training=True, rng=jax.random.key(seed), key_padding_mask=_j(kpm),
        base_mask_prob=0.6, min_active=2, implementation="xla",
    )
    words = draw_seed_words(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        out, w, mw, info = fused_fusion_pool_shared(
            _torch_params(arrs), _t(q), _t(kv), num_heads=H, training=True,
            generator=torch.Generator().manual_seed(seed), base_mask_prob=0.6,
            min_active=2, key_padding_mask=_t(kpm), precision="highest",
        )
    _close_out(out.numpy(), j_out)
    np.testing.assert_allclose(w.numpy(), j_w, atol=W_TOL)
    np.testing.assert_allclose(info["entropy"].numpy(), j_info["entropy"],
                               atol=W_TOL)
    ent = info["entropy"][:, 0]
    want_mw, want_rate, mask = mask_and_renorm(
        w[:, 0], ent, mask_uniforms(words, B, M), mask_prob=0.6, min_active=2)
    np.testing.assert_allclose(mw[:, 0].numpy(), want_mw.numpy(), atol=1e-6)
    np.testing.assert_allclose(info["mask_rate"][:, 0].numpy(),
                               want_rate.numpy(), atol=1e-6)
    assert 0.0 < float(mask.mean()) < 1.0


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_shared_grads_at_h4_match_jax(dtype):
    """Gradients at H=4 (the plain forward, then ``_bwd_heads`` in torch)
    against ``jax.grad`` of JAX's function (its XLA backward): the pool's
    parameters and the query, and ``kv`` for f32 (int8 features are
    frozen)."""
    H, B, M, E = 4, 11, 3, 64
    arrs, q, kv, kpm = _inputs(80, B, M, E, padded=True)
    kv_t, s_t, kv_j, s_j = _features(kv, dtype)
    q8 = dtype == "int8"

    def loss(out, w, info, lib):
        return (lib.sum(out ** 2) + lib.sum(w)
                + 0.1 * lib.sum(info["entropy"]))

    def jax_loss(p, qq, feats):
        out, w, _, info = jax_shared(
            p, qq, feats, num_heads=H, training=False, kv_scales=s_j,
            key_padding_mask=_j(kpm), precision="highest", interpret=True,
        )
        return loss(out, w, info, jnp)

    argnums = (0, 1) if q8 else (0, 1, 2)
    loss_j, grads_j = jax.value_and_grad(jax_loss, argnums)(
        _jax_params(arrs), jnp.asarray(q), kv_j)
    tp = _torch_params(arrs, grad=True)
    tq = _t(q).requires_grad_()
    tkv = kv_t if q8 else kv_t.clone().requires_grad_()
    out, w, _, info = fused_fusion_pool_shared(
        tp, tq, tkv, num_heads=H, kv_scales=s_t, key_padding_mask=_t(kpm),
        precision="highest",
    )
    loss_t = loss(out, w, info, torch)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-6)
    tol = dict(rtol=2e-4, atol=2e-5)
    for name in ("in_proj_weight", "out_proj_weight", "in_proj_bias",
                 "out_proj_bias"):
        np.testing.assert_allclose(getattr(tp, name).grad.numpy(),
                                   getattr(grads_j[0], name), **tol,
                                   err_msg=name)
    np.testing.assert_allclose(tq.grad.numpy(), grads_j[1], **tol)
    if not q8:
        np.testing.assert_allclose(tkv.grad.numpy(), grads_j[2], **tol)


# ---- the per-row forward (#7) -------------------------------------------------


@pytest.mark.parametrize("H", [4, 8])
def test_per_row_eval_matches_jax_interpret(H):
    """``fused_fusion_pool`` (#7, a (B, 1, E) query) at H=4 and H=8, with
    and without padding, against JAX's ``_fusion_kernel`` in interpret
    mode."""
    B, M, E = 9, 3, 64
    for padded in (False, True):
        arrs, q, kv, kpm = _inputs(90 + H + padded, B, M, E, padded,
                                   query_rows=B)
        j_out, j_w, _, j_info = jax_fused(
            _jax_params(arrs), jnp.asarray(q), jnp.asarray(kv), num_heads=H,
            training=False, key_padding_mask=_j(kpm), interpret=True,
        )
        with torch.no_grad():
            out, w, mw, info = fused_fusion_pool(
                _torch_params(arrs), _t(q), _t(kv), num_heads=H,
                key_padding_mask=_t(kpm),
            )
        _close_out(out.numpy(), j_out)
        np.testing.assert_allclose(w.numpy(), j_w, atol=W_TOL)
        np.testing.assert_allclose(info["entropy"].numpy(), j_info["entropy"],
                                   atol=W_TOL)
        np.testing.assert_array_equal(mw.numpy(), w.numpy())


# ---- what still raises, and the gate ------------------------------------------


def _zeros_params(E):
    return AttentionPoolParams(torch.zeros(3 * E, E), torch.zeros(E, E))


def _shared(E, H):
    fused_fusion_pool_shared(_zeros_params(E), torch.zeros(1, 1, E),
                             torch.zeros(2, 3, E), num_heads=H)


def _shared_wrapper(E, H):
    shared_query_fwd(torch.zeros(2, 3, E), torch.zeros(H, E), torch.zeros(H),
                     None, torch.zeros(E, E), torch.zeros(E),
                     torch.zeros(E, E), torch.zeros(E))


def _per_row(E, H):
    fused_fusion_pool(_zeros_params(E), torch.zeros(2, 1, E),
                      torch.zeros(2, 3, E), num_heads=H)


LIMITS = {
    # only the streamed split (H <= 2) runs above the resident cap, in JAX
    # too
    "shared_h4_above_the_resident_cap": (lambda: _shared(1152, 4),
                                         "needs num_heads<=2"),
    "shared_h_not_dividing_e": (lambda: _shared(96, 5), "H dividing E"),
    "wrapper_h_not_dividing_e": (lambda: _shared_wrapper(96, 5),
                                 "H dividing E"),
    # the per-row kernel reads each head's slice as float4
    "per_row_e_not_a_multiple_of_4h": (lambda: _per_row(104, 4),
                                       "multiple of 4\\*H"),
}


@pytest.mark.parametrize("name", sorted(LIMITS))
def test_head_limits_that_remain(name):
    call, match = LIMITS[name]
    with pytest.raises(ValueError, match=match):
        call()


def test_auto_keeps_more_than_two_heads_on_torch():
    """``'auto'`` routes as the JAX package does: H > 2 takes the torch
    path even for features that look like the card's (the kernels take
    H > 2 only when forced)."""

    class OnCard:
        is_cuda = True

        def __init__(self, x):
            self.shape, self.dtype = x.shape, x.dtype

    kv = OnCard(torch.zeros(4, 3, 64))
    params = AttentionPoolParams(torch.zeros(192, 64), torch.zeros(64, 64))
    for H, want in ((1, True), (2, True), (4, False), (8, False)):
        for q in (torch.zeros(1, 1, 64), torch.zeros(4, 1, 64)):
            assert _wants_kernel(params, q, kv, num_heads=H,
                                 precision="highest") is want
