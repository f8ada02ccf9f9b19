"""The port's per-row-query fusion pool against the JAX kernel.

On the CPU the port's ``fused_fusion_pool`` runs the plain PyTorch version
of its CUDA kernel (``fused_pool_fwd_plain``); the JAX reference runs its
Pallas kernel ``_fusion_kernel`` in interpret mode, as
``test_kernels_interpret.py`` does.  Same numpy inputs, made from a seed.

Tolerances: out, weights and entropy 1e-5 (f32 sums in other orders);
bf16 query and features 5e-2 (``tests/test_ops.py``'s bf16 bound; each
side rounds at other places); gradients 1e-5.  Training: JAX interpret
mode has no PRNG lowering, so the training call's w, entropy and out are
held to JAX's (the mask never touches them, quirk Q1) and its mask chain
to the JAX ``curriculum_mask`` fed the port's own Philox draw (1e-6).

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it to
the plain version.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aecf_tpu.core.attention import AttentionPoolParams as JaxParams
from aecf_tpu.core.masking import curriculum_mask as jax_curriculum_mask
from aecf_tpu.kernels import fused_fusion_pool as jax_fused
from aecf_tpu_torch.core import AttentionPoolParams
from aecf_tpu_torch.kernels import (
    fused_fusion_pool,
    fused_pool_fwd,
    fused_pool_fwd_plain,
)
from aecf_tpu_torch.kernels.draws import draw_seed_words, mask_uniforms
from aecf_tpu_torch.kernels.fused_pool import _kernel_takes
from aecf_tpu_torch.ops import _wants_kernel, fusion_pool

ATOL = 1e-5
ATOL_BF16 = 5e-2
POOL = ("in_proj_weight", "out_proj_weight", "in_proj_bias", "out_proj_bias")


def _arrays(rng, E, bias=True):
    arrs = {
        "in_proj_weight": rng.uniform(-0.3, 0.3, (3 * E, E)),
        "out_proj_weight": rng.uniform(-0.3, 0.3, (E, E)),
    }
    if bias:
        arrs["in_proj_bias"] = 0.1 * rng.standard_normal(3 * E)
        arrs["out_proj_bias"] = 0.1 * rng.standard_normal(E)
    return {k: v.astype(np.float32) for k, v in arrs.items()}


def _inputs(seed, B, M, E, padded=False, bias=True):
    rng = np.random.default_rng(seed)
    arrs = _arrays(rng, E, bias)
    q = rng.standard_normal((B, 1, E)).astype(np.float32)
    kv = rng.standard_normal((B, M, E)).astype(np.float32)
    kpm = None
    if padded:
        kpm = rng.random((B, M)) < 0.3
        kpm[:, 0] = False
        kpm[0, -1] = True  # at least one padded slot
    return arrs, q, kv, kpm


def _jax_params(arrs):
    return JaxParams(**{k: jnp.asarray(v) for k, v in arrs.items()})


def _torch_params(arrs):
    return AttentionPoolParams(**{k: torch.from_numpy(v) for k, v in arrs.items()})


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# (E, M, B, H, padded): every value of each axis at least once
EVAL_CASES = [
    (16, 2, 1, 1, False),
    (16, 3, 7, 2, True),
    (16, 5, 33, 1, True),
    (64, 2, 33, 2, False),
    (64, 3, 1, 1, True),
    (64, 5, 7, 2, False),
    (64, 3, 33, 2, True),
    (16, 2, 7, 1, False),
]


@pytest.mark.parametrize("E,M,B,H,padded", EVAL_CASES)
def test_eval_matches_jax_interpret(E, M, B, H, padded):
    arrs, q, kv, kpm = _inputs(1000 * E + 100 * M + B + 7 * H, B, M, E, padded)
    j_out, j_w, j_mw, j_info = jax_fused(
        _jax_params(arrs), jnp.asarray(q), jnp.asarray(kv), num_heads=H,
        training=False, key_padding_mask=_j(kpm), interpret=True,
    )
    tp = _torch_params(arrs)
    with torch.no_grad():
        out, w, mw, info = fused_fusion_pool(
            tp, _t(q), _t(kv), num_heads=H, key_padding_mask=_t(kpm)
        )
        via_ops = fusion_pool(tp, _t(q), _t(kv), num_heads=H,
                              key_padding_mask=_t(kpm),
                              implementation="kernel")
    assert tuple(out.shape) == (B, 1, E) and tuple(w.shape) == (B, 1, M)
    np.testing.assert_allclose(out.numpy(), j_out, atol=ATOL)
    np.testing.assert_allclose(w.numpy(), j_w, atol=ATOL)
    np.testing.assert_array_equal(mw.numpy(), w.numpy())
    assert set(info) == set(j_info) == {"entropy", "mask_rate"}
    np.testing.assert_allclose(info["entropy"].numpy(), j_info["entropy"],
                               atol=ATOL)
    assert (info["mask_rate"] == 0).all()
    if padded:
        assert float(w[torch.from_numpy(kpm)[:, None, :]].abs().max()) == 0.0
    # a batch-1 query takes the shared-query kernel there, as in JAX
    for a, b in zip(via_ops[:3], (out, w, mw)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)


# Widths that are not multiples of the forward GEMMs' tiles (128 rows, 64
# or 128 columns, k-depth 16), with a distinct query row per sample and
# with the README's expanded query (row stride 0: the kernel projects one
# row), at one and two heads.
@pytest.mark.parametrize("query", ["expanded", "distinct"])
@pytest.mark.parametrize("E,H", [(40, 1), (40, 2), (72, 1), (72, 2)])
def test_ragged_widths_match_jax(E, H, query):
    B, M = 130, 3
    arrs, q, kv, kpm = _inputs(90 + E + H, B, M, E, padded=True)
    if query == "expanded":
        q = np.repeat(q[:1], B, axis=0)
    j_out, j_w, _, j_info = jax_fused(
        _jax_params(arrs), jnp.asarray(q), jnp.asarray(kv), num_heads=H,
        training=False, key_padding_mask=_j(kpm), interpret=True,
    )
    tq = _t(q[:1]).expand(B, 1, E) if query == "expanded" else _t(q)
    assert (tq.stride(0) == 0) == (query == "expanded")
    with torch.no_grad():
        out, w, mw, info = fused_fusion_pool(
            _torch_params(arrs), tq, _t(kv), num_heads=H,
            key_padding_mask=_t(kpm),
        )
    np.testing.assert_allclose(out.numpy(), j_out, atol=ATOL)
    np.testing.assert_allclose(w.numpy(), j_w, atol=ATOL)
    np.testing.assert_array_equal(mw.numpy(), w.numpy())
    np.testing.assert_allclose(info["entropy"].numpy(), j_info["entropy"],
                               atol=ATOL)


@pytest.mark.parametrize("E,M,B,H", [(64, 3, 7, 1), (16, 5, 33, 2)])
def test_bf16_query_and_features_match_jax(E, M, B, H):
    arrs, q, kv, _ = _inputs(5 + H, B, M, E)
    j_out, j_w, _, j_info = jax_fused(
        _jax_params(arrs), jnp.asarray(q, jnp.bfloat16),
        jnp.asarray(kv, jnp.bfloat16), num_heads=H, interpret=True,
    )
    with torch.no_grad():
        out, w, _, info = fused_fusion_pool(
            _torch_params(arrs), _t(q).bfloat16(), _t(kv).bfloat16(),
            num_heads=H,
        )
    assert out.dtype == torch.float32 and w.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out, np.float32),
                               atol=ATOL_BF16)
    np.testing.assert_allclose(w.numpy(), np.asarray(j_w), atol=ATOL_BF16)
    np.testing.assert_allclose(info["entropy"].numpy(),
                               np.asarray(j_info["entropy"]), atol=ATOL_BF16)


LOSSES = {
    # the output and the head-averaged weights (the d_w path)
    "out+weights": lambda out, w, info: (out * out).mean()
    + (w[:, 0, 0] * w[:, 0, 1]).sum(),
    # the eval entropy (test_kernels_interpret.py's generic entropy loss)
    "entropy": lambda out, w, info: (info["entropy"] ** 2).mean(),
}


@pytest.mark.parametrize("H", [1, 2])
@pytest.mark.parametrize("loss", sorted(LOSSES))
def test_grads_match_jax(loss, H):
    B, M, E = 9, 3, 16
    arrs, q, kv, kpm = _inputs(20 + H, B, M, E, padded=loss == "entropy")

    def jax_loss(p, qq, feats):
        out, w, _, info = jax_fused(
            p, qq, feats, num_heads=H, training=False,
            key_padding_mask=_j(kpm), interpret=True,
        )
        return LOSSES[loss](out, w, info)

    loss_j, (dp_j, dq_j, dkv_j) = jax.value_and_grad(jax_loss, (0, 1, 2))(
        _jax_params(arrs), jnp.asarray(q), jnp.asarray(kv)
    )
    tp = _torch_params(arrs)
    tq = _t(q).requires_grad_()
    tkv = _t(kv).requires_grad_()
    out, w, _, info = fused_fusion_pool(tp, tq, tkv, num_heads=H,
                                        key_padding_mask=_t(kpm))
    loss_t = LOSSES[loss](out, w, info)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.detach().numpy(), float(loss_j), rtol=1e-6)
    for k in POOL:
        np.testing.assert_allclose(getattr(tp, k).grad.numpy(),
                                   np.asarray(getattr(dp_j, k)), atol=ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(dq_j), atol=ATOL)
    np.testing.assert_allclose(tkv.grad.numpy(), np.asarray(dkv_j), atol=ATOL)
    assert float(tkv.grad.abs().max()) > 0


def test_grads_without_biases_and_through_an_expanded_query():
    """A bias-free pool gets gradients for its two weights only; an
    expanded ``(1, 1, E)`` query (stride 0, the Quick start idiom) runs the
    per-row path and sums its gradient over the batch."""
    B, M, E = 6, 2, 16
    arrs, q, kv, _ = _inputs(30, B, M, E, bias=False)
    tp = _torch_params(arrs)
    base = _t(q[:1]).requires_grad_()
    expanded = base.expand(B, 1, E)
    assert expanded.stride(0) == 0
    out, _, _, _ = fused_fusion_pool(tp, expanded, _t(kv))
    (out * out).mean().backward()
    assert tp.in_proj_bias is None and tp.in_proj_weight.grad is not None

    # the same rows, dense, and features that want a gradient this time
    dense = _t(np.repeat(q[:1], B, axis=0)).requires_grad_()
    tp2 = _torch_params(arrs)
    tkv = _t(kv).requires_grad_()
    out2, _, _, _ = fused_fusion_pool(tp2, dense, tkv)
    (out2 * out2).mean().backward()
    torch.testing.assert_close(out, out2, rtol=0, atol=0)
    torch.testing.assert_close(base.grad, dense.grad.sum(0, keepdim=True))
    torch.testing.assert_close(tp.in_proj_weight.grad, tp2.in_proj_weight.grad)
    assert tkv.grad is not None and float(tkv.grad.abs().max()) > 0


@pytest.mark.parametrize("min_active", [1, 2])
def test_training_matches_jax_under_mask_injection(min_active):
    """w, entropy and out of a training call equal JAX's; the mask chain
    equals the JAX curriculum mask fed the port's own Philox draw.  Padded
    slots and mask_prob 1 make the min_active replacement common."""
    B, M, E, H = 40, 3, 16, 2
    arrs, q, kv, kpm = _inputs(40 + min_active, B, M, E, padded=True)
    j_out, j_w, _, j_info = jax_fused(
        _jax_params(arrs), jnp.asarray(q), jnp.asarray(kv), num_heads=H,
        training=False, key_padding_mask=_j(kpm), interpret=True,
    )
    seed = draw_seed_words(torch.Generator().manual_seed(min_active))
    with torch.no_grad():
        out, w, mw, info = fused_fusion_pool(
            _torch_params(arrs), _t(q), _t(kv), num_heads=H, training=True,
            generator=torch.Generator().manual_seed(min_active),
            base_mask_prob=1.0, min_active=min_active, entropy_target=0.6,
            key_padding_mask=_t(kpm),
        )
    np.testing.assert_allclose(out.numpy(), j_out, atol=ATOL)
    np.testing.assert_allclose(w.numpy(), j_w, atol=ATOL)
    np.testing.assert_allclose(info["entropy"].numpy(), j_info["entropy"],
                               atol=ATOL)
    assert set(info) == {"entropy", "mask_rate", "target_entropy"}
    np.testing.assert_allclose(info["target_entropy"].numpy(),
                               math.log(M) * 0.6, rtol=1e-6)
    ent = info["entropy"][:, 0]
    keep = (1.0 - (ent / math.log(M)).clamp(0.0, 1.0)).clamp(0.0, 1.0)
    drawn = (mask_uniforms(seed, B, M) < keep[:, None]).float()
    assert float(drawn.sum(-1).lt(min_active).float().mean()) > 0.05
    mw_j, info_j = jax_curriculum_mask(
        jnp.asarray(w.numpy()), training=True, base_mask_prob=1.0,
        min_active=min_active, mask_override=jnp.asarray(drawn.numpy()[:, None]),
    )
    np.testing.assert_allclose(mw.numpy(), np.asarray(mw_j), atol=1e-6)
    np.testing.assert_allclose(info["mask_rate"].numpy(),
                               np.asarray(info_j["mask_rate"]), atol=1e-6)


def test_info_contract_and_detached_masking_outputs():
    """Training info is detached (quirk Q2) and the masking outputs carry
    no gradient; eval entropy does; M == 1 training needs no generator
    and gives zeros."""
    arrs, q, kv, _ = _inputs(50, 5, 3, 16)
    tp = _torch_params(arrs)
    g = torch.Generator().manual_seed(0)
    out, w, mw, info = fused_fusion_pool(tp, _t(q), _t(kv), training=True,
                                         generator=g)
    assert out.requires_grad and w.requires_grad and not mw.requires_grad
    assert not any(v.requires_grad for v in info.values())
    _, _, _, info = fused_fusion_pool(tp, _t(q), _t(kv))
    assert info["entropy"].requires_grad
    _, _, _, info = fused_fusion_pool(tp, _t(q), _t(kv[:, :1]), training=True)
    assert set(info) == {"entropy", "mask_rate", "target_entropy"}
    assert all(float(v.abs().max()) == 0 for v in info.values())
    with pytest.raises(ValueError, match="generator"):
        fused_fusion_pool(tp, _t(q), _t(kv), training=True)


@pytest.mark.parametrize(
    "kwargs,exc,match",
    [
        ({"H": 4, "E": 24}, ValueError, "ROADMAP"),  # E % 4H != 0
        ({"M": 9}, ValueError, "ROADMAP"),
        ({"E": 18}, ValueError, "multiple of 4"),
        ({"E": 2048}, ValueError, "E <= 1024"),
        ({"dtype": torch.float16}, TypeError, "float32 or bfloat16"),
        ({"T": 2}, ValueError, "tgt_len"),
        ({"implementation": "pallas"}, ValueError, "implementation"),
    ],
)
def test_rejects_what_the_kernel_does_not_take(kwargs, exc, match):
    E = kwargs.get("E", 16)
    B, M = 3, kwargs.get("M", 2)
    tp = AttentionPoolParams(torch.zeros(3 * E, E), torch.zeros(E, E))
    q = torch.zeros(B, kwargs.get("T", 1), E)
    kv = torch.zeros(B, M, E, dtype=kwargs.get("dtype", torch.float32))
    with pytest.raises(exc, match=match):
        fused_fusion_pool(tp, q, kv, num_heads=kwargs.get("H", 1),
                          implementation=kwargs.get("implementation", "kernel"))


def test_kernel_wrapper_raises_on_cpu_tensors_and_never_launches():
    arrs, q, kv, _ = _inputs(60, 4, 2, 16)
    args = (_t(q[:, 0]), _t(kv), None, _t(arrs["in_proj_weight"]),
            _t(arrs["in_proj_bias"]), _t(arrs["out_proj_weight"]),
            _t(arrs["out_proj_bias"]))
    before = fused_pool_fwd.launches
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        fused_pool_fwd(*args, num_heads=1)
    got = fused_fusion_pool(_torch_params(arrs), _t(q), _t(kv))
    want = fused_pool_fwd_plain(*args, num_heads=1)
    assert torch.equal(got[0][:, 0], want[0]) and torch.equal(got[1][:, 0], want[1])
    assert fused_pool_fwd.launches == before  # the CPU never launches


def test_plain_version_matches_the_torch_oracle():
    """The kernel's plain version equals the naive attention pool (the
    ops torch path), H = 2, padded slots included."""
    arrs, q, kv, kpm = _inputs(70, 9, 4, 16, padded=True)
    tp = _torch_params(arrs)
    args = (tp, _t(q), _t(kv))
    with torch.no_grad():
        k = fusion_pool(*args, num_heads=2, key_padding_mask=_t(kpm),
                        implementation="kernel")
        o = fusion_pool(*args, num_heads=2, key_padding_mask=_t(kpm),
                        implementation="torch")
    for a, b in zip(k[:3], o[:3]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)
    np.testing.assert_allclose(k[3]["entropy"].numpy(), o[3]["entropy"].numpy(),
                               atol=ATOL)


def test_auto_gate_for_per_row_queries():
    """``'auto'`` takes the torch path for CPU tensors; the per-row
    kernel's widths: any H, 1 <= M <= 8, E <= 1024 a multiple of 4 H."""
    arrs, q, kv, _ = _inputs(80, 4, 3, 16)
    assert not _wants_kernel(_torch_params(arrs), _t(q), _t(kv), num_heads=1,
                             precision="highest")
    assert _kernel_takes(3, 512, 1) and _kernel_takes(8, 1024, 2)
    assert _kernel_takes(1, 16, 2)
    assert _kernel_takes(3, 512, 8) and _kernel_takes(2, 256, 4)
    for M, E, H in ((9, 512, 1), (3, 2048, 1), (3, 520, 4), (3, 1020, 2),
                    (3, 18, 1)):
        assert not _kernel_takes(M, E, H), (M, E, H)


def test_cuda_source_ships():
    import os

    from aecf_tpu_torch.kernels import _build

    assert (_build._CSRC / "fused_pool_fwd.cu").exists()
    lib = _build.library_path("fused_pool_fwd")
    assert lib.parent.parent == _build._BUILD_ROOT
    assert lib.name == "libfused_pool_fwd.so"
    assert os.path.basename(os.path.dirname(lib)) != "csrc"
