"""The port's two-pass training path and its draws against the JAX package.

* Gradients: ``torch.autograd`` through the port's
  ``fused_fusion_pool_shared`` (forward kernel + the H=1 backward kernel,
  their plain versions on the CPU) against ``jax.grad`` through the JAX
  function (Pallas interpret mode, ``precision="highest"``), for a loss on
  the output, on the attention weights (the ``d_w`` path) and on the eval
  entropy (``_fold_entropy_cotangent``); atol 1e-5.  Training gradients
  equal eval gradients exactly (quirk Q1).  At the widths the chains take
  beyond the GEMM tiles and E % 4 (E = 30, 36, 260; B = 130, 300; H in
  {1, 2, 3}) the same, for the three losses summed.
* The mask chain: the port's training forward against the JAX
  ``core.masking.curriculum_mask`` fed the port's own Bernoulli draw
  through ``mask_override``, 1e-6.
* Philox4x32-10: Random123's known answers, the keep rate over 10⁵ slots
  within 5σ, and draws that do not depend on how the batch is cut.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aecf_tpu.core.attention import AttentionPoolParams as JaxParams
from aecf_tpu.core.masking import curriculum_mask as jax_curriculum_mask
from aecf_tpu.kernels import fused_fusion_pool_shared as jax_shared
from aecf_tpu_torch.core import AttentionPoolParams
from aecf_tpu_torch.kernels import (
    fused_fusion_pool_shared,
    shared_query_bwd,
    shared_query_bwd_plain,
    shared_query_fwd_plain,
)
from aecf_tpu_torch.kernels.draws import (
    draw_seed_words,
    mask_and_renorm,
    mask_uniforms,
    philox4x32_10,
)
from aecf_tpu_torch.kernels.shared_query import _pad_bias_rows, _prep
from aecf_tpu_torch.ops import _wants_kernel, fusion_pool

E, M = 64, 3
POOL = ("in_proj_weight", "out_proj_weight", "in_proj_bias", "out_proj_bias")

LOSSES = {
    "out": lambda out, w, info: (out * out).mean(),
    "weights": lambda out, w, info: (w[:, 0, 0] * w[:, 0, 1]).sum(),
    "entropy": lambda out, w, info: (info["entropy"] ** 2).mean(),
}


def _inputs(seed, B=50, padded=False, E=E):
    rng = np.random.default_rng(seed)
    arrs = {
        "in_proj_weight": rng.uniform(-0.2, 0.2, (3 * E, E)),
        "out_proj_weight": rng.uniform(-0.2, 0.2, (E, E)),
        "in_proj_bias": 0.1 * rng.standard_normal(3 * E),
        "out_proj_bias": 0.1 * rng.standard_normal(E),
    }
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    q = (np.sqrt(2.0 / E) * rng.standard_normal((1, 1, E))).astype(np.float32)
    kv = rng.standard_normal((B, M, E)).astype(np.float32)
    kpm = None
    if padded:
        kpm = rng.random((B, M)) < 0.3
        kpm[:, 0] = False
    return arrs, q, kv, kpm


def _jax_grads(arrs, q, kv, kpm, loss_fn, num_heads):
    def jax_loss(p, qq, feats):
        out, w, mw, info = jax_shared(
            p, qq, feats, num_heads=num_heads, training=False, interpret=True,
            precision="highest",
            key_padding_mask=None if kpm is None else jnp.asarray(kpm),
        )
        return loss_fn(out, w, info)

    jp = JaxParams(**{k: jnp.asarray(v) for k, v in arrs.items()})
    return jax.value_and_grad(jax_loss, (0, 1, 2))(
        jp, jnp.asarray(q), jnp.asarray(kv)
    )


def _torch_grads(arrs, q, kv, kpm, loss_fn, num_heads, **kw):
    tp = AttentionPoolParams(**{k: torch.from_numpy(v) for k, v in arrs.items()})
    tq = torch.from_numpy(q).requires_grad_()
    tkv = torch.from_numpy(kv).requires_grad_()
    out, w, mw, info = fused_fusion_pool_shared(
        tp, tq, tkv, num_heads=num_heads, precision="highest",
        key_padding_mask=None if kpm is None else torch.from_numpy(kpm), **kw,
    )
    loss = loss_fn(out, w, info)
    loss.backward()
    grads = {k: getattr(tp, k).grad for k in POOL}
    return loss.detach(), grads, tq.grad, tkv.grad


@pytest.mark.parametrize("num_heads", [1, 2])
@pytest.mark.parametrize("loss", sorted(LOSSES))
def test_two_pass_grads_match_jax(loss, num_heads):
    arrs, q, kv, kpm = _inputs(7 + num_heads, padded=loss == "weights")
    loss_j, (dp_j, dq_j, dkv_j) = _jax_grads(arrs, q, kv, kpm, LOSSES[loss],
                                             num_heads)
    loss_t, dp_t, dq_t, dkv_t = _torch_grads(
        arrs, q, kv, kpm, LOSSES[loss], num_heads
    )
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    for k in POOL:
        np.testing.assert_allclose(dp_t[k].numpy(), np.asarray(getattr(dp_j, k)),
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(dq_t.numpy(), np.asarray(dq_j), atol=1e-5)
    np.testing.assert_allclose(dkv_t.numpy(), np.asarray(dkv_j), atol=1e-5)


def _all_losses(out, w, info):
    return sum(f(out, w, info) for f in LOSSES.values())


@pytest.mark.parametrize("E_,num_heads,B", [(30, 1, 300), (30, 2, 130),
                                             (30, 3, 130), (36, 1, 130),
                                             (260, 1, 130)])
def test_two_pass_grads_at_edge_widths_match_jax(E_, num_heads, B):
    """The backward at widths that are not multiples of the chains' GEMM
    tiles and not divisible by 4 (at H = 1 the backward kernel's plain
    version, which raised for E % 4 on the card before it took every width
    the forward takes), padded slots, every loss at once."""
    arrs, q, kv, kpm = _inputs(E_ + num_heads, B=B, padded=True, E=E_)
    loss_j, (dp_j, dq_j, dkv_j) = _jax_grads(arrs, q, kv, kpm, _all_losses,
                                             num_heads)
    loss_t, dp_t, dq_t, dkv_t = _torch_grads(arrs, q, kv, kpm, _all_losses,
                                             num_heads)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    pairs = [(dp_t[k], getattr(dp_j, k), k) for k in POOL]
    pairs += [(dq_t, dq_j, "query"), (dkv_t, dkv_j, "kv")]
    for got, want, name in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("num_heads", [1, 2])
def test_training_grads_equal_eval_grads(num_heads):
    """Quirk Q1: the mask never touches the output, so a training call's
    gradients are the eval call's, bit for bit."""
    arrs, q, kv, _ = _inputs(9)
    ev = _torch_grads(arrs, q, kv, None, LOSSES["out"], num_heads)
    tr = _torch_grads(arrs, q, kv, None, LOSSES["out"], num_heads,
                      training=True, base_mask_prob=0.9,
                      generator=torch.Generator().manual_seed(1))
    assert torch.equal(ev[0], tr[0])
    for k in POOL:
        assert torch.equal(ev[1][k], tr[1][k]), k
    assert torch.equal(ev[2], tr[2]) and torch.equal(ev[3], tr[3])


def test_kv_grad_false_skips_dkv():
    arrs, q, kv, _ = _inputs(10)
    tp = AttentionPoolParams(**{k: torch.from_numpy(v) for k, v in arrs.items()})
    tkv = torch.from_numpy(kv).requires_grad_()
    out, _, _, _ = fused_fusion_pool_shared(tp, torch.from_numpy(q), tkv,
                                            kv_grad=False)
    out.square().mean().backward()
    assert tkv.grad is None and tp.in_proj_weight.grad is not None


def test_backward_wrapper_is_its_plain_version_on_cpu():
    arrs, q, kv, kpm = _inputs(11, padded=True)
    tp = AttentionPoolParams(**{k: torch.from_numpy(v) for k, v in arrs.items()})
    u, c, wvo, _, _, _ = _prep(tp, torch.from_numpy(q)[0, 0], 1)
    rng = np.random.default_rng(0)
    args = (torch.from_numpy(kv), u[0].detach(), c.detach(),
            _pad_bias_rows(torch.from_numpy(kpm)),
            torch.from_numpy(rng.standard_normal((50, E)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((50, M)).astype(np.float32)),
            wvo.detach())
    before = shared_query_bwd.launches
    got = shared_query_bwd(*args, want_dkv=True)
    want = shared_query_bwd_plain(*args, want_dkv=True)
    assert shared_query_bwd.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[0].shape == (50, M, E) and got[1].shape == (E, E)


def _bwd_args(B=6, M=3, E_=30, dtype=torch.float32):
    g = torch.Generator().manual_seed(B + M + E_)
    kv = torch.randn(B, M, E_, generator=g).to(dtype)
    return (kv, torch.randn(E_, generator=g), torch.randn(1, generator=g),
            None, torch.randn(B, E_, generator=g), None,
            torch.randn(E_, E_, generator=g))


def test_backward_takes_every_width_the_forward_takes():
    """E = 30 (not divisible by 4): the wrapper accepts it as the forward
    does and returns its plain version's results."""
    args = _bwd_args()
    got = shared_query_bwd(*args, want_dkv=True)
    want = shared_query_bwd_plain(*args, want_dkv=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[0].shape == (6, 3, 30) and got[1].shape == (30, 30)


@pytest.mark.parametrize(
    "case,match",
    [
        ("no rows", "B >= 1"),
        ("M above 8", "M <= 8"),
        ("E above the cap", "E <= 1024"),
        ("f16 kv", "float32/bfloat16/int8"),
        ("d_out shape", "d_out must be float32"),
        ("u shape", "u must be float32"),
        ("f64 wvo", "wvo must be float32"),
        ("kv_scales on f32", "kv_scales passed"),
    ],
)
def test_backward_wrapper_limits_raise_before_dispatch(case, match):
    """What the backward still rejects, checked before the CPU dispatch,
    so the plain version never sees it (and a CUDA tensor never reaches
    the kernel with it)."""
    B, M, E_ = {"no rows": (0, 3, 30), "M above 8": (4, 9, 30),
                "E above the cap": (2, 2, 1028)}.get(case, (4, 3, 30))
    args = list(_bwd_args(B, M, E_))
    kw = {}
    if case == "f16 kv":
        args[0] = args[0].half()
    elif case == "d_out shape":
        args[4] = args[4][:, :-1]
    elif case == "u shape":
        args[1] = args[1][None]
    elif case == "f64 wvo":
        args[6] = args[6].double()
    elif case == "kv_scales on f32":
        kw["kv_scales"] = torch.ones(B, M)
    before = shared_query_bwd.launches
    with pytest.raises(ValueError, match=match):
        shared_query_bwd(*args, want_dkv=False, **kw)
    assert shared_query_bwd.launches == before


def test_auto_takes_the_kernel_gate_for_training_and_grads():
    """The gate no longer excludes training or autograd; on the CPU it is
    still the torch path."""
    arrs, q, kv, _ = _inputs(12)
    tp = AttentionPoolParams(**{k: torch.from_numpy(v) for k, v in arrs.items()})
    assert not _wants_kernel(tp, torch.from_numpy(q), torch.from_numpy(kv),
                             num_heads=1, precision="highest")
    out, _, _, info = fusion_pool(
        tp, torch.from_numpy(q), torch.from_numpy(kv), training=True,
        implementation="kernel", generator=torch.Generator().manual_seed(2),
    )
    assert set(info) == {"entropy", "mask_rate", "target_entropy"}
    assert info["mask_rate"].shape == (50, 1)


# ---- the mask chain -------------------------------------------------------


@pytest.mark.parametrize("min_active", [0, 1, 2])
def test_mask_chain_matches_jax_curriculum_mask(min_active):
    """The training forward's (mw, rate) equal the JAX curriculum mask fed
    the port's own Bernoulli draw.  Fully and partly padded rows give ties
    (uniform weights, zero weights) for min_active's first-occurrence
    order; mask_prob 1 makes the replacement frequent."""
    arrs, q, kv, _ = _inputs(13 + min_active, B=80)
    kpm = np.random.default_rng(1).random((80, M)) < 0.3
    kpm[::7] = True  # fully padded rows: uniform weights, all tied
    tp = AttentionPoolParams(**{k: torch.from_numpy(v) for k, v in arrs.items()})
    pre = _prep(tp, torch.from_numpy(q)[0, 0], 1)
    seed = draw_seed_words(torch.Generator().manual_seed(min_active))
    with torch.no_grad():
        _, w, mw, ent, rate = shared_query_fwd_plain(
            torch.from_numpy(kv), *pre[:2],
            _pad_bias_rows(torch.from_numpy(kpm)), *pre[2:], training=True,
            seed=seed, mask_prob=1.0, min_active=min_active,
        )
    keep = (1.0 - (ent / math.log(M)).clamp(0.0, 1.0)).clamp(0.0, 1.0)
    drawn = (mask_uniforms(seed, 80, M) < keep[:, None]).float()
    mw_j, info_j = jax_curriculum_mask(
        jnp.asarray(w.numpy()), training=True, base_mask_prob=1.0,
        min_active=min_active, mask_override=jnp.asarray(drawn.numpy()),
    )
    np.testing.assert_allclose(mw.numpy(), np.asarray(mw_j), atol=1e-6)
    np.testing.assert_allclose(rate.numpy(), np.asarray(info_j["mask_rate"]),
                               atol=1e-6)
    if min_active:
        assert float(drawn.sum(-1).lt(min_active).float().mean()) > 0.05


def test_min_active_ties_take_the_first_occurrence():
    w = torch.tensor([[0.25, 0.5, 0.25], [0.4, 0.2, 0.4], [1 / 3] * 3])
    ent = torch.full((3,), math.log(3))  # keep = 0 at mask_prob 1
    uni = torch.full((3, 3), 0.5)
    mw, rate, mask = mask_and_renorm(w, ent, uni, mask_prob=1.0, min_active=2)
    assert mask.tolist() == [[1, 1, 0], [1, 0, 1], [1, 1, 0]]
    torch.testing.assert_close(rate, torch.full((3,), 1 / 3))
    torch.testing.assert_close(mw[2], torch.tensor([0.5, 0.5, 0.0]))


# ---- Philox -----------------------------------------------------------------


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10, on Python ints
    and on int64 tensors."""
    ones = 0xFFFFFFFF
    want0 = (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)
    want1 = (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)
    assert philox4x32_10((0, 0, 0, 0), (0, 0)) == want0
    assert philox4x32_10((ones,) * 4, (ones, ones)) == want1
    t = torch.tensor([0, ones], dtype=torch.int64)
    got = philox4x32_10((t, t, t, t), (t, t))
    assert [tuple(int(x[i]) for x in got) for i in range(2)] == [want0, want1]


def test_keep_rate_distribution():
    """With min_active 0 the kept share over 10⁵ slots is the mean keep
    probability, within 5σ."""
    B, Mx = 25_000, 4
    g = torch.Generator().manual_seed(3)
    w = torch.softmax(torch.randn(B, Mx, generator=g) * 2, dim=-1)
    ent = -(w * w.log()).sum(-1)
    uni = mask_uniforms(draw_seed_words(g), B, Mx)
    _, rate, mask = mask_and_renorm(w, ent, uni, mask_prob=0.5, min_active=0)
    keep = (1.0 - 0.5 * (ent / math.log(Mx)).clamp(0, 1)).double()
    n = B * Mx
    sigma = math.sqrt(float((keep * (1 - keep)).sum()) * Mx) / n
    assert abs(float(mask.double().mean()) - float(keep.mean())) < 5 * sigma
    torch.testing.assert_close(rate, 1.0 - mask.mean(-1))
    assert 0.0 <= float(uni.min()) and float(uni.max()) < 1.0


def test_draws_do_not_depend_on_the_batch_cut():
    """The counter is the global row: a batch of 100 draws the first 100
    rows of a batch of 300, and M=3 the first three words of M=4 (or of
    the first Philox word group for M=8)."""
    seed = (123456789, 987654321)
    big = mask_uniforms(seed, 300, 8)
    assert torch.equal(mask_uniforms(seed, 100, 8), big[:100])
    assert torch.equal(mask_uniforms(seed, 300, 3), big[:, :3])
    assert torch.equal(mask_uniforms(seed, 300, 4), big[:, :4])
    assert not torch.equal(big[:, :4], big[:, 4:])
    assert not torch.equal(mask_uniforms((1, 2), 10, 3),
                           mask_uniforms((1, 3), 10, 3))
