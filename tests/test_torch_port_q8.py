"""The port's int8 feature path against the JAX package's.

int8 features with per-(row, modality) f32 scales (``quantize_features``)
run through every shared-query kernel: the resident forward
(``_shared_kernel_q8``), the H = 1 backward, the streamed forward and
backwards and the one-pass step, each dequantizing ``float(q)·scale``.  On
the CPU the port runs the kernels' plain versions; the JAX reference runs
its Pallas kernels in interpret mode at ``precision="highest"`` with
``training=False``, as ``test_kernels_interpret.py`` and
``test_train_step_kernel.py`` do.  Same numpy inputs, made from a seed.

Tolerances: ``quantize_features`` bit for bit; weights and entropy 1e-5,
outputs 2e-5 of their largest entry (f32 sums in other orders);
gradients rtol 2e-4 / atol 2e-5, the JAX q8 tests' own; the one-pass step
loss rtol 1e-6, gradients atol 1e-5; the port's int8 plain path against
its f32 plain path on ``q.float()·s`` exactly.

The CUDA kernels themselves run only on the card, where ``chip_smoke.py``
holds each int8 instantiation to its plain version and to the f32 kernel.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aecf_tpu.core.attention import AttentionPoolParams as JaxParams
from aecf_tpu.kernels import fused_fusion_pool_shared as jax_shared
from aecf_tpu.kernels import fused_pool_head_train_step as jax_head_step
from aecf_tpu.kernels import fused_pool_train_step as jax_step
from aecf_tpu.kernels import quantize_features as jax_quantize
from aecf_tpu_torch.core import AttentionPoolParams
from aecf_tpu_torch.kernels import (
    fused_fusion_pool_shared,
    fused_pool_head_train_step,
    fused_pool_train_step,
    quantize_features,
    shared_query_bwd,
    shared_query_bwd_plain,
    shared_query_fwd,
    shared_query_fwd_plain,
    stream_bwd,
    stream_bwd_mh,
    stream_bwd_plain,
    stream_mix,
    stream_mix_plain,
    train_step,
    train_step_plain,
)
from aecf_tpu_torch.kernels import shared_query as sq
from aecf_tpu_torch.kernels.draws import draw_seed_words
from aecf_tpu_torch.ops import fusion_pool

POOL = ("in_proj_weight", "out_proj_weight", "in_proj_bias", "out_proj_bias")
W_TOL = 1e-5
OUT_REL = 2e-5


def _inputs(seed, B, M, E, padded=False, query_scale=1.0):
    """Pool parameters at the reference's init scales (biases nonzero), a
    query (unit scale: scores spread over a few units), f32 features and
    their int8 form; ``padded`` pads ~30% of the slots, never slot 0."""
    rng = np.random.default_rng(seed)
    bound = math.sqrt(6.0 / (4 * E))
    arrs = {
        "in_proj_weight": rng.uniform(-bound, bound, (3 * E, E)),
        "out_proj_weight": rng.uniform(-E ** -0.5, E ** -0.5, (E, E)),
        "in_proj_bias": 0.1 * rng.standard_normal(3 * E),
        "out_proj_bias": 0.1 * rng.standard_normal(E),
    }
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    q = (query_scale * rng.standard_normal((1, 1, E))).astype(np.float32)
    kv = rng.standard_normal((B, M, E)).astype(np.float32)
    kpm = None
    if padded:
        kpm = rng.random((B, M)) < 0.3
        kpm[:, 0] = False
    kq, scales = jax_quantize(jnp.asarray(kv))
    return arrs, q, np.array(kq), np.array(scales), kpm


def _jax_params(arrs):
    return JaxParams(**{k: jnp.asarray(v) for k, v in arrs.items()})


def _torch_params(arrs, grad=False):
    return AttentionPoolParams(**{
        k: torch.from_numpy(v).requires_grad_(grad) for k, v in arrs.items()
    })


def _mask(kpm, lib):
    return None if kpm is None else lib(kpm)


# ---- quantize_features -------------------------------------------------------


def test_quantize_features_equals_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    kv = rng.standard_normal((16, 3, 64)).astype(np.float32) * 3.0
    kv[2] = 0.0  # all-zero rows: scale 1, q 0
    kv[5, 1] = 0.0
    # scale 127 / 127 == 1: ties that round half to even on both sides
    kv[7, 0, :5] = [127.0, 0.5, -0.5, 2.5, -1.5]
    jq, js = jax_quantize(jnp.asarray(kv))
    tq, ts = quantize_features(torch.from_numpy(kv))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ts[2] == 1.0).all() and (tq[2] == 0).all()
    assert tq[7, 0, :5].tolist() == [127, 0, 0, 2, -2]


# ---- the public function against JAX's q8 path -------------------------------


@pytest.mark.parametrize("E,B,padded", [(64, 16, False), (64, 16, True),
                                        (2048, 8, False), (2048, 8, True)])
@pytest.mark.parametrize("H", [1, 2])
def test_eval_matches_jax_q8(H, E, B, padded):
    """Resident (E = 64) and streamed (E = 2048) eval forwards."""
    arrs, q, kq, s, kpm = _inputs(10 + H + E, B, 3, E, padded)
    if padded:
        kpm[0] = True  # a fully padded row: uniform on both kernel paths
    j_out, j_w, _, j_info = jax_shared(
        _jax_params(arrs), jnp.asarray(q), jnp.asarray(kq),
        kv_scales=jnp.asarray(s), num_heads=H, training=False,
        interpret=True, precision="highest",
        key_padding_mask=_mask(kpm, jnp.asarray),
    )
    with torch.no_grad():
        out, w, mw, info = fused_fusion_pool_shared(
            _torch_params(arrs), torch.from_numpy(q), torch.from_numpy(kq),
            kv_scales=torch.from_numpy(s), num_heads=H, precision="highest",
            key_padding_mask=_mask(kpm, torch.from_numpy),
        )
    assert tuple(out.shape) == (B, 1, E) and tuple(w.shape) == (B, 1, 3)
    j_out = np.asarray(j_out)
    np.testing.assert_allclose(out.numpy(), j_out,
                               atol=OUT_REL * np.abs(j_out).max())
    np.testing.assert_allclose(w.numpy(), j_w, atol=W_TOL)
    np.testing.assert_allclose(info["entropy"].numpy(), j_info["entropy"],
                               atol=W_TOL)
    np.testing.assert_array_equal(mw.numpy(), w.numpy())
    assert (info["mask_rate"] == 0).all()


def _loss(out, w, entropy, xp):
    return xp.sum(out ** 2) + xp.sum(w) + 0.1 * xp.sum(entropy)


def _grads_vs_jax(E, H, call):
    """Port and JAX gradients of ``Σout² + Σw + 0.1·Σentropy`` (eval) for
    the parameters and the query, as ``test_kernels_interpret.py``'s q8
    oracle test (with its query's init scale, N(0, 2/E)); ``call(params,
    query, kq, scales)`` is the port's."""
    B = 8 if E > 1024 else 16
    arrs, q, kq, s, _ = _inputs(20 + H + E, B, 3, E,
                                query_scale=math.sqrt(2.0 / E))

    def jax_loss(p, qq):
        o, w, _, info = jax_shared(
            p, qq, jnp.asarray(kq), kv_scales=jnp.asarray(s), num_heads=H,
            training=False, interpret=True, precision="highest",
        )
        return _loss(o, w, info["entropy"], jnp)

    gp, gq = jax.grad(jax_loss, (0, 1))(_jax_params(arrs), jnp.asarray(q))
    tp = _torch_params(arrs, grad=True)
    tq = torch.from_numpy(q).requires_grad_()
    tkv = torch.from_numpy(kq)
    o, w, _, info = call(tp, tq, tkv, torch.from_numpy(s))
    _loss(o, w, info["entropy"], torch).backward()
    assert tkv.grad is None  # int8 features are frozen
    for k in POOL:
        np.testing.assert_allclose(getattr(tp, k).grad.numpy(),
                                   np.asarray(getattr(gp, k)), rtol=2e-4,
                                   atol=2e-5, err_msg=k)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(gq), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("E,H", [(64, 1), (64, 2), (2048, 1), (2048, 2)])
def test_grads_match_jax_q8(E, H):
    """Resident H = 1 (the int8 backward kernel), resident H = 2 (torch on
    the dequantized features), streamed H = 1 and H = 2 (the int8 streamed
    backward kernels)."""
    _grads_vs_jax(E, H, lambda p, q, kv, s: fused_fusion_pool_shared(
        p, q, kv, kv_scales=s, num_heads=H, precision="highest"))


def test_grads_h4_through_the_torch_path_match_jax_q8():
    """H = 4: ``ops.fusion_pool``'s 'auto' takes the torch path, which
    dequantizes; JAX runs its resident q8 kernel and an XLA backward."""
    _grads_vs_jax(64, 4, lambda p, q, kv, s: fusion_pool(
        p, q, kv, kv_scales=s, num_heads=4, precision="highest"))


# ---- the one-pass step -------------------------------------------------------


@pytest.mark.parametrize("head", [False, True])
def test_step_matches_jax_q8(head):
    B, M, E, C = 100, 3, 64, 6
    arrs, q, kq, s, _ = _inputs(30 + head, B, M, E)
    rng = np.random.default_rng(31)
    hw = rng.uniform(-0.1, 0.1, (E, C)).astype(np.float32)
    hb = rng.uniform(-0.1, 0.1, C).astype(np.float32)
    labels = (rng.random((B, C)) < 0.3).astype(np.float32)
    jkw = dict(kv_scales=jnp.asarray(s), rng=None, training=False,
               precision="highest", interpret=True)
    tkw = dict(kv_scales=torch.from_numpy(s), training=False,
               precision="highest")
    jargs = (_jax_params(arrs), jnp.asarray(q))
    targs = (_torch_params(arrs), torch.from_numpy(q))
    if head:
        loss_j, g_j, dkv_j, info_j = jax_head_step(
            *jargs, {"w": jnp.asarray(hw), "b": jnp.asarray(hb)},
            jnp.asarray(kq), jnp.asarray(labels), **jkw)
        loss_t, g_t, dkv_t, info_t = fused_pool_head_train_step(
            *targs, {"w": torch.from_numpy(hw), "b": torch.from_numpy(hb)},
            torch.from_numpy(kq), torch.from_numpy(labels), **tkw)
        for k in ("w", "b"):
            np.testing.assert_allclose(g_t["head"][k].numpy(),
                                       np.asarray(g_j["head"][k]), atol=1e-5)
        dp_j, dq_j, dp_t, dq_t = g_j["pool"], g_j["query"], g_t["pool"], g_t["query"]
    else:
        loss_j, dp_j, dq_j, dkv_j, info_j = jax_step(*jargs, jnp.asarray(kq),
                                                     **jkw)
        loss_t, dp_t, dq_t, dkv_t, info_t = fused_pool_train_step(
            *targs, torch.from_numpy(kq), **tkw)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    for k in POOL:
        np.testing.assert_allclose(dp_t[k].numpy(), np.asarray(getattr(dp_j, k)),
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(dq_t.numpy(), np.asarray(dq_j), atol=1e-5)
    assert dkv_t is None and dkv_j is None
    assert set(info_t) == set(info_j)


# ---- the plain versions: int8 == f32 on the dequantized features -------------


def _plain_cases():
    B, M, E = 24, 4, 64
    rng = np.random.default_rng(40)
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    kq, s = quantize_features(t(rng.standard_normal((B, M, E))))
    x = kq.float() * s[..., None]
    pad = sq._pad_bias_rows(torch.from_numpy(rng.random((B, M)) < 0.3))
    pad[:, 0] = 0.0
    seed = draw_seed_words(torch.Generator().manual_seed(4))
    mask = dict(training=True, seed=seed, mask_prob=0.9, min_active=2)
    u2, c2 = t(0.3 * rng.standard_normal((2, E))), t(rng.standard_normal(2))
    u1, c1 = u2[:1].contiguous(), c2[:1].contiguous()
    wvo, bctx = t(rng.standard_normal((E, E)) / 8), t(rng.standard_normal(E))
    wo, bo = t(rng.standard_normal((E, E)) / 8), t(rng.standard_normal(E))
    d_out, d_w = t(rng.standard_normal((B, E))), t(rng.standard_normal((B, M)))
    d_mix = t(rng.standard_normal((B, 2 * E)))
    hw, hb = t(rng.standard_normal((E, 5)) / 8), t(rng.standard_normal(5))
    labels = t((rng.random((B, 5)) < 0.3).astype(np.float32))
    return {
        "stream_mix": lambda kv, **k: stream_mix_plain(kv, u2, c2, pad, **mask, **k),
        "shared_query_fwd_h1": lambda kv, **k: shared_query_fwd_plain(
            kv, u1, c1, pad, wvo, bctx, None, None, **mask, **k),
        "shared_query_fwd_h2": lambda kv, **k: shared_query_fwd_plain(
            kv, u2, c2, pad, wvo, bctx, wo, bo, **mask, **k),
        "stream_bwd": lambda kv, **k: stream_bwd_plain(
            kv, d_mix, d_w, pad, u2, c2, want_dkv=False, **k),
        "shared_query_bwd": lambda kv, **k: shared_query_bwd_plain(
            kv, u1[0], c1, pad, d_out, d_w, wvo, want_dkv=False, **k),
        "train_step": lambda kv, **k: train_step_plain(
            kv, u1[0], c1, pad, wvo, bctx, inv=0.01, want_dkv=False,
            head_w=hw, head_b=hb, labels=labels, **mask, **k),
    }, kq, s, x


@pytest.mark.parametrize("name", ["stream_mix", "shared_query_fwd_h1",
                                  "shared_query_fwd_h2", "stream_bwd",
                                  "shared_query_bwd", "train_step"])
def test_int8_plain_equals_f32_plain_on_dequantized(name):
    """The one dequant rule (``_dequant``): every plain version on
    ``(q, s)`` equals itself on ``q.float()·s`` exactly — masks from the
    same seed words included."""
    cases, kq, s, x = _plain_cases()
    got = cases[name](kq, kv_scales=s)
    want = cases[name](x)
    if isinstance(got, dict):
        assert set(got) == set(want)
        got, want = [got[k] for k in sorted(got)], [want[k] for k in sorted(want)]
    for a, b in zip(got, want):
        if a is None:
            assert b is None
            continue
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    if name == "stream_mix":
        assert 0 < float(got[4].mean()) < 1  # the mask was drawn


def test_ops_per_row_query_dequantizes_and_detaches():
    """A per-row query has no int8 kernel: 'kernel' runs the per-row path
    on the dequantized, detached features, as JAX does."""
    arrs, q, kq, s, _ = _inputs(50, 6, 3, 64)
    tp = _torch_params(arrs)
    qb = torch.from_numpy(np.repeat(q, 6, axis=0))
    x = torch.from_numpy(kq).float() * torch.from_numpy(s)[..., None]
    with torch.no_grad():
        got = fusion_pool(tp, qb, torch.from_numpy(kq),
                          kv_scales=torch.from_numpy(s), implementation="kernel")
        want = fusion_pool(tp, qb, x, implementation="kernel")
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


ROUTES = [
    # (E, H, grad, training) -> kernel wrappers called, as the f32 path
    (1028, 1, True, False, ["stream_mix", "stream_bwd"]),
    (1028, 2, False, False, ["stream_mix"]),
    (512, 2, True, False, ["stream_mix", "stream_bwd_mh"]),
    (512, 2, False, False, ["shared_query_fwd"]),
    (512, 1, True, True, ["shared_query_fwd", "shared_query_bwd"]),
    (256, 2, True, False, ["shared_query_fwd"]),  # torch backward
]


@pytest.mark.parametrize("E,H,grad,training,want", ROUTES)
def test_q8_routes_follow_the_f32_routes(monkeypatch, E, H, grad, training,
                                         want):
    called = []

    def spy(name):
        fn = getattr(sq, name)

        def wrapper(*args, **kwargs):
            assert kwargs.get("kv_scales") is not None
            called.append(name)
            return fn(*args, **kwargs)

        return wrapper

    for name in ("stream_mix", "stream_bwd", "stream_bwd_mh",
                 "shared_query_fwd", "shared_query_bwd"):
        monkeypatch.setattr(sq, name, spy(name))
    arrs, q, kq, s, _ = _inputs(60, 4, 2, E)
    tp = _torch_params(arrs, grad=grad)
    with torch.set_grad_enabled(grad):
        out, _, _, _ = fused_fusion_pool_shared(
            tp, torch.from_numpy(q), torch.from_numpy(kq),
            kv_scales=torch.from_numpy(s), num_heads=H, training=training,
            generator=torch.Generator().manual_seed(0),
        )
        if grad:
            out.square().mean().backward()
    assert called == want


# ---- validation ---------------------------------------------------------------


def _misuse_cases():
    B, M, E = 4, 3, 64
    arrs, q, kq, s, _ = _inputs(70, B, M, E)
    tp, tq = _torch_params(arrs), torch.from_numpy(q)
    kq, s = torch.from_numpy(kq), torch.from_numpy(s)
    x = kq.float()
    u, c = torch.zeros(1, E), torch.zeros(1)
    return {
        "shared/no scales": (lambda: fused_fusion_pool_shared(tp, tq, kq),
                             "requires kv_scales"),
        "shared/float with scales": (
            lambda: fused_fusion_pool_shared(tp, tq, x, kv_scales=s),
            "kv_scales passed"),
        "shared/scales shape": (
            lambda: fused_fusion_pool_shared(tp, tq, kq, kv_scales=s[:, :2]),
            "kv_scales must be float32"),
        "step/no scales": (lambda: fused_pool_train_step(tp, tq, kq,
                                                         training=False),
                           "requires kv_scales"),
        "step/kv_grad": (lambda: fused_pool_train_step(
            tp, tq, kq, kv_scales=s, training=False, kv_grad=True), "frozen"),
        "step/float with scales": (lambda: fused_pool_train_step(
            tp, tq, x, kv_scales=s, training=False), "kv_scales passed"),
        "ops/no scales": (lambda: fusion_pool(tp, tq, kq), "requires kv_scales"),
        "ops/float with scales": (lambda: fusion_pool(tp, tq, x, kv_scales=s),
                                  "kv_scales passed"),
        "stream_mix/no scales": (lambda: stream_mix(kq, u, c, None),
                                 "requires kv_scales"),
        "stream_bwd/d_kv": (lambda: stream_bwd(
            kq, torch.zeros(B, E), None, None, u, c, want_dkv=True,
            kv_scales=s), "frozen"),
        "shared_query_bwd/d_kv": (lambda: shared_query_bwd(
            kq, u[0], c, None, torch.zeros(B, E), None, torch.zeros(E, E),
            want_dkv=True, kv_scales=s), "frozen"),
        "train_step/d_kv": (lambda: train_step(
            kq, u[0], c, None, torch.zeros(E, E), torch.zeros(E), inv=1.0,
            want_dkv=True, kv_scales=s), "frozen"),
    }


@pytest.mark.parametrize("case", list(_misuse_cases()))
def test_misuse_raises_as_in_jax(case):
    call, match = _misuse_cases()[case]
    with pytest.raises(ValueError, match=match):
        call()


def test_meta_tensors_launch_or_raise():
    """Off the CPU no int8 wrapper runs its plain version: a device with
    no kernel raises."""
    B, M, E = 4, 3, 64
    f = lambda *shape: torch.zeros(*shape, device="meta")  # noqa: E731
    kq = torch.zeros(B, M, E, dtype=torch.int8, device="meta")
    s = f(B, M)
    calls = [
        lambda: shared_query_fwd(kq, f(1, E), f(1), None, f(E, E), f(E),
                                 kv_scales=s),
        lambda: shared_query_bwd(kq, f(E), f(1), None, f(B, E), None,
                                 f(E, E), want_dkv=False, kv_scales=s),
        lambda: stream_mix(kq, f(1, E), f(1), None, kv_scales=s),
        lambda: stream_bwd(kq, f(B, E), None, None, f(1, E), f(1),
                           want_dkv=False, kv_scales=s),
        lambda: stream_bwd_mh(kq, f(B, 2 * E), None, None, f(2, E), f(2),
                              want_dkv=False, kv_scales=s),
        lambda: train_step(kq, f(E), f(1), None, f(E, E), f(E), inv=1.0,
                           want_dkv=False, kv_scales=s),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="no kernel for device meta"):
            call()


def test_cpu_runs_count_no_launch():
    cases, kq, s, _ = _plain_cases()
    before = [(w.launches, w.launches_q8) for w in (
        shared_query_fwd, shared_query_bwd, stream_mix, stream_bwd,
        stream_bwd_mh, train_step)]
    B, M, E = kq.shape
    u, c = torch.zeros(1, E), torch.zeros(1)
    stream_mix(kq, u, c, None, kv_scales=s)
    stream_bwd(kq, torch.zeros(B, E), None, None, u, c, want_dkv=False,
               kv_scales=s)
    after = [(w.launches, w.launches_q8) for w in (
        shared_query_fwd, shared_query_bwd, stream_mix, stream_bwd,
        stream_bwd_mh, train_step)]
    assert after == before


# ---- the head limits that remain --------------------------------------------


@pytest.mark.parametrize("q8", [False, True])
def test_h_above_2_names_its_roadmap_item(q8):
    """The resident kernels take any H dividing E up to E = 1024; what
    still raises, on any device and for int8 features too: H > 2 above the
    resident cap (only the streamed split, H <= 2, runs there — JAX's rule)
    and H not dividing E."""
    B, M, E = 2, 3, 1152
    rng = np.random.default_rng(80)
    x = torch.from_numpy(rng.standard_normal((B, M, E)).astype(np.float32))
    kv, scales = quantize_features(x) if q8 else (x, None)
    params = AttentionPoolParams(torch.zeros(3 * E, E), torch.zeros(E, E))
    with pytest.raises(ValueError, match="needs num_heads<=2"):
        fused_fusion_pool_shared(params, torch.zeros(1, 1, E), kv,
                                 kv_scales=scales, num_heads=4)
    E = 64
    kv, scales = kv[..., :E].contiguous(), scales
    with pytest.raises(ValueError, match="H dividing E"):
        shared_query_fwd(kv, torch.zeros(3, E), torch.zeros(3), None,
                         torch.zeros(E, E), torch.zeros(E),
                         torch.zeros(E, E), torch.zeros(E), kv_scales=scales)
