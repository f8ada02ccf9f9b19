"""The port's streamed split against the JAX package's.

The streamed split takes the shared-query pools with H ≤ 2 above the
resident cap (1024 < E ≤ 8192), and H == 2 training and gradients from
E = 512.  On the CPU the port's ``fused_fusion_pool_shared`` runs the plain
versions of its streamed kernels (``stream_mix``, ``stream_bwd``,
``stream_bwd_mh``); the JAX reference runs its streamed Pallas kernels
(``_mix_kernel``, ``_bwd_kernel_streamed``, ``_bwd_kernel_streamed_mh``) in
interpret mode at ``precision="highest"``, as ``test_kernels_interpret.py``
does.  Same numpy inputs, made from a seed.

Tolerances, all f32 sums of up to E = 2048 terms taken in other orders:
weights and entropy 1e-6, outputs 1e-5, gradients 1e-5 of their largest
entry (``rel_close``), the slice's losses and parameters 2e-5 as
``test_torch_port_pool_step.py``; masks from the same seed words are
equal bit for bit.

The CUDA kernels themselves run only on the card, where ``chip_smoke.py``
holds them to these plain versions.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aecf_tpu.core.attention import AttentionPoolParams as JaxParams
from aecf_tpu.kernels import fused_fusion_pool_shared as jax_shared
from aecf_tpu.kernels import shared_query as jax_sq
from aecf_tpu.train import TrainState as JaxState
from aecf_tpu.train import make_pool_train_step as jax_make
from aecf_tpu_torch.convert import (
    pool_classifier_params_from_numpy,
    pool_classifier_params_to_numpy,
)
from aecf_tpu_torch.core import AttentionPoolParams, attention_pool_core
from aecf_tpu_torch.core.masking import curriculum_mask
from aecf_tpu_torch.kernels import (
    fused_fusion_pool_shared,
    shared_query_fwd,
    stream_bwd,
    stream_bwd_mh,
    stream_bwd_plain,
    stream_mix,
    stream_mix_plain,
)
from aecf_tpu_torch.kernels import shared_query as sq
from aecf_tpu_torch.kernels.draws import draw_seed_words, mask_uniforms
from aecf_tpu_torch.train import TrainState, make_pool_train_step, param_leaves

POOL = ("in_proj_weight", "out_proj_weight", "in_proj_bias", "out_proj_bias")
W_TOL = 1e-6
OUT_TOL = 1e-5
GRAD_REL = 1e-5


def _arrays(rng, E):
    """Pool parameters at the reference's init scales, biases nonzero."""
    bound = math.sqrt(6.0 / (4 * E))
    arrs = {
        "in_proj_weight": rng.uniform(-bound, bound, (3 * E, E)),
        "out_proj_weight": rng.uniform(-E ** -0.5, E ** -0.5, (E, E)),
        "in_proj_bias": 0.1 * rng.standard_normal(3 * E),
        "out_proj_bias": 0.1 * rng.standard_normal(E),
    }
    return {k: v.astype(np.float32) for k, v in arrs.items()}


def _inputs(seed, B, M, E, padded=False):
    """Parameters, a unit-scale query (scores spread over a few units) and
    features; ``padded`` pads ~30% of the slots, never slot 0."""
    rng = np.random.default_rng(seed)
    arrs = _arrays(rng, E)
    q = rng.standard_normal((1, 1, E)).astype(np.float32)
    kv = rng.standard_normal((B, M, E)).astype(np.float32)
    kpm = None
    if padded:
        kpm = rng.random((B, M)) < 0.3
        kpm[:, 0] = False
    return arrs, q, kv, kpm


def _jax_params(arrs):
    return JaxParams(**{k: jnp.asarray(v) for k, v in arrs.items()})


def _torch_params(arrs):
    return AttentionPoolParams(**{k: torch.from_numpy(v) for k, v in arrs.items()})


def rel_close(got, want, rel=GRAD_REL, name=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, atol=rel * scale,
                               rtol=0, err_msg=name)


# ---- the module, against JAX's streamed Pallas kernels ----------------------


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("H", [1, 2])
def test_eval_matches_jax_streamed(H, padded):
    arrs, q, kv, kpm = _inputs(10 + H, 8, 3, 2048, padded)
    if padded:
        kpm[0] = True  # a fully padded row: uniform on both kernel paths
    j_out, j_w, _, j_info = jax_shared(
        _jax_params(arrs), jnp.asarray(q), jnp.asarray(kv), num_heads=H,
        training=False, interpret=True, precision="highest",
        key_padding_mask=None if kpm is None else jnp.asarray(kpm),
    )
    with torch.no_grad():
        out, w, mw, info = fused_fusion_pool_shared(
            _torch_params(arrs), torch.from_numpy(q), torch.from_numpy(kv),
            num_heads=H, precision="highest",
            key_padding_mask=None if kpm is None else torch.from_numpy(kpm),
        )
    assert tuple(out.shape) == (8, 1, 2048) and tuple(w.shape) == (8, 1, 3)
    np.testing.assert_allclose(out.numpy(), j_out, atol=OUT_TOL)
    np.testing.assert_allclose(w.numpy(), j_w, atol=W_TOL)
    np.testing.assert_array_equal(mw.numpy(), w.numpy())
    np.testing.assert_allclose(info["entropy"].numpy(), j_info["entropy"],
                               atol=W_TOL)
    assert (info["mask_rate"] == 0).all()
    if padded:
        np.testing.assert_allclose(w[0, 0].numpy(), 1.0 / 3, atol=1e-7)


def _loss(o, w, entropy):
    return (o * o).mean() + (w * w).sum() + 0.1 * entropy.sum()


def _grads_vs_jax(arrs, q, kv, kpm, H, kv_grad):
    """Port and JAX losses and gradients of ``_loss`` (eval)."""
    mask = None if kpm is None else jnp.asarray(kpm)

    def jax_loss(p, qq, x):
        o, w, _, info = jax_shared(
            p, qq, x, num_heads=H, training=False, interpret=True,
            precision="highest", kv_grad=kv_grad, key_padding_mask=mask,
        )
        return _loss(o, w, info["entropy"])

    loss_j, grads_j = jax.value_and_grad(jax_loss, (0, 1, 2))(
        _jax_params(arrs), jnp.asarray(q), jnp.asarray(kv)
    )
    tp = _torch_params(arrs)
    tq = torch.from_numpy(q).requires_grad_()
    tkv = torch.from_numpy(kv).requires_grad_()
    o, w, _, info = fused_fusion_pool_shared(
        tp, tq, tkv, num_heads=H, precision="highest", kv_grad=kv_grad,
        key_padding_mask=None if kpm is None else torch.from_numpy(kpm),
    )
    loss_t = _loss(o, w, info["entropy"])
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-6)
    for k in POOL:
        rel_close(getattr(tp, k).grad.numpy(), getattr(grads_j[0], k), name=k)
    rel_close(tq.grad.numpy(), grads_j[1], name="query")
    if kv_grad:
        rel_close(tkv.grad.numpy(), grads_j[2], name="kv")
    else:
        assert tkv.grad is None
        np.testing.assert_array_equal(np.asarray(grads_j[2]), 0.0)


@pytest.mark.parametrize("kv_grad", [True, False])
@pytest.mark.parametrize("H", [1, 2])
def test_grads_match_jax_streamed(H, kv_grad):
    """Params, query and kv gradients through the streamed forward and
    backward, with a weights and an entropy cotangent and padded slots."""
    _grads_vs_jax(*_inputs(20 + H, 8, 3, 2048, padded=True), H, kv_grad)


@pytest.mark.parametrize("kv_grad", [True, False])
def test_h2_belowcap_streamed_vjp_matches_jax(kv_grad):
    """H == 2 at E = 512 differentiates through the streamed split on both
    sides (JAX's ``_vjp_wants_streamed``)."""
    _grads_vs_jax(*_inputs(30, 8, 3, 512), 2, kv_grad)


# ---- routes -------------------------------------------------------------------


ROUTES = [
    # (E, H, grad, training) -> kernel wrappers called, in order
    (1028, 1, True, False, ["stream_mix", "stream_bwd"]),
    (1028, 2, True, True, ["stream_mix", "stream_bwd_mh"]),
    (1028, 1, False, False, ["stream_mix"]),
    (512, 2, True, False, ["stream_mix", "stream_bwd_mh"]),
    (512, 2, False, True, ["stream_mix"]),
    (512, 2, False, False, ["shared_query_fwd"]),
    (512, 1, True, True, ["shared_query_fwd", "shared_query_bwd"]),
    (256, 2, True, False, ["shared_query_fwd"]),  # torch backward
]


@pytest.mark.parametrize("E,H,grad,training,want", ROUTES)
def test_routes_follow_jax_dispatch(monkeypatch, E, H, grad, training, want):
    """Which kernels a call reaches: the streamed split above the cap, and
    for H == 2 training or gradients from E = 512; gradient-free eval
    below the cap keeps the resident kernel (JAX's ``_shared_core``)."""
    called = []

    def spy(name):
        fn = getattr(sq, name)

        def wrapper(*args, **kwargs):
            called.append(name)
            return fn(*args, **kwargs)

        return wrapper

    for name in ("stream_mix", "stream_bwd", "stream_bwd_mh",
                 "shared_query_fwd", "shared_query_bwd"):
        monkeypatch.setattr(sq, name, spy(name))
    arrs, q, kv, _ = _inputs(40, 4, 2, E)
    tp = _torch_params(arrs)
    with torch.set_grad_enabled(grad):
        out, _, _, _ = fused_fusion_pool_shared(
            tp, torch.from_numpy(q), torch.from_numpy(kv), num_heads=H,
            training=training, generator=torch.Generator().manual_seed(0),
        )
        if grad:
            out.square().mean().backward()
    assert called == want


def test_vjp_wants_streamed_matches_jax(monkeypatch):
    monkeypatch.delenv("AECF_H2_STREAM", raising=False)
    for H in (1, 2, 3, 4, 8):
        for E in (64, 256, 511, 512, 1024, 1025, 2048, 8192, 16384):
            assert sq._vjp_wants_streamed(H, E) == jax_sq._vjp_wants_streamed(
                H, E), (H, E)
    assert sq._STREAMED_H2_MIN_E == jax_sq._STREAMED_H2_MIN_E
    assert sq._STREAMED_E_CAP == jax_sq._STREAMED_E_CAP
    assert sq._RESIDENT_E_CAP == jax_sq._RESIDENT_E_CAP


def test_caps_and_alignment():
    """JAX's caps, and the streamed kernels' E % 4 (an unaligned E is the
    torch path's under ``'auto'``; a forced kernel call raises)."""
    for E, H, match in ((16384, 1, "streamed-split cap"),
                        (2048, 4, "num_heads<=2"),
                        (1030, 1, "divisible by 4"),
                        (514, 2, "divisible by 4")):
        # the caps raise before the parameters are read
        n = 8 if match.startswith(("streamed", "num_heads")) else E
        with pytest.raises(ValueError, match=match):
            fused_fusion_pool_shared(
                AttentionPoolParams(torch.zeros(3 * n, n), torch.zeros(n, n)),
                torch.zeros(1, 1, E), torch.zeros(2, 2, E), num_heads=H,
                training=True, generator=torch.Generator().manual_seed(0),
            )
    assert not sq._shared_takes(1, 1030) and not sq._shared_takes(2, 514)
    assert sq._shared_takes(1, 1022) and sq._shared_takes(2, 510)
    assert sq._shared_takes(1, 2048) and sq._shared_takes(2, 8192)


# ---- the plain versions ------------------------------------------------------


@pytest.mark.parametrize("H", [1, 2])
def test_plain_matches_the_torch_oracle_with_mask_injection(H):
    """Training through the streamed split against ``attention_pool_core``
    + ``curriculum_mask`` fed the port's own Bernoulli draw
    (``mask_override``): out, weights, masked weights, entropy, rate.  At
    ``'highest'``, the f32 oracle's mode (``'default'`` stores ``mix`` in
    bf16, as the JAX package does)."""
    B, M, E = 40, 4, 1028
    arrs, q, kv, _ = _inputs(50 + H, B, M, E)
    tp = _torch_params(arrs)
    with torch.no_grad():
        out, w, mw, info = fused_fusion_pool_shared(
            tp, torch.from_numpy(q), torch.from_numpy(kv), num_heads=H,
            training=True, base_mask_prob=0.9, min_active=2,
            generator=torch.Generator().manual_seed(H), precision="highest",
        )
        out_o, w_o = attention_pool_core(
            tp, torch.from_numpy(q).expand(B, 1, E), torch.from_numpy(kv),
            torch.from_numpy(kv), num_heads=H, need_weights=True,
        )
    seed = draw_seed_words(torch.Generator().manual_seed(H))
    keep = 1.0 - 0.9 * (info["entropy"][:, 0] / math.log(M)).clamp(0.0, 1.0)
    drawn = (mask_uniforms(seed, B, M) < keep[:, None]).float()
    mw_o, info_o = curriculum_mask(
        w_o, training=True, base_mask_prob=0.9, min_active=2,
        mask_override=drawn[:, None, :],
    )
    np.testing.assert_allclose(out.numpy(), out_o.numpy(), atol=OUT_TOL)
    np.testing.assert_allclose(w.numpy(), w_o.numpy(), atol=W_TOL)
    np.testing.assert_allclose(mw.numpy(), mw_o.numpy(), atol=W_TOL)
    for k in ("entropy", "mask_rate"):
        np.testing.assert_allclose(info[k].numpy(), info_o[k].numpy(),
                                   atol=W_TOL, err_msg=k)
    assert float(info["mask_rate"].mean()) > 0.1


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("H", [1, 2])
def test_stream_bwd_plain_is_the_forward_vjp(H, padded):
    """``stream_bwd_plain`` equals autograd of ``stream_mix_plain`` for the
    cotangents ``d_mix`` on mix and ``d_w`` on the head-mean weights."""
    B, M, E = 6, 3, 64
    rng = np.random.default_rng(60 + H)
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    kv = t(rng.standard_normal((B, M, E))).requires_grad_()
    u = t(0.3 * rng.standard_normal((H, E))).requires_grad_()
    c = t(rng.standard_normal(H)).requires_grad_()
    pad = None
    if padded:
        pad = torch.where(t(rng.random((B, M))) < 0.3, -1e30, 0.0)
        pad[:, 0] = 0.0
    d_mix = t(rng.standard_normal((B, H * E)))
    d_w = t(rng.standard_normal((B, M)))
    mix, w, *_ = stream_mix_plain(kv, u, c, pad)
    ((mix * d_mix).sum() + (w * d_w).sum()).backward()
    d_kv, du, dc = stream_bwd_plain(kv.detach(), d_mix, d_w, pad,
                                    u.detach(), c.detach(), want_dkv=True)
    torch.testing.assert_close(d_kv, kv.grad, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(du, u.grad, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dc, c.grad, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("H", [1, 2])
def test_resident_and_streamed_masks_agree(H):
    """The draws are keyed by (row, modality), so the resident and the
    streamed forward mask alike for the same seed words — here at E = 512,
    through the wrappers and, for H == 2, through the public function
    (training streams there with or without gradients)."""
    B, M, E = 64, 4, 512
    arrs, q, kv, kpm = _inputs(70 + H, B, M, E, padded=True)
    tp = _torch_params(arrs)
    kv_t = torch.from_numpy(kv)
    u, c, wctx, bctx, wo, bo = sq._prep(tp, torch.from_numpy(q)[0, 0], H)
    pad = sq._pad_bias_rows(torch.from_numpy(kpm))
    seed = draw_seed_words(torch.Generator().manual_seed(H))
    kw = dict(training=True, seed=seed, mask_prob=0.9, min_active=2)
    with torch.no_grad():
        res = shared_query_fwd(kv_t, u, c, pad, wctx, bctx, wo, bo, **kw)
        st = stream_mix(kv_t, u, c, pad, **kw)
    for i in (1, 2, 3, 4):  # w, mw, ent, rate
        assert torch.equal(res[i], st[i])
    assert float(st[4].mean()) > 0.1
    if H == 2:
        call = lambda: fused_fusion_pool_shared(  # noqa: E731
            tp, torch.from_numpy(q), kv_t, num_heads=2, training=True,
            base_mask_prob=0.9, min_active=2,
            key_padding_mask=torch.from_numpy(kpm),
            generator=torch.Generator().manual_seed(H),
        )
        with torch.no_grad():
            _, _, mw_ng, info_ng = call()
        _, _, mw_g, info_g = call()
        assert torch.equal(mw_ng[:, 0], res[2]) and torch.equal(mw_g[:, 0], res[2])
        assert torch.equal(info_g["mask_rate"][:, 0], res[4])


def test_wrappers_run_their_plain_versions_on_cpu():
    B, M, E = 5, 3, 64
    rng = np.random.default_rng(80)
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    kv = t(rng.standard_normal((B, M, E)))
    before = (stream_mix.launches, stream_bwd.launches, stream_bwd_mh.launches)
    for H, bwd in ((1, stream_bwd), (2, stream_bwd_mh)):
        u, c = t(rng.standard_normal((H, E))), t(rng.standard_normal(H))
        got = stream_mix(kv, u, c, None)
        want = stream_mix_plain(kv, u, c, None)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        d_mix, d_w = t(rng.standard_normal((B, H * E))), t(rng.standard_normal((B, M)))
        got = bwd(kv, d_mix, d_w, None, u, c, want_dkv=True)
        want = stream_bwd_plain(kv, d_mix, d_w, None, u, c, want_dkv=True)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert got[0].shape == (B, M, E) and got[1].shape == (H, E)
        assert got[2].shape == (H,)
        wrong = stream_bwd_mh if H == 1 else stream_bwd
        with pytest.raises(ValueError, match="H == "):
            wrong(kv, d_mix, d_w, None, u, c, want_dkv=False)
        with pytest.raises(ValueError, match="d_mix"):
            bwd(kv, d_mix[:, :E - 4], d_w, None, u, c, want_dkv=False)
    assert (stream_mix.launches, stream_bwd.launches,
            stream_bwd_mh.launches) == before  # the CPU never launches
    assert stream_bwd(kv, t(rng.standard_normal((B, E))), None, None,
                      t(rng.standard_normal((1, E))), t([0.1]),
                      want_dkv=False)[0] is None


# ---- the slice: the train-step builder ---------------------------------------


@pytest.mark.parametrize("H", [1, 2])
def test_slice_lockstep_with_jax(H):
    """``make_pool_train_step(impl='kernel')`` at E = 1536 (the streamed
    split) against the JAX builder's XLA path, as
    ``test_torch_port_pool_step.py`` holds the resident one: 3 SGD steps of
    the quadratic loss with the entropy regularizer, ``training=False``
    (the gradients do not depend on the draw, quirk Q1); losses rtol 2e-5,
    parameters atol 2e-5."""
    B, M, E, steps = 16, 4, 1536, 3
    rng = np.random.default_rng(90 + H)
    flat = {"['pool']." + k: v for k, v in _arrays(rng, E).items()}
    flat["['query']"] = rng.standard_normal((1, 1, E)).astype(np.float32)
    kv = rng.standard_normal((B, M, E)).astype(np.float32)

    pool = JaxParams(**{k.split(".")[1]: jnp.asarray(v) for k, v in flat.items()
                        if k.startswith("['pool']")})
    jparams = {"pool": pool, "query": jnp.asarray(flat["['query']"])}
    opt = optax.sgd(1e-2)
    jstate = JaxState(jparams, opt.init(jparams), jnp.zeros((), jnp.int32))
    jstep = jax_make(opt, num_heads=H, impl="xla", training=False,
                     entropy_coeff=0.01, precision="highest", donate=False)
    params = pool_classifier_params_from_numpy(flat, device="cpu")
    state = TrainState(params, torch.optim.SGD(param_leaves(params), lr=1e-2))
    step = make_pool_train_step(num_heads=H, impl="kernel", training=False,
                                entropy_coeff=0.01)
    for i in range(steps):
        jstate, loss_j, _ = jstep(jstate, jnp.asarray(kv), None,
                                  jax.random.key(i))
        state, loss_t, _ = step(state, torch.from_numpy(kv), None, None)
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=2e-5)
    got = pool_classifier_params_to_numpy(state.params)
    want = jax.tree_util.tree_flatten_with_path(jstate.params)[0]
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in want}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-5, err_msg=k)


def test_cuda_sources_ship():
    import os

    from aecf_tpu_torch.kernels import _build

    csrc = os.path.join(os.path.dirname(sq.__file__), "csrc")
    for name in ("stream_mix", "stream_bwd"):
        src = os.path.join(csrc, f"{name}.cu")
        assert os.path.exists(src), src
        assert _build.library_path(name).parent.parent == _build._BUILD_ROOT
        # both stage their rows through the shared staging header
        with open(src) as f:
            assert '#include "stream_stage.cuh"' in f.read()
    assert os.path.exists(os.path.join(csrc, "stream_stage.cuh"))
    # the streamed backward sums its partial rows with part_sum; colsum is
    # gone
    with open(os.path.join(csrc, "stream_bwd.cu")) as f:
        bwd = f.read()
    with open(os.path.join(csrc, "pool_common.cuh")) as f:
        common = f.read()
    assert "part_sum(" in bwd and "colsum(" not in bwd + common


# ---- the plain versions at the staged kernels' edge shapes -------------------


@pytest.mark.parametrize("H", [1, 2])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_edge_rows_match_jax(dtype, H):
    """The plain versions that ``chip_smoke.py`` holds the staged kernels
    to, at rows that are not 16-byte multiples (M = 3, E = 1540: 9240 bytes
    in bf16, 4620 in int8) and B = 133, against JAX's streamed Pallas
    kernels in interpret mode: the eval forward (out, weights, entropy) and
    the gradients of params and query through the streamed backward, with
    padded slots and a fully padded row.  Both sides read the same bf16 (or
    int8 and scales) values and sum in f32, so the f32 tolerances hold."""
    B, M, E = 133, 3, 1540
    arrs, q, kv, kpm = _inputs(100 + H, B, M, E, padded=True)
    kpm[0] = True
    if dtype == "bf16":
        jkv, jscales = jnp.asarray(kv, jnp.bfloat16), None
        tkv, tscales = torch.from_numpy(kv).bfloat16(), None
    else:
        jkv, jscales = jax_sq.quantize_features(jnp.asarray(kv))
        tkv = torch.from_numpy(np.array(jkv))
        tscales = torch.from_numpy(np.array(jscales))
    mask_j, mask_t = jnp.asarray(kpm), torch.from_numpy(kpm)

    def jax_loss(p, qq):
        o, w, _, info = jax_shared(
            p, qq, jkv, kv_scales=jscales, num_heads=H, training=False,
            interpret=True, precision="highest", key_padding_mask=mask_j,
        )
        return _loss(o, w, info["entropy"]), (o, w, info["entropy"])

    (loss_j, (j_out, j_w, j_ent)), grads_j = jax.value_and_grad(
        jax_loss, (0, 1), has_aux=True)(_jax_params(arrs), jnp.asarray(q))
    tp = _torch_params(arrs)
    for k in POOL:
        getattr(tp, k).requires_grad_()
    tq = torch.from_numpy(q).requires_grad_()
    out, w, mw, info = fused_fusion_pool_shared(
        tp, tq, tkv, kv_scales=tscales, num_heads=H, precision="highest",
        key_padding_mask=mask_t,
    )
    loss_t = _loss(out, w, info["entropy"])
    loss_t.backward()
    assert tuple(out.shape) == (B, 1, E)
    np.testing.assert_allclose(out.detach().numpy(), j_out, atol=OUT_TOL)
    np.testing.assert_allclose(w.detach().numpy(), j_w, atol=W_TOL)
    np.testing.assert_allclose(info["entropy"].detach().numpy(), j_ent,
                               atol=W_TOL)
    np.testing.assert_allclose(w[0, 0].detach().numpy(), 1.0 / 3, atol=1e-7)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-6)
    for k in POOL:
        rel_close(getattr(tp, k).grad.numpy(), getattr(grads_j[0], k), name=k)
    rel_close(tq.grad.numpy(), grads_j[1], name="query")
