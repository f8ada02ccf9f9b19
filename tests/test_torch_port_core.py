"""The port's core (``aecf_tpu_torch.core``) against the JAX package's.

Same numpy inputs, made from a seed, go through ``aecf_tpu.core`` (JAX on
the CPU) and ``aecf_tpu_torch.core``.  Masking draws are injected
(``mask_override``): the two frameworks' generators give different bits.
Tolerances: 1e-6 for the masking chain and entropy (elementwise f32 with
at most a length-L sum), 1e-5 for the attention pool (f32 GEMMs summed in
another order), 1e-5 against the goldens recorded from the reference.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aecf_tpu import core as jcore
from aecf_tpu.core import masking as jmasking
from aecf_tpu_torch import core as tcore
from aecf_tpu_torch.core import masking as tmasking

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
ATOL_MASK = 1e-6
ATOL_POOL = 1e-5
ATOL_GOLDEN = 1e-5


def _softmax_rows(rng, shape, zero_frac=0.0):
    w = rng.random(shape).astype(np.float32) ** 3
    if zero_frac:
        w[rng.random(shape) < zero_frac] = 0.0
        w[..., 0] += 1e-3  # keep every row's sum positive
    return (w / w.sum(-1, keepdims=True)).astype(np.float32)


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# masking
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L", [2, 3, 7])
def test_compute_entropy_matches_jax(L):
    rng = np.random.default_rng(L)
    w = _softmax_rows(rng, (32, L), zero_frac=0.3)
    jw, tw = _both(w)
    np.testing.assert_allclose(
        tcore.compute_entropy(tw).numpy(), jcore.compute_entropy(jw),
        atol=ATOL_MASK,
    )


def test_compute_entropy_gradient_matches_jax_and_is_finite_at_zero():
    rng = np.random.default_rng(0)
    w = _softmax_rows(rng, (16, 4), zero_frac=0.4)
    # exact zeros inside the clip interval (at the interval's ends the
    # frameworks split the clip gradient differently)
    w[0] = [0.7, 0.3, 0.0, 0.0]
    cot = rng.standard_normal(16).astype(np.float32)
    j_grad = jax.grad(
        lambda x: (jcore.compute_entropy(x) * jnp.asarray(cot)).sum()
    )(jnp.asarray(w))
    tw = torch.from_numpy(w).requires_grad_(True)
    (tcore.compute_entropy(tw) * torch.from_numpy(cot)).sum().backward()
    assert torch.isfinite(tw.grad).all()
    np.testing.assert_allclose(tw.grad.numpy(), j_grad, atol=1e-5)


@pytest.mark.parametrize("seq_len,target", [(2, 0.7), (4, 0.5), (1, 0.7)])
def test_entropy_loss_matches_jax(seq_len, target):
    rng = np.random.default_rng(seq_len)
    ent = rng.random(24).astype(np.float32)
    ent[:3] = [np.nan, np.inf, -np.inf]
    je, te = _both(ent)
    np.testing.assert_allclose(
        tcore.entropy_loss(te, seq_len=seq_len, entropy_target=target).item(),
        float(jcore.entropy_loss(je, seq_len=seq_len, entropy_target=target)),
        atol=ATOL_MASK,
    )


def test_curriculum_mask_eval_matches_jax():
    rng = np.random.default_rng(1)
    w = _softmax_rows(rng, (8, 3, 5))
    jw, tw = _both(w)
    j_out, j_info = jcore.curriculum_mask(jw, training=False)
    t_out, t_info = tcore.curriculum_mask(tw, training=False)
    assert t_out is tw  # eval is a passthrough
    assert set(t_info) == set(j_info) == {"entropy", "mask_rate"}
    for k in j_info:
        np.testing.assert_allclose(t_info[k].numpy(), j_info[k], atol=ATOL_MASK)


@pytest.mark.parametrize("min_active", [1, 2, 5])
@pytest.mark.parametrize("L", [2, 4])
def test_curriculum_mask_training_injected_matches_jax(min_active, L):
    rng = np.random.default_rng(10 * min_active + L)
    w = _softmax_rows(rng, (40, L), zero_frac=0.2)
    w[0] = 0.0  # degenerate row → uniform
    w[1, 0] = np.nan  # scrubbed
    w[2] = [0.5] * L  # unnormalized, all tied (top-k first occurrence)
    mask = (rng.random((40, L)) < 0.5).astype(np.float32)
    mask[3] = 0.0  # forces the min_active replacement
    kw = dict(training=True, base_mask_prob=0.4, entropy_target=0.6,
              min_active=min_active)
    j_out, j_info = jcore.curriculum_mask(
        jnp.asarray(w), mask_override=jnp.asarray(mask), **kw
    )
    t_out, t_info = tcore.curriculum_mask(
        torch.from_numpy(w), mask_override=torch.from_numpy(mask), **kw
    )
    np.testing.assert_allclose(t_out.numpy(), j_out, atol=ATOL_MASK)
    assert set(t_info) == set(j_info)
    for k in j_info:
        np.testing.assert_allclose(t_info[k].numpy(), j_info[k], atol=ATOL_MASK)


def test_top_k_indicator_first_occurrence_matches_jax():
    w = np.array(
        [[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1], [0.3, 0.2, 0.3, 0.2]],
        np.float32,
    )
    for k in (1, 2, 3):
        np.testing.assert_array_equal(
            tmasking._top_k_indicator(torch.from_numpy(w), k).numpy(),
            jmasking._top_k_indicator(jnp.asarray(w), k),
        )


def test_curriculum_mask_training_draws_from_generator():
    w = torch.from_numpy(_softmax_rows(np.random.default_rng(2), (256, 3)))
    with pytest.raises(ValueError, match="Generator"):
        tcore.curriculum_mask(w, training=True)
    draw = lambda: tcore.curriculum_mask(  # noqa: E731
        w, training=True, generator=torch.Generator().manual_seed(7),
        base_mask_prob=1.0,
    )
    (out_a, info_a), (out_b, _) = draw(), draw()
    torch.testing.assert_close(out_a, out_b)  # same seed, same draw
    torch.testing.assert_close(out_a.sum(-1), torch.ones(256))
    assert 0.0 < info_a["mask_rate"].mean().item() < 1.0


def test_curriculum_mask_single_slot_early_return():
    w = torch.ones(4, 1)
    out, info = tcore.curriculum_mask(w, training=True)
    assert out is w
    assert set(info) == {"entropy", "mask_rate", "target_entropy"}
    assert all((v == 0).all() for v in info.values())


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _pool_params(rng, E, bias=True):
    arrs = {
        "in_proj_weight": rng.uniform(-0.2, 0.2, (3 * E, E)),
        "out_proj_weight": rng.uniform(-0.2, 0.2, (E, E)),
        "in_proj_bias": 0.1 * rng.standard_normal(3 * E) if bias else None,
        "out_proj_bias": 0.1 * rng.standard_normal(E) if bias else None,
    }
    arrs = {k: None if v is None else v.astype(np.float32) for k, v in arrs.items()}
    j = jcore.AttentionPoolParams(
        **{k: None if v is None else jnp.asarray(v) for k, v in arrs.items()}
    )
    t = tcore.AttentionPoolParams(
        **{k: None if v is None else torch.from_numpy(v) for k, v in arrs.items()}
    )
    return j, t


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("H", [1, 2, 4])
def test_attention_pool_core_matches_jax(H, padded):
    rng = np.random.default_rng(H)
    E, B, T, S = 16, 6, 1, 4
    jp, tp = _pool_params(rng, E)
    q = rng.standard_normal((B, T, E)).astype(np.float32)
    kv = rng.standard_normal((B, S, E)).astype(np.float32)
    kpm = None
    if padded:
        kpm = rng.random((B, S)) < 0.3
        kpm[:, 0] = False  # no fully padded row: the oracle gives NaN there
    j_out, j_w = jcore.attention_pool_core(
        jp, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), num_heads=H,
        key_padding_mask=None if kpm is None else jnp.asarray(kpm),
    )
    with torch.no_grad():
        t_out, t_w = tcore.attention_pool_core(
            tp, torch.from_numpy(q), torch.from_numpy(kv),
            torch.from_numpy(kv), num_heads=H,
            key_padding_mask=None if kpm is None else torch.from_numpy(kpm),
        )
    np.testing.assert_allclose(t_out.numpy(), j_out, atol=ATOL_POOL)
    np.testing.assert_allclose(t_w.numpy(), j_w, atol=ATOL_POOL)


def test_attention_pool_core_without_bias_and_with_attn_mask():
    rng = np.random.default_rng(5)
    E, B, T, S = 8, 3, 2, 5
    jp, tp = _pool_params(rng, E, bias=False)
    q = rng.standard_normal((B, T, E)).astype(np.float32)
    kv = rng.standard_normal((B, S, E)).astype(np.float32)
    am = rng.standard_normal((T, S)).astype(np.float32)
    j_out, _ = jcore.attention_pool_core(
        jp, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), num_heads=2,
        attn_mask=jnp.asarray(am),
    )
    with torch.no_grad():
        t_out, _ = tcore.attention_pool_core(
            tp, torch.from_numpy(q), torch.from_numpy(kv),
            torch.from_numpy(kv), num_heads=2, attn_mask=torch.from_numpy(am),
        )
    np.testing.assert_allclose(t_out.numpy(), j_out, atol=ATOL_POOL)


def test_scaled_dot_product_attention_matches_jax():
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((3, n, 8)).astype(np.float32) for n in (2, 5, 5))
    np.testing.assert_allclose(
        tcore.scaled_dot_product_attention(*map(torch.from_numpy, (q, k, v))).numpy(),
        jcore.scaled_dot_product_attention(*map(jnp.asarray, (q, k, v))),
        atol=ATOL_POOL,
    )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def test_init_shapes_bounds_and_determinism():
    E = 32
    g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    p = tcore.init_attention_pool_params(g(), E)
    assert tuple(p.in_proj_weight.shape) == (3 * E, E)
    assert tuple(p.out_proj_weight.shape) == (E, E)
    assert p.in_proj_weight.abs().max() <= math.sqrt(6.0 / (4 * E))
    assert p.out_proj_weight.abs().max() <= 1.0 / math.sqrt(E)
    assert (p.in_proj_bias == 0).all() and (p.out_proj_bias == 0).all()
    torch.testing.assert_close(
        p.in_proj_weight, tcore.init_attention_pool_params(g(), E).in_proj_weight
    )
    nb = tcore.init_attention_pool_params(g(), E, bias=False)
    assert nb.in_proj_bias is None and nb.out_proj_bias is None
    q = tcore.init_fusion_query(torch.Generator().manual_seed(0), 4096)
    assert tuple(q.shape) == (1, 1, 4096)
    assert abs(q.std().item() - math.sqrt(2.0 / 4096)) < 0.1 * math.sqrt(2.0 / 4096)


# ---------------------------------------------------------------------------
# goldens recorded from the reference (mask injection)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["c1", "c2", "c3", "c4", "c5", "c6"])
def test_curriculum_golden(case):
    g = np.load(os.path.join(GOLDEN, "curriculum_golden.npz"))
    mask = g.get(f"{case}_mask")
    out, info = tcore.curriculum_mask(
        torch.from_numpy(g[f"{case}_weights"]),
        training=bool(g[f"{case}_training"]),
        base_mask_prob=float(g[f"{case}_base_mask_prob"]),
        entropy_target=float(g[f"{case}_entropy_target"]),
        min_active=int(g[f"{case}_min_active"]),
        mask_override=None if mask is None else torch.from_numpy(mask),
    )
    np.testing.assert_allclose(out.numpy(), g[f"{case}_out"], atol=ATOL_GOLDEN)
    keys = {k[len(f"{case}_info_"):] for k in g.files if k.startswith(f"{case}_info_")}
    assert set(info) == keys
    for k in keys:
        np.testing.assert_allclose(
            info[k].numpy(), g[f"{case}_info_{k}"], atol=ATOL_GOLDEN
        )
    loss = tcore.entropy_loss(
        info["entropy"], seq_len=int(g[f"{case}_last_seq_len"]),
        entropy_target=float(g[f"{case}_entropy_target"]),
    )
    np.testing.assert_allclose(
        loss.item(), g[f"{case}_entropy_loss"], atol=ATOL_GOLDEN
    )


def test_pool_golden():
    """Attention pool (H=4) + training masking with the recorded mask,
    against the reference's recorded outputs and info."""
    g = np.load(os.path.join(GOLDEN, "pool_golden.npz"))
    params = tcore.AttentionPoolParams(
        **{k: torch.from_numpy(g[k]) for k in (
            "in_proj_weight", "out_proj_weight", "in_proj_bias", "out_proj_bias"
        )}
    )
    with torch.no_grad():
        out, weights = tcore.attention_pool_core(
            params, torch.from_numpy(g["q"]), torch.from_numpy(g["kv"]),
            torch.from_numpy(g["kv"]), num_heads=4,
        )
        masked, info = tcore.curriculum_mask(
            weights, training=True, base_mask_prob=0.4, entropy_target=0.6,
            min_active=2, mask_override=torch.from_numpy(g["mask"]),
        )
    info["attention_weights"] = weights
    info["masked_attention_weights"] = masked
    np.testing.assert_allclose(out.numpy(), g["out"], atol=ATOL_GOLDEN)
    keys = {k[len("info_"):] for k in g.files if k.startswith("info_")}
    assert set(info) == keys
    for k in keys:
        np.testing.assert_allclose(info[k].numpy(), g[f"info_{k}"], atol=ATOL_GOLDEN)
