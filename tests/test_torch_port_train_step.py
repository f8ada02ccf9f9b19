"""The port's one-pass train step against the JAX package's.

On the CPU the port's ``fused_pool_train_step`` runs the plain PyTorch
version of its CUDA kernel (``train_step_plain``); the JAX reference runs
its Pallas step in interpret mode at ``precision="highest"`` with
``training=False`` (the TPU PRNG has no interpret lowering; the gradients
do not depend on the draw, quirk Q1), as ``test_train_step_kernel.py``
does.  Same numpy inputs, made from a seed.  Tolerances: loss rtol 1e-6,
gradients and ``d_kv`` atol 1e-5 (f32 sums in other orders).

The CUDA kernel itself runs only on the card, where ``chip_smoke.py``
holds it to the plain version at the north-star shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aecf_tpu.core.attention import AttentionPoolParams as JaxParams
from aecf_tpu.kernels import fused_pool_head_train_step as jax_head_step
from aecf_tpu.kernels import fused_pool_train_step as jax_step
from aecf_tpu_torch.core import AttentionPoolParams
from aecf_tpu_torch.kernels import (
    fused_pool_head_train_step,
    fused_pool_train_step,
    step_tile,
    supports_fused_step,
    train_step,
    train_step_plain,
)

E, M, C = 64, 3, 6
POOL = ("in_proj_weight", "out_proj_weight", "in_proj_bias", "out_proj_bias")


def _inputs(seed, B=100, bias=True, dtype=np.float32, head=False,
            head_bias=True, E=E):
    rng = np.random.default_rng(seed)
    arrs = {
        "in_proj_weight": rng.uniform(-0.2, 0.2, (3 * E, E)),
        "out_proj_weight": rng.uniform(-0.2, 0.2, (E, E)),
    }
    if bias:
        arrs["in_proj_bias"] = 0.1 * rng.standard_normal(3 * E)
        arrs["out_proj_bias"] = 0.1 * rng.standard_normal(E)
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    q = (np.sqrt(2.0 / E) * rng.standard_normal((1, 1, E))).astype(np.float32)
    kv = rng.standard_normal((B, M, E)).astype(np.float32)
    out = {
        "jp": JaxParams(**{k: jnp.asarray(v) for k, v in arrs.items()}),
        "tp": AttentionPoolParams(
            **{k: torch.from_numpy(v) for k, v in arrs.items()}
        ),
        "q": q,
        "kv": kv,
        "jkv": jnp.asarray(kv).astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32),
        "tkv": torch.from_numpy(kv).to(
            torch.bfloat16 if dtype == "bf16" else torch.float32
        ),
    }
    if head:
        out["hw"] = rng.uniform(-0.1, 0.1, (E, C)).astype(np.float32)
        out["hb"] = (
            rng.uniform(-0.1, 0.1, C).astype(np.float32) if head_bias else None
        )
        out["labels"] = (rng.random((B, C)) < 0.3).astype(np.float32)
    return out


def _assert_pool_grads(dp_t, dp_j, atol=1e-5):
    for k in POOL:
        want = getattr(dp_j, k)
        if want is None:
            assert dp_t[k] is None, k
            continue
        np.testing.assert_allclose(dp_t[k].numpy(), np.asarray(want),
                                   atol=atol, err_msg=k)


def _run_both(x, *, kv_grad=False, kpm=None, loss_scale=1.0):
    j = jax_step(
        x["jp"], jnp.asarray(x["q"]), x["jkv"], rng=None, training=False,
        precision="highest", kv_grad=kv_grad, interpret=True,
        key_padding_mask=None if kpm is None else jnp.asarray(kpm),
        loss_scale=loss_scale,
    )
    t = fused_pool_train_step(
        x["tp"], torch.from_numpy(x["q"]), x["tkv"], training=False,
        precision="highest", kv_grad=kv_grad,
        key_padding_mask=None if kpm is None else torch.from_numpy(kpm),
        loss_scale=loss_scale,
    )
    return j, t


def _assert_step_close(j, t, *, kv_grad, E=E):
    loss_j, dp_j, dq_j, dkv_j, info_j = j
    loss_t, dp_t, dq_t, dkv_t, info_t = t
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    _assert_pool_grads(dp_t, dp_j)
    assert tuple(dq_t.shape) == (1, 1, E)
    np.testing.assert_allclose(dq_t.numpy(), np.asarray(dq_j), atol=1e-5)
    if kv_grad:
        assert str(dkv_t.dtype) == f"torch.{dkv_j.dtype}"  # kv's dtype
        np.testing.assert_allclose(dkv_t.float().numpy(),
                                   np.asarray(dkv_j, np.float32), atol=1e-5)
    else:
        assert dkv_t is None and dkv_j is None
    assert set(info_t) == set(info_j)
    for k in info_j:
        np.testing.assert_allclose(info_t[k].numpy(), np.asarray(info_j[k]),
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("kv_grad", [False, True])
def test_step_matches_jax(bias, kv_grad):
    x = _inputs(1 + bias + 2 * kv_grad, bias=bias)
    _assert_step_close(*_run_both(x, kv_grad=kv_grad), kv_grad=kv_grad)


@pytest.mark.parametrize(
    "case", ["odd_batch", "padding", "bf16", "loss_scale"]
)
def test_step_matches_jax_options(case):
    B = 37 if case == "odd_batch" else 100
    x = _inputs(10, B=B, dtype="bf16" if case == "bf16" else np.float32)
    kpm = None
    if case == "padding":
        kpm = np.random.default_rng(3).random((B, M)) < 0.3
        kpm[:, 0] = False  # one live slot a row
    kv_grad = case in ("bf16", "padding")
    _assert_step_close(
        *_run_both(x, kv_grad=kv_grad, kpm=kpm,
                   loss_scale=0.25 if case == "loss_scale" else 1.0),
        kv_grad=kv_grad,
    )


def _head_step_both(x, head_bias):
    jhead = {"w": jnp.asarray(x["hw"])}
    thead = {"w": torch.from_numpy(x["hw"])}
    if head_bias:
        jhead["b"] = jnp.asarray(x["hb"])
        thead["b"] = torch.from_numpy(x["hb"])
    loss_j, g_j, _, info_j = jax_head_step(
        x["jp"], jnp.asarray(x["q"]), jhead, x["jkv"], jnp.asarray(x["labels"]),
        rng=None, training=False, precision="highest", interpret=True,
    )
    loss_t, g_t, dkv_t, info_t = fused_pool_head_train_step(
        x["tp"], torch.from_numpy(x["q"]), thead, x["tkv"],
        torch.from_numpy(x["labels"]), training=False, precision="highest",
    )
    return (loss_j, g_j, info_j), (loss_t, g_t, dkv_t, info_t)


def _assert_head_step_close(j, t):
    loss_j, g_j, info_j = j
    loss_t, g_t, dkv_t, info_t = t
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    _assert_pool_grads(g_t["pool"], g_j["pool"])
    np.testing.assert_allclose(g_t["query"].numpy(), np.asarray(g_j["query"]),
                               atol=1e-5)
    assert set(g_t["head"]) == set(g_j["head"])
    for k in g_j["head"]:
        np.testing.assert_allclose(g_t["head"][k].numpy(),
                                   np.asarray(g_j["head"][k]), atol=1e-5)
    assert dkv_t is None
    assert set(info_t) == set(info_j)


@pytest.mark.parametrize("head_bias", [True, False])
def test_head_step_matches_jax(head_bias):
    x = _inputs(20, head=True, head_bias=head_bias)
    _assert_head_step_close(*_head_step_both(x, head_bias))


# Widths that are not multiples of the step GEMMs' tiles (128 rows, 64 or
# 128 columns, k-depth 16): the kernels mask the ragged edges on the card,
# and the plain version must agree with JAX there too.
@pytest.mark.parametrize("head", [False, True])
@pytest.mark.parametrize("width", [36, 132])
def test_step_matches_jax_at_ragged_widths(width, head):
    x = _inputs(70 + width + head, B=130, head=head, E=width)
    if head:
        _assert_head_step_close(*_head_step_both(x, True))
    else:
        _assert_step_close(*_run_both(x), kv_grad=False, E=width)


def test_training_info_contract_and_q1():
    """Training adds target_entropy and draws a mask; the gradients are
    those of the eval step exactly (quirk Q1) and mask_rate is a rate."""
    x = _inputs(30, B=64)
    args = (x["tp"], torch.from_numpy(x["q"]), x["tkv"])
    ev = fused_pool_train_step(*args, training=False)
    tr = fused_pool_train_step(*args, training=True, base_mask_prob=0.9,
                               generator=torch.Generator().manual_seed(0))
    assert set(tr[4]) == {
        "entropy", "mask_rate", "target_entropy", "attention_weights",
        "masked_attention_weights",
    }
    assert torch.equal(tr[0], ev[0])
    for k in POOL:
        assert torch.equal(tr[1][k], ev[1][k]), k
    rate = tr[4]["mask_rate"]
    assert rate.shape == (64, 1) and 0 < float(rate.mean()) < 1
    torch.testing.assert_close(tr[4]["entropy"], ev[4]["entropy"])
    torch.testing.assert_close(
        tr[4]["target_entropy"], torch.full((64, 1), np.log(M) * 0.7)
    )


def test_custom_row_loss_on_cpu_equals_the_built_in():
    x = _inputs(40, B=50)
    args = (x["tp"], torch.from_numpy(x["q"]), x["tkv"])
    inv = 1.0 / (50 * E)
    quad = lambda out: ((out * out).sum(-1, keepdim=True) * inv,  # noqa: E731
                        out * (2 * inv))
    a = fused_pool_train_step(*args, training=False)
    b = fused_pool_train_step(*args, training=False, row_loss=quad)
    torch.testing.assert_close(a[0], b[0])
    for k in POOL:
        torch.testing.assert_close(a[1][k], b[1][k])


@pytest.mark.parametrize(
    "kwargs,exc,match",
    [
        ({"row_offset": 4, "batch_rows": 3}, ValueError, "not a multiple"),
        ({"kv_scales": torch.ones(8, M)}, ValueError, "kv_scales passed"),
        ({"precision": "high"}, ValueError, "precision"),
        ({"training": True}, ValueError, "generator"),
        ({"head_w": torch.zeros(E, C)}, ValueError, "labels"),
    ],
)
def test_step_rejects_what_it_does_not_cover(kwargs, exc, match):
    x = _inputs(50, B=8)
    kwargs = {"training": False, **kwargs}
    with pytest.raises(exc, match=match):
        fused_pool_train_step(x["tp"], torch.from_numpy(x["q"]), x["tkv"],
                              **kwargs)


def test_non_cpu_tensors_launch_or_raise():
    """Off the CPU the wrapper never runs its plain version: a custom
    row_loss goes to the two-pass kernels, whose wrappers raise on a
    device with no kernel, as the step's own does."""
    kv = torch.zeros(4, M, E, device="meta")
    f = lambda *s: torch.zeros(*s, device="meta")  # noqa: E731
    args = (kv, f(E), f(1), None, f(E, E), f(E))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        train_step(*args, inv=1.0, want_dkv=False,
                   row_loss=lambda o: (o.sum(-1, keepdim=True), o))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        train_step(*args, inv=1.0, want_dkv=False)


def test_gates_and_plain_is_the_cpu_path():
    assert supports_fused_step(1, 512) and supports_fused_step(1, 1024)
    assert not supports_fused_step(2, 512) and not supports_fused_step(1, 2048)
    assert step_tile(4096, 3, 512) == 128  # the GEMMs' block tile rows
    x = _inputs(60, B=20)
    kv = x["tkv"]
    u, c = torch.randn(E), torch.randn(1)
    wvo, bctx = torch.randn(E, E), torch.randn(E)
    before = train_step.launches
    a = train_step(kv, u, c, None, wvo, bctx, inv=0.1, want_dkv=True,
                   seed=(3, 4))
    b = train_step_plain(kv, u, c, None, wvo, bctx, inv=0.1, want_dkv=True,
                         seed=(3, 4))
    assert train_step.launches == before  # the CPU never launches
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_build_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """The three sources share csrc/pool_common.cuh: editing it must move
    every library to a new build directory, or a stale build is reused."""
    import shutil

    from aecf_tpu_torch.kernels import _build

    for f in _build._CSRC.iterdir():
        shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    names = ("shared_query_fwd", "shared_query_bwd", "train_step")
    before = {n: _build.library_path(n) for n in names}
    assert len(set(p.parent for p in before.values())) == 3
    header = tmp_path / "pool_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in names}
    assert all(before[n] != after[n] for n in names)
    (tmp_path / "train_step.cu").write_text("// edited source\n")
    assert _build.library_path("train_step") != after["train_step"]
    assert _build.library_path("shared_query_fwd") == after["shared_query_fwd"]


def test_shared_memory_count_matches_the_sources():
    """The wrapper's shared-memory count (checked before any dispatch, so
    the CPU sees the card's limits) uses the constants of
    ``csrc/gemm_f32.cuh``, ``csrc/pool_common.cuh`` and
    ``csrc/train_step.cu``: read them there and recompute the GEMM ring
    (``smem_bytes<128, false, true>``) and the head kernel's bytes."""
    import importlib
    import re

    from aecf_tpu_torch.kernels import _build

    ts_mod = importlib.import_module("aecf_tpu_torch.kernels.train_step")

    src = "".join((_build._CSRC / f).read_text() for f in (
        "gemm_f32.cuh", "pool_common.cuh", "train_step.cu"))

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert re.search(r"constexpr int kLdK = kBK \+ 4;", src)
    assert re.search(
        r"kMaxSmemBytes = smem_bytes<128, false, true>\(\);", src)
    bm, bk, stages = const("kBM"), const("kBK"), const("kStages")
    ring = 4 * stages * (bm * (bk + 4) + bk * 128)
    assert ts_mod._GEMM_SMEM == ring
    assert ts_mod._HEAD_STAGE_FLOATS == const("kHeadStageFloats")
    threads = const("kThreads")
    assert re.search(r"constexpr int kWarps = kThreads / 32;", src)
    assert ts_mod._HEAD_WARPS == threads // 32
    stage = ts_mod._HEAD_STAGE_FLOATS
    for E, C in ((512, 14), (1024, 24), (1024, 25), (30, 0), (1024, 2000)):
        head = 4 * ((E * C if E * C <= stage else 0) + threads // 32 * C)
        assert ts_mod._step_smem(E, C) == max(ring, head if C else 0)
