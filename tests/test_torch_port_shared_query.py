"""The port's shared-query fusion pool against the JAX kernel.

On the CPU the port's ``fused_fusion_pool_shared`` runs the plain PyTorch
version of its CUDA kernel; the JAX reference runs its Pallas kernel in
interpret mode at ``precision="highest"``, as ``test_kernels_interpret.py``
does (training: JAX's XLA path, which has the Pallas training branch's
outputs; the masks against the port's ``mask_and_renorm`` on the call's
Philox uniforms).  Same numpy inputs, made from a seed.  Tolerances: out
and weights 1e-5 (f32 sums in other orders), ``mw == w`` exactly (eval
passthrough), masks 1e-6.  The chains take every width the forward takes:
``EDGE`` holds widths that are not multiples of their GEMMs' tiles and not
divisible by 4.

The CUDA kernel itself runs only on the card, where ``chip_smoke.py``
holds it to the plain version at the serving shapes (this directory's
``conftest.py`` imports JAX, which the card's machine does not have).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aecf_tpu.core.attention import AttentionPoolParams as JaxParams
from aecf_tpu.kernels import fused_fusion_pool_shared as jax_shared
from aecf_tpu.ops import fusion_pool as jax_fusion_pool
from aecf_tpu_torch.core import AttentionPoolParams
from aecf_tpu_torch.kernels import (
    fused_fusion_pool_shared,
    shared_query_fwd,
    shared_query_fwd_plain,
)
from aecf_tpu_torch.kernels.draws import (
    draw_seed_words,
    mask_and_renorm,
    mask_uniforms,
)
from aecf_tpu_torch.kernels.shared_query import _prep
from aecf_tpu_torch.ops import _wants_kernel, fusion_pool

ATOL = 1e-5
E = 64
# (E, H, B, M): widths that are not multiples of the chains' GEMM tiles and
# widths not divisible by 4, as chip_smoke.SQ_EDGE holds them on the card
EDGE = [(30, 1, 300, 3), (30, 2, 300, 3), (30, 3, 300, 3), (36, 1, 130, 4),
        (36, 3, 130, 4), (260, 1, 129, 2), (260, 2, 130, 3)]


def _params(rng, E=E):
    arrs = {
        "in_proj_weight": rng.uniform(-0.2, 0.2, (3 * E, E)),
        "out_proj_weight": rng.uniform(-0.2, 0.2, (E, E)),
        "in_proj_bias": 0.1 * rng.standard_normal(3 * E),
        "out_proj_bias": 0.1 * rng.standard_normal(E),
    }
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    return (
        JaxParams(**{k: jnp.asarray(v) for k, v in arrs.items()}),
        AttentionPoolParams(**{k: torch.from_numpy(v) for k, v in arrs.items()}),
    )


def _inputs(seed, B, M, H, padded, E=E):
    rng = np.random.default_rng(seed)
    jp, tp = _params(rng, E)
    q = (np.sqrt(2.0 / E) * rng.standard_normal((1, 1, E))).astype(np.float32)
    kv = rng.standard_normal((B, M, E)).astype(np.float32)
    kpm = None
    if padded:
        kpm = rng.random((B, M)) < 0.3
        kpm[0] = True  # a fully padded row: uniform on the kernel path
    return jp, tp, q, kv, kpm


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("H", [1, 2])
@pytest.mark.parametrize("B", [1, 16, 37])
@pytest.mark.parametrize("M", [2, 3])
def test_eval_matches_jax_interpret(M, B, H, padded):
    jp, tp, q, kv, kpm = _inputs(100 * M + B + 7 * H, B, M, H, padded)
    j_out, j_w, j_mw, j_info = jax_shared(
        jp, jnp.asarray(q), jnp.asarray(kv), num_heads=H, training=False,
        key_padding_mask=None if kpm is None else jnp.asarray(kpm),
        interpret=True, precision="highest",
    )
    with torch.no_grad():
        out, w, mw, info = fused_fusion_pool_shared(
            tp, torch.from_numpy(q), torch.from_numpy(kv), num_heads=H,
            key_padding_mask=None if kpm is None else torch.from_numpy(kpm),
            precision="highest",
        )
    assert tuple(out.shape) == (B, 1, E) and tuple(w.shape) == (B, 1, M)
    np.testing.assert_allclose(out.numpy(), j_out, atol=ATOL)
    np.testing.assert_allclose(w.numpy(), j_w, atol=ATOL)
    np.testing.assert_array_equal(mw.numpy(), w.numpy())
    assert set(info) == set(j_info) == {"entropy", "mask_rate"}
    np.testing.assert_allclose(info["entropy"].numpy(), j_info["entropy"], atol=ATOL)
    assert (info["mask_rate"] == 0).all()
    if padded:
        np.testing.assert_allclose(w[0, 0].numpy(), 1.0 / M, atol=1e-7)


def _close_out(got, want):
    """Outputs at the wider edge widths reach |out| ~ 3: 2e-5 of the
    largest entry, the heads tests' tolerance (f32 sums in other orders)."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=2e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("E,H,B,M", EDGE)
def test_eval_at_edge_widths_matches_jax_interpret(E, H, B, M):
    """Eval at the edge widths, padded (a fully padded row included):
    out, weights and entropy against JAX's Pallas kernel."""
    jp, tp, q, kv, kpm = _inputs(E + 10 * H + B, B, M, H, True, E=E)
    j_out, j_w, _, j_info = jax_shared(
        jp, jnp.asarray(q), jnp.asarray(kv), num_heads=H, training=False,
        key_padding_mask=jnp.asarray(kpm), interpret=True,
        precision="highest",
    )
    with torch.no_grad():
        out, w, mw, info = fused_fusion_pool_shared(
            tp, torch.from_numpy(q), torch.from_numpy(kv), num_heads=H,
            key_padding_mask=torch.from_numpy(kpm), precision="highest",
        )
    assert tuple(out.shape) == (B, 1, E) and tuple(w.shape) == (B, 1, M)
    _close_out(out.numpy(), j_out)
    np.testing.assert_allclose(w.numpy(), j_w, atol=ATOL)
    np.testing.assert_array_equal(mw.numpy(), w.numpy())
    np.testing.assert_allclose(info["entropy"].numpy(), j_info["entropy"],
                               atol=ATOL)


@pytest.mark.parametrize("E,H,B,M", EDGE)
def test_training_at_edge_widths_matches_xla_and_the_mask_chain(E, H, B, M):
    """Training at the edge widths: out, weights and entropy against JAX's
    XLA path (the mask does not enter them, quirk Q1), the masks against
    ``mask_and_renorm`` on the Philox uniforms of the call's seed words."""
    seed = E + H + B
    min_active = min(2, M - 1)  # M = 2 with min_active 2 keeps every slot
    jp, tp, q, kv, kpm = _inputs(seed, B, M, H, True, E=E)
    kpm[:, 0] = False  # the XLA path's -inf pad: NaN on a fully padded row
    j_out, j_w, _, j_info = jax_fusion_pool(
        jp, jnp.asarray(q), jnp.asarray(kv), num_heads=H, training=True,
        rng=jax.random.key(seed), key_padding_mask=jnp.asarray(kpm),
        base_mask_prob=0.6, min_active=min_active,
        implementation="xla",
    )
    words = draw_seed_words(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        out, w, mw, info = fused_fusion_pool_shared(
            tp, torch.from_numpy(q), torch.from_numpy(kv), num_heads=H,
            training=True, generator=torch.Generator().manual_seed(seed),
            base_mask_prob=0.6, min_active=min_active,
            key_padding_mask=torch.from_numpy(kpm), precision="highest",
        )
    _close_out(out.numpy(), j_out)
    np.testing.assert_allclose(w.numpy(), j_w, atol=ATOL)
    np.testing.assert_allclose(info["entropy"].numpy(), j_info["entropy"],
                               atol=ATOL)
    want_mw, want_rate, mask = mask_and_renorm(
        w[:, 0], info["entropy"][:, 0], mask_uniforms(words, B, M),
        mask_prob=0.6, min_active=min_active)
    np.testing.assert_allclose(mw[:, 0].numpy(), want_mw.numpy(), atol=1e-6)
    np.testing.assert_allclose(info["mask_rate"][:, 0].numpy(),
                               want_rate.numpy(), atol=1e-6)
    assert 0.0 < float(mask.mean()) < 1.0


def test_plain_version_matches_the_torch_oracle():
    """The restructured math (u/c scores, mix before the value projection)
    equals the naive attention pool, away from fully padded rows."""
    _, tp, q, kv, _ = _inputs(3, 9, 3, 2, False)
    with torch.no_grad():
        k = fusion_pool(tp, torch.from_numpy(q), torch.from_numpy(kv),
                        num_heads=2, implementation="kernel")
        o = fusion_pool(tp, torch.from_numpy(q), torch.from_numpy(kv),
                        num_heads=2, implementation="torch")
    for a, b in zip(k[:3], o[:3]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)
    for key in ("entropy", "mask_rate"):
        np.testing.assert_allclose(k[3][key].numpy(), o[3][key].numpy(), atol=ATOL)


def test_fully_padded_row_semantics_per_path():
    _, tp, q, kv, _ = _inputs(4, 4, 3, 1, False)
    kpm = torch.zeros(4, 3, dtype=torch.bool)
    kpm[1] = True
    args = (tp, torch.from_numpy(q), torch.from_numpy(kv))
    with torch.no_grad():
        _, wk, _, _ = fusion_pool(*args, key_padding_mask=kpm, implementation="kernel")
        _, wo, _, _ = fusion_pool(*args, key_padding_mask=kpm, implementation="torch")
    torch.testing.assert_close(wk[1, 0], torch.full((3,), 1.0 / 3))  # -1e30 bias
    assert torch.isnan(wo[1]).all()  # -inf: the oracle's semantics


def test_plain_version_keeps_autograd_on_cpu():
    _, tp, q, kv, _ = _inputs(5, 6, 2, 1, False)
    out, _, _, _ = fusion_pool(tp, torch.from_numpy(q), torch.from_numpy(kv),
                               implementation="kernel")
    out.square().sum().backward()
    assert torch.isfinite(tp.in_proj_weight.grad).all()


def test_training_raises_not_ported():
    """Training needs a generator for its draw; E > 1024 trains through the
    streamed split (zero weights: uniform attention, zero output)."""
    _, tp, q, kv, _ = _inputs(6, 4, 2, 1, False)
    with pytest.raises(ValueError, match="generator"):
        fused_fusion_pool_shared(tp, torch.from_numpy(q), torch.from_numpy(kv),
                                 training=True)
    e = 2048
    big = AttentionPoolParams(torch.zeros(3 * e, e), torch.zeros(e, e))
    out, w, mw, info = fused_fusion_pool_shared(
        big, torch.zeros(1, 1, e), torch.ones(2, 2, e), training=True,
        generator=torch.Generator().manual_seed(0),
    )
    assert tuple(out.shape) == (2, 1, e) and bool((out == 0).all())
    torch.testing.assert_close(w, torch.full((2, 1, 2), 0.5))
    assert set(info) == {"entropy", "mask_rate", "target_entropy"}
    assert bool(((info["mask_rate"] >= 0) & (info["mask_rate"] <= 0.5)).all())


@pytest.mark.parametrize("training", [False, True])
def test_auto_dispatch_picks_torch_for_cpu_tensors(training):
    _, tp, q, kv, _ = _inputs(7, 4, 2, 1, False)
    q, kv = torch.from_numpy(q), torch.from_numpy(kv)
    assert not _wants_kernel(tp, q, kv, num_heads=1, precision="highest")
    before = shared_query_fwd.launches
    with torch.no_grad():
        fusion_pool(tp, q, kv, training=training,
                    generator=torch.Generator().manual_seed(0))
    assert shared_query_fwd.launches == before  # the CPU never launches


@pytest.mark.parametrize(
    "kwargs,exc,match",
    [
        ({"precision": "high"}, ValueError, "precision"),
        ({"query_shape": (2, 1, E)}, ValueError, "query"),
        ({"E": 2048, "H": 4}, ValueError, "num_heads<=2"),
        ({"E": 16384}, ValueError, "cap"),
        ({"M": 9}, ValueError, "M <= 8"),
        ({"H": 3}, ValueError, "H <="),  # H does not divide E
        ({"dtype": torch.float16}, TypeError, "float32 or bfloat16"),
    ],
)
def test_rejects_what_the_kernel_does_not_take(kwargs, exc, match):
    e = kwargs.get("E", E)
    M = kwargs.get("M", 2)
    # E-sized parameters are never reached when E is rejected
    tp = AttentionPoolParams(
        torch.zeros(3 * E, E), torch.zeros(E, E), torch.zeros(3 * E), torch.zeros(E)
    )
    q = torch.zeros(kwargs.get("query_shape", (1, 1, e)))
    kv = torch.zeros(3, M, e, dtype=kwargs.get("dtype", torch.float32))
    with pytest.raises(exc, match=match):
        fused_fusion_pool_shared(tp, q, kv, num_heads=kwargs.get("H", 1),
                                 precision=kwargs.get("precision", "default"))


def test_wrapper_checks_operand_shapes():
    _, tp, q, kv, _ = _inputs(8, 4, 2, 1, False)
    kv = torch.from_numpy(kv)
    u, c, wctx, bctx, wo, bo = _prep(tp, torch.from_numpy(q)[0, 0], 1)
    with pytest.raises(ValueError, match="must be None for H == 1"):
        shared_query_fwd(kv, u, c, None, wctx, bctx, wctx, bctx)
    with pytest.raises(ValueError, match="pad_bias"):
        shared_query_fwd(kv, u, c, torch.zeros(4, 3), wctx, bctx)
    with pytest.raises(ValueError, match="wctx"):
        shared_query_fwd(kv, u, c, None, wctx.double(), bctx)


def test_cuda_source_ships_and_builds_outside_git():
    """The .cu source is package data, every module dir is a package, and
    the build goes to the git-ignored build/ with flags that keep the
    entropy's subnormal floor (no fast-math, no flush-to-zero)."""
    import os
    import tomllib

    from aecf_tpu_torch.kernels import _build

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    assert set(data["aecf_tpu_torch"]) == {
        "py.typed", "kernels/csrc/*.cu", "kernels/csrc/*.cuh",
        "native/batcher.cc",
    }
    pkg = os.path.join(root, "aecf_tpu_torch")
    assert os.path.exists(os.path.join(pkg, "native", "batcher.cc"))
    for src in ("shared_query_fwd.cu", "shared_query_bwd.cu", "train_step.cu",
                "pool_common.cuh", "pool_rows.cuh", "gemm_f32.cuh"):
        assert os.path.exists(os.path.join(pkg, "kernels", "csrc", src)), src
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        if any(f.endswith(".py") for f in filenames):
            assert "__init__.py" in filenames, dirpath
    lib = _build.library_path("shared_query_fwd")
    assert lib.parent.parent == _build._BUILD_ROOT
    assert os.path.relpath(lib, root).startswith(os.path.join("build", "aecf_tpu_torch"))
    flags = " ".join(_build.NVCC_FLAGS)
    assert "sm_90a" in flags
    assert "fast_math" not in flags and "ftz=true" not in flags
