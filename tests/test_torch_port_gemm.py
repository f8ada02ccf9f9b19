"""The f32 GEMM building block of the port (``csrc/gemm_f32.cuh``, and its
TF32 instance ``csrc/gemm_tf32.cuh``), through its private entry
``aecf_tpu_torch.kernels._gemm``.

On the CPU only the plain version runs: it is held to numpy in float64
(atol 1e-5; f32 sums of at most 300 terms of size ~1) at ragged shapes
that are not multiples of the GEMM's tiles (128 rows, 64 or 128 columns,
k-depth 16), in both A layouts and both W layouts, with groups, a bias and
a scale, and at shapes the card splits over K (few tiles, long K).  The
wrapper launches on CUDA tensors or raises; ``chip_smoke.py`` holds the
kernel to the plain version on the card.
"""

import numpy as np
import pytest
import torch

from aecf_tpu_torch.kernels import _build
from aecf_tpu_torch.kernels._gemm import gemm_f32, gemm_f32_plain

# (G, rows, N, K): ragged in every axis; the last two split over K on the
# card (one or two column tiles, K of 300).
SHAPES = [(1, 130, 37, 45), (3, 7, 68, 20), (1, 1, 70, 300), (2, 5, 14, 300)]


def _operands(rng, G, rows, N, K, a_trans, w_kmajor):
    a = rng.standard_normal((G, K, rows) if a_trans else (G, rows, K))
    w = rng.standard_normal((G, K, N) if w_kmajor else (G, N, K))
    return a.astype(np.float32), w.astype(np.float32)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("w_kmajor", [True, False])
@pytest.mark.parametrize("a_trans", [False, True])
@pytest.mark.parametrize("G,rows,N,K", SHAPES)
def test_plain_matches_numpy(G, rows, N, K, a_trans, w_kmajor, bias):
    rng = np.random.default_rng(G * 1000 + rows + N + K)
    a, w = _operands(rng, G, rows, N, K, a_trans, w_kmajor)
    b = rng.standard_normal((G, N)).astype(np.float32) if bias else None
    got = gemm_f32_plain(
        torch.from_numpy(a), torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), scale=0.5,
        a_trans=a_trans, w_kmajor=w_kmajor,
    )
    A, W = a.astype(np.float64), w.astype(np.float64)
    A = A.transpose(0, 2, 1) if a_trans else A
    W = W if w_kmajor else W.transpose(0, 2, 1)
    want = 0.5 * (A @ W)
    if b is not None:
        want = want + b[:, None, :]
    assert tuple(got.shape) == (G, rows, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_plain_reads_strided_views_in_place():
    """A transposed view and a per-head slice (the chains' operands) give
    the products of their dense copies."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((6, 2, 12)).astype(np.float32))
    wv = torch.from_numpy(rng.standard_normal((2, 8, 12)).astype(np.float32))
    heads = x.permute(1, 0, 2)  # (G=2, rows=6, K=12), strides (12, 24, 1)
    got = gemm_f32_plain(heads, wv, w_kmajor=False)
    want = gemm_f32_plain(heads.contiguous(), wv.transpose(1, 2).contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize(
    "case,exc,match",
    [
        ("cpu", ValueError, "no kernel for device cpu"),
        ("float64", TypeError, "float32"),
        ("2-d", ValueError, r"\(G, \., \.\)"),
        ("k mismatch", ValueError, "do not chain"),
        ("layouts", ValueError, "k-major w"),
        ("bias shape", ValueError, r"bias must be \(1, 4\)"),
    ],
)
def test_wrapper_launches_or_raises(case, exc, match):
    a = torch.zeros(1, 8, 16)
    w = torch.zeros(1, 16, 4)
    kw = {}
    if case == "float64":
        a = a.double()
    elif case == "2-d":
        a = a[0]
    elif case == "k mismatch":
        w = torch.zeros(1, 12, 4)
    elif case == "bias shape":
        kw["bias"] = torch.zeros(1, 5)
    elif case == "layouts":
        a = a.transpose(1, 2)
        w = w.transpose(1, 2)
        kw.update(a_trans=True, w_kmajor=False)
    before = gemm_f32.launches
    with pytest.raises(exc, match=match):
        gemm_f32(a, w, **kw)
    assert gemm_f32.launches == before  # the CPU never launches


@pytest.mark.parametrize("operand", ["a", "w"])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_wrapper_checks_group_strides_before_the_device(operand, precision):
    """An operand that repeats one matrix over its groups (group stride 0,
    an expanded tensor) is refused at 'default' before any device check —
    the TF32 instance's tensor maps step groups by a nonzero stride — and
    reaches the device check at 'highest'."""
    a = torch.zeros(2, 8, 16)
    w = torch.zeros(2, 16, 4)
    if operand == "a":
        a = torch.zeros(1, 8, 16).expand(2, 8, 16)
    else:
        w = torch.zeros(1, 16, 4).expand(2, 16, 4)
    match = ("group stride 0" if precision == "default"
             else "no kernel for device cpu")
    before = gemm_f32.launches
    with pytest.raises(ValueError, match=match):
        gemm_f32(a, w, precision=precision)
    assert gemm_f32.launches == before


@pytest.mark.parametrize("mode,bn", [
    ("in_place", 64), ("transpose", 64), ("transpose", 128), ("ready", 64),
    ("ready", 128)])
def test_tf32_ring_fits_the_chains_count(mode, bn):
    """Each ring of the TF32 instance, as ``csrc/gemm_tf32.cuh`` builds it
    (its stage rule and byte count read there: 1024 bytes of alignment,
    128 x 32 floats of A and bn x 32 of W a stage, a transposed W's double
    buffer, a barrier a stage), fits the count the step's wrapper checks
    (``_GEMM_SMEM``, the SIMT ring), so the chains' shared-memory counts
    hold at 'default'."""
    import importlib
    import re

    ts_mod = importlib.import_module("aecf_tpu_torch.kernels.train_step")
    src = (_build._CSRC / "gemm_tf32.cuh").read_text()
    rule = re.search(
        r"return M == kWTranspose \? \(BN == 64 \? (\d+) : (\d+)\)\s*"
        r": \(BN == 64 \? (\d+) : (\d+)\);", src)
    assert rule, "tc::stages' rule not found"
    t64, t128, o64, o128 = map(int, rule.groups())
    stages = {("transpose", 64): t64, ("transpose", 128): t128,
              ("in_place", 64): o64, ("ready", 64): o64,
              ("ready", 128): o128}[(mode, bn)]
    assert re.search(
        r"return 1024 \+ \(size_t\)stages<BN, M>\(\) \* \(kABytes \+ "
        r"w_bytes<BN>\(\)\) \+\s*\(M == kWTranspose \? 2 \* w_bytes<BN>\(\) "
        r": 0\) \+ 8 \* stages<BN, M>\(\);", src)
    w = 4 * bn * 32
    ring = (1024 + stages * (4 * 128 * 32 + w)
            + (2 * w if mode == "transpose" else 0) + 8 * stages)
    assert ring <= ts_mod._GEMM_SMEM


# Each shared header and the sources that include it: the GEMM building
# block (its SIMT and TF32 instances), the chains' row kernels and
# part_sum (pool_rows.cuh), and the streamed kernels' staging
# (stream_stage.cuh).
INCLUDERS = {
    "gemm_f32.cuh": ("fused_pool_fwd", "shared_query_bwd", "shared_query_fwd",
                     "train_step"),
    "gemm_tf32.cuh": ("shared_query_bwd", "shared_query_fwd", "train_step"),
    "pool_rows.cuh": ("shared_query_bwd", "shared_query_fwd", "stream_bwd",
                      "train_step"),
    "stream_stage.cuh": ("stream_bwd", "stream_mix"),
}


@pytest.mark.parametrize("header,name", [
    (h, n) for h, names in INCLUDERS.items() for n in names
])
def test_header_ships_and_rebuilds_its_users(tmp_path, monkeypatch, header,
                                             name):
    """Every source that includes a shared header is listed in INCLUDERS,
    and an edit to the header moves that source's library to a new build
    directory."""
    import shutil

    assert (_build._CSRC / header).exists()
    includes = sorted(
        f.stem for f in _build._CSRC.glob("*.cu")
        if f'#include "{header}"' in f.read_text()
    )
    assert includes == sorted(INCLUDERS[header])
    for f in _build._CSRC.iterdir():
        shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    before = _build.library_path(name)
    edited = tmp_path / header
    edited.write_text(edited.read_text() + "\n// edited\n")
    assert _build.library_path(name) != before
