#!/usr/bin/env python3
"""GPU smoke check of the PyTorch + CUDA port (``aecf_tpu_torch``).

Run from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (any failure raises and the exit code is not 0):

1. no CUDA device: stop before printing any result;
2. the card (name, power limit) and the build of every CUDA kernel from
   the sources in this checkout, with the build time;
3. each kernel against its plain PyTorch version on the card, at the
   shapes its callers give it, with the tolerances stated below;
4. the serving slice at full width: ``VisionLanguageModel`` (img 2048 +
   txt 768 → 512 → 1000 classes) with seeded random parameters, behind
   ``FusionPredictor(buckets=(32, 256))`` → ``MicroBatcher`` →
   ``PredictionServer`` on 127.0.0.1, answering npz, JSON, missing-modality,
   ragged and concurrent one-row requests; every answer is held against the
   same parameters run on the CPU through the plain path, and the kernel's
   launch count over the run must cover every bucket call;
5. times (CUDA events) of each kernel and its plain version at the slice
   shapes, and of one predictor call per bucket;
6. a JSON line of the kernels, then the last line
   ``{"ok": true, "device": {...}}``.

float32 matmuls run without TF32 (``allow_tf32 = False`` for both cuBLAS
and cuDNN), so the plain versions are full float32 references.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Tolerances of kernel vs plain version (both full f32; they sum in
# different orders): attention weights and entropy absolutely, the
# context output relative to its largest entry; mask_rate is exact.
TOL_W = 1e-5
TOL_OUT_REL = 2e-5
TOL_OUT_ABS = 1e-5
# Served probabilities vs the CPU plain path.
TOL_PROBS = 1e-5

KERNEL_SHAPES = {
    "B": (1, 32, 256, 300),
    "M": (2, 3, 4),
    "E": (512, 1024),
    "H": (1, 2),
}
BUCKETS = (32, 256)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def require_cuda():
    """Phase 1: the card must be there, and the port must be this
    checkout's."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs on the GPU")
    sys.path.insert(0, str(ROOT))
    import aecf_tpu_torch

    pkg = Path(aecf_tpu_torch.__file__).resolve().parent
    check(pkg == ROOT / "aecf_tpu_torch", f"imported the port from {pkg}")
    check("jax" not in sys.modules, "the port imported jax")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch


def device_report(torch) -> str:
    """Phase 2a: the card's name and power limit."""
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"device: {name} (count {torch.cuda.device_count()})")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          "allow_tf32: matmul=False cudnn=False")
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    return smi


def build_kernels() -> None:
    """Phase 2b: compile every CUDA source of the port."""
    from aecf_tpu_torch.kernels._build import library_path, load_library

    t0 = time.perf_counter()
    load_library("shared_query_fwd")
    print(f"build: shared_query_fwd.cu in {time.perf_counter() - t0:.2f} s "
          f"-> {library_path('shared_query_fwd').relative_to(ROOT)}")
    log = library_path("shared_query_fwd").parent / "shared_query_fwd.build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "ptxas info" in line and ("registers" in line or "spill" in line):
                print(f"  {line.strip()}")


def _pool_params(torch, rng, E, device):
    from aecf_tpu_torch.core import AttentionPoolParams

    bound = math.sqrt(6.0 / (4 * E))
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    return AttentionPoolParams(
        in_proj_weight=t(rng.uniform(-bound, bound, (3 * E, E))),
        out_proj_weight=t(rng.uniform(-E ** -0.5, E ** -0.5, (E, E))),
        in_proj_bias=t(0.1 * rng.standard_normal(3 * E)),
        out_proj_bias=t(0.1 * rng.standard_normal(E)),
    )


def check_kernel_vs_plain(torch, shapes=KERNEL_SHAPES) -> float:
    """Phase 3: ``fused_fusion_pool_shared`` (the kernel) against the
    kernel's plain version on the same CUDA tensors.  Returns the largest
    absolute error over every output."""
    from aecf_tpu_torch.kernels import (
        fused_fusion_pool_shared,
        shared_query_fwd_plain,
    )
    from aecf_tpu_torch.kernels.shared_query import _pad_bias_rows, _prep

    rng = np.random.default_rng(1)
    worst = 0.0
    cases = 0
    for E in shapes["E"]:
        for H in shapes["H"]:
            params = _pool_params(torch, rng, E, "cuda")
            query = torch.tensor(
                math.sqrt(2.0 / E) * rng.standard_normal((1, 1, E)),
                dtype=torch.float32, device="cuda",
            )
            for dtype in (torch.float32, torch.bfloat16):
                for padded in (False, True):
                    errs = {"out": 0.0, "w": 0.0, "mw": 0.0, "ent": 0.0}
                    for B in shapes["B"]:
                        for M in shapes["M"]:
                            kv = torch.tensor(
                                rng.standard_normal((B, M, E)),
                                dtype=torch.float32, device="cuda",
                            ).to(dtype)
                            kpm = None
                            if padded:
                                mask = rng.random((B, M)) < 0.3
                                mask[0, :] = True  # one fully padded row
                                kpm = torch.tensor(mask, device="cuda")
                            with torch.inference_mode():
                                out, w, mw, info = fused_fusion_pool_shared(
                                    params, query, kv, num_heads=H,
                                    key_padding_mask=kpm,
                                )
                                u, c, wctx, bctx, wo, bo = _prep(
                                    params, query[0, 0], H
                                )
                                ref = shared_query_fwd_plain(
                                    kv, u, c, _pad_bias_rows(kpm), wctx,
                                    bctx, wo, bo,
                                )
                            torch.cuda.synchronize()
                            got = {
                                "out": out[:, 0], "w": w[:, 0],
                                "mw": mw[:, 0], "ent": info["entropy"][:, 0],
                            }
                            want = dict(zip(("out", "w", "mw", "ent"), ref[:4]))
                            for k in got:
                                check(
                                    tuple(got[k].shape) == tuple(want[k].shape)
                                    and bool(torch.isfinite(got[k]).all()),
                                    f"{k} shape/finite at B={B} M={M} E={E} H={H}",
                                )
                                err = (got[k] - want[k]).abs().max().item()
                                errs[k] = max(errs[k], err)
                                tol = (
                                    TOL_OUT_REL * want[k].abs().max().item()
                                    + TOL_OUT_ABS
                                    if k == "out" else TOL_W
                                )
                                check(
                                    err <= tol,
                                    f"{k} error {err:.3e} > {tol:.3e} at "
                                    f"B={B} M={M} E={E} H={H} {dtype} "
                                    f"padded={padded}",
                                )
                            check(
                                bool((info["mask_rate"] == 0).all()),
                                "mask_rate is not exactly 0",
                            )
                            cases += 1
                    worst = max(worst, *errs.values())
                    print(
                        f"kernel vs plain E={E} H={H} kv={str(dtype)[6:]} "
                        f"padded={padded} B={shapes['B']} M={shapes['M']}: "
                        + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
                    )
    print(f"kernel vs plain: {cases} cases within tolerance "
          f"(w/mw/ent {TOL_W:g} abs, out {TOL_OUT_REL:g}*max|out|"
          f"+{TOL_OUT_ABS:g}, rate exactly 0); max abs err {worst:.3e}")
    return worst


def _model_params(model, rng):
    """Seeded numpy parameters for every entry of ``model.state_dict()``:
    the fusion query from N(0, √(2/E)), the rest uniform ±1/√n with n the
    entry's last dimension."""
    flat = {}
    for key, value in model.state_dict().items():
        shape = tuple(value.shape)
        if key == "fusion_query":
            a = math.sqrt(2.0 / shape[-1]) * rng.standard_normal(shape)
        else:
            bound = 1.0 / math.sqrt(shape[-1])
            a = rng.uniform(-bound, bound, shape)
        flat[key] = a.astype(np.float32)
    return flat


def serve_slice(torch) -> dict:
    """Phase 4: the serving path at full width, through the HTTP front
    end, against the CPU plain path.  Returns the predictors and counts."""
    from aecf_tpu_torch.convert import params_from_numpy
    from aecf_tpu_torch.kernels import shared_query_fwd
    from aecf_tpu_torch.models import VisionLanguageModel
    from aecf_tpu_torch.serve import FusionPredictor, MicroBatcher
    from aecf_tpu_torch.serving_http import PredictionServer, predict_remote

    cpu_model = VisionLanguageModel().eval()
    flat = _model_params(cpu_model, np.random.default_rng(2))
    params_from_numpy(cpu_model, flat)
    gpu_model = params_from_numpy(VisionLanguageModel(device="cuda"), flat).eval()

    def predictor(model, device):
        return FusionPredictor(
            lambda image, text: model(image, text),
            modality_names=("image", "text"), buckets=BUCKETS, device=device,
        )

    gpu_pred = predictor(gpu_model, "cuda")
    cpu_pred = predictor(cpu_model, "cpu")

    rng = np.random.default_rng(3)
    feats = lambda n: (  # noqa: E731
        rng.standard_normal((n, 2048)).astype(np.float32),
        rng.standard_normal((n, 768)).astype(np.float32),
    )
    img4, txt4 = feats(4)
    img300, txt300 = feats(300)
    img16, txt16 = feats(16)

    def agree(name, got, want):
        check(got.shape == want.shape, f"{name}: shape {got.shape} != {want.shape}")
        check(bool(np.isfinite(got).all()), f"{name}: non-finite probabilities")
        err = float(np.abs(got - want).max())
        check(err <= TOL_PROBS, f"{name}: max |probs - cpu| {err:.3e} > {TOL_PROBS:g}")
        print(f"served {name}: {got.shape[0]} rows, max |probs - cpu plain| {err:.3e}")

    shared_query_fwd.launches = 0
    gpu_pred.calls = 0
    batcher = MicroBatcher(gpu_pred, max_batch=256, max_wait_ms=3.0)
    server = PredictionServer(batcher, host="127.0.0.1", port=0).start()
    url = f"http://127.0.0.1:{server.port}"
    try:
        got = {
            "npz 4 rows": predict_remote(url, image=img4, text=txt4),
            "json 4 rows": predict_remote(url, binary=False, image=img4, text=txt4),
            "image only": predict_remote(url, image=img4),
            "ragged 300 rows": predict_remote(url, image=img300, text=txt300),
        }
        singles = [None] * 16

        def one(i):
            singles[i] = predict_remote(
                url, image=img16[i : i + 1], text=txt16[i : i + 1]
            )

        threads = [threading.Thread(target=one, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        check(all(s is not None for s in singles), "a one-row request got no answer")
        got["16 concurrent one-row"] = np.concatenate(singles)
    finally:
        server.stop()
        batcher.stop()
    launches, calls = shared_query_fwd.launches, gpu_pred.calls

    want = {
        "npz 4 rows": cpu_pred(image=img4, text=txt4),
        "json 4 rows": cpu_pred(image=img4, text=txt4),
        "image only": cpu_pred(image=img4),
        "ragged 300 rows": cpu_pred(image=img300, text=txt300),
        "16 concurrent one-row": cpu_pred(image=img16, text=txt16),
    }
    for name in got:
        agree(name, got[name], want[name])
    print(f"slice: {calls} bucket calls on the card, shared_query_fwd "
          f"launches {launches}")
    check(calls > 0 and launches >= calls,
          f"kernel launches {launches} < bucket calls {calls}")
    return {"launches": launches, "calls": calls, "gpu_pred": gpu_pred}


def cuda_ms(torch, fn, iters=200, warmup=20) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_kernels(torch, smi: str, gpu_pred) -> dict:
    """Phase 5: kernel vs plain version at the slice shapes (turns: plain,
    kernel, kernel, plain), then one predictor call per bucket."""
    from aecf_tpu_torch.kernels import shared_query_fwd, shared_query_fwd_plain
    from aecf_tpu_torch.kernels.shared_query import _prep

    rng = np.random.default_rng(4)
    E, M, H = 512, 2, 1
    params = _pool_params(torch, rng, E, "cuda")
    query = torch.tensor(
        rng.standard_normal((1, 1, E)) * math.sqrt(2.0 / E),
        dtype=torch.float32, device="cuda",
    )
    times = {}
    with torch.inference_mode():
        u, c, wctx, bctx, wo, bo = _prep(params, query[0, 0], H)
        for B in BUCKETS:
            kv = torch.tensor(
                rng.standard_normal((B, M, E)), dtype=torch.float32,
                device="cuda",
            )
            args = (kv, u, c, None, wctx, bctx, wo, bo)
            kernel = lambda: shared_query_fwd(*args)  # noqa: E731
            plain = lambda: shared_query_fwd_plain(*args)  # noqa: E731
            p1, k1, k2, p2 = (cuda_ms(torch, f) for f in (plain, kernel, kernel, plain))
            k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
            times[B] = (k_ms, p_ms)
            print(f"time shared_query_fwd B={B} M={M} E={E} H={H} f32: kernel "
                  f"{k1:.5f}/{k2:.5f} ms, plain {p1:.5f}/{p2:.5f} ms "
                  f"(mean {k_ms:.5f} vs {p_ms:.5f}; {smi})")

    feats = np.random.default_rng(5)
    for b in BUCKETS:
        img = feats.standard_normal((b, 2048)).astype(np.float32)
        txt = feats.standard_normal((b, 768)).astype(np.float32)
        for _ in range(3):
            gpu_pred(image=img, text=txt)
        samples = []
        for _ in range(20):
            t0 = time.perf_counter()
            gpu_pred(image=img, text=txt)
            samples.append((time.perf_counter() - t0) * 1e3)
        print(f"time FusionPredictor bucket {b}: median "
              f"{float(np.median(samples)):.4f} ms, min {min(samples):.4f} ms "
              f"over 20 calls (host clock, H2D + model + D2H; {smi})")
    return times


def main() -> None:
    torch = require_cuda()
    smi = device_report(torch)
    build_kernels()
    max_err = check_kernel_vs_plain(torch)
    served = serve_slice(torch)
    times = time_kernels(torch, smi, served["gpu_pred"])
    k_ms, p_ms = times[BUCKETS[-1]]
    print(json.dumps({"kernels": [{
        "name": "shared_query_fwd",
        "route": "cuda",
        "source": "aecf_tpu_torch/kernels/csrc/shared_query_fwd.cu",
        "replaces": "aecf_tpu/kernels/shared_query.py:508",
        "launches": served["launches"],
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
