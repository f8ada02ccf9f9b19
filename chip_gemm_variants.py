"""Where the TF32 GEMM instance's time goes, on the card.

Builds variants of ``aecf_tpu_torch/kernels/csrc/gemm_tf32.cuh`` side by
side (each a copy of ``csrc/`` under the git-ignored ``build/variants/``
with one edit, compiled into its own ``train_step`` library with the
port's flags), then times ``kernels._gemm.gemm_f32(precision='default')``
through each at ``chip_smoke.GEMM_SHAPES`` (device time a call from
``torch.profiler``, every kernel the call launches; two turns, the second
in reverse order), beside one ``torch.matmul`` under TF32 (cuBLAS):

* ``kernel``: the instance as built;
* ``rewrite``: W rounded in every block, never once a call;
* ``once4``: W rounded once a call from 4 row tiles (the north star's G);
* ``no-w-round``, ``no-a-loads``, ``no-wgmma``: one part of a stage's
  work left out (their results are wrong: they measure cost);
* ``stream-only``: the three left out — TMA's operand stream, the
  barriers and the epilogue alone.

Then the host's cost of a TF32 launch, where the host sets the pace:
µs a call of the GEMM alone at one block (1 x 32 x 512, K=512: no W copy,
so 'default' differs from 'highest' by its two tensor maps and its launch
path) and of the serving-size forward (``shared_query_fwd``, eval, B=32
and 256, M=2, E=512), at both precisions in five alternating windows of
1000 back-to-back calls (host clock, synchronised at each window's ends;
medians).

Run from the repository's root on a machine with the card and ``nvcc``:
``python3 chip_gemm_variants.py``.  It prints one line a variant and
product, and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

_ONCE = "constexpr int kOnceTiles = 8;"
_NO_W = ("    round_w<BN, kW>(slot + kABytes, w_of(j));\n", "")
_NO_A = ("    load_a<kATrans>(slot, warp, gi, ti, af);\n",
         "    for (int s = 0; s < 4; ++s)\n"
         "      for (int e = 0; e < 4; ++e) af[s][e] = j;\n")
_NO_MMA = ("      wgmma<BN>(acc, af[s], kmajor_desc(wk + 32 * s));\n",
           "      acc[s] += __uint_as_float(af[s][0]) + (float)wk;\n")
VARIANTS = {
    "kernel": [],
    "rewrite": [(_ONCE, "constexpr int kOnceTiles = 1 << 30;")],
    "once4": [(_ONCE, "constexpr int kOnceTiles = 4;")],
    "no-w-round": [_NO_W],
    "no-a-loads": [_NO_A],
    "no-wgmma": [_NO_MMA],
    "stream-only": [_NO_W, _NO_A, _NO_MMA],
}


def build(name: str, edits) -> ctypes.CDLL:
    """``train_step.cu`` against a copy of ``csrc/`` with ``edits`` made
    to ``gemm_tf32.cuh``, loaded with ``_gemm``'s argument types."""
    from aecf_tpu_torch.kernels import _build, _gemm

    src = ROOT / "build" / "variants" / name
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build._CSRC, src)
    header = src / "gemm_tf32.cuh"
    text = header.read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant {name}: {old.strip()!r} not found")
        text = text.replace(old, new)
    header.write_text(text)
    lib = src / "libtrain_step.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(src / "train_step.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"variant {name}: nvcc failed\n{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    dll.aecf_gemm_f32_scratch.argtypes = [ctypes.c_int] * 7
    dll.aecf_gemm_f32_scratch.restype = ctypes.c_size_t
    dll.aecf_gemm_f32.argtypes = [ctypes.POINTER(_gemm._GemmCall),
                                  ctypes.c_void_p]
    dll.aecf_gemm_f32.restype = ctypes.c_int
    dll.aecf_cuda_error_string.argtypes = [ctypes.c_int]
    dll.aecf_cuda_error_string.restype = ctypes.c_char_p
    return dll


def host_cost(torch, cs, smi: str) -> None:
    """Host µs a call at 'highest' and 'default' (see the module's doc)."""
    import math
    import statistics
    import time

    import numpy as np

    from aecf_tpu_torch.kernels import _gemm, shared_query_fwd
    from aecf_tpu_torch.kernels.shared_query import _prep

    gen = torch.Generator(device="cuda").manual_seed(29)
    a, w = cs._gemm_operands(torch, gen, 1, 32, 512, 512, False, False)
    calls = {"gemm_f32 1x32x512 K=512": lambda p: _gemm.gemm_f32(
        a, w, w_kmajor=False, precision=p)}
    params = cs._pool_params(torch, np.random.default_rng(29), 512, "cuda")
    query = torch.randn((512,), generator=gen, device="cuda")
    with torch.inference_mode():
        u, c, wvo, bctx, _, _ = _prep(params, query * math.sqrt(2.0 / 512),
                                      1)
    for B in (32, 256):
        kv = torch.randn((B, 2, 512), generator=gen, device="cuda")
        calls[f"shared_query_fwd eval B={B} M=2 E=512"] = (
            lambda p, kv=kv: shared_query_fwd(kv, u, c, None, wvo, bctx,
                                              precision=p))
    with torch.inference_mode():
        for label, call in calls.items():
            us = {"highest": [], "default": []}
            for window in range(5):
                for p in (("highest", "default") if window % 2 == 0
                          else ("default", "highest")):
                    for _ in range(50):
                        call(p)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(1000):
                        call(p)
                    torch.cuda.synchronize()
                    us[p].append((time.perf_counter() - t0) * 1e3)
            med = {p: statistics.median(v) for p, v in us.items()}
            print(f"host {label}: highest {med['highest']:.2f} us a call, "
                  f"default {med['default']:.2f} (default - highest "
                  f"{med['default'] - med['highest']:.2f}); windows "
                  f"{[round(x, 2) for x in us['highest']]} / "
                  f"{[round(x, 2) for x in us['default']]} ({smi})")


def main() -> None:
    import torch

    import chip_smoke as cs
    from aecf_tpu_torch.core import matmul_precision
    from aecf_tpu_torch.kernels import _gemm

    if not torch.cuda.is_available():
        sys.exit("chip_gemm_variants: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS,
                                           VARIANTS.values())))
    gen = torch.Generator(device="cuda").manual_seed(23)
    ops = {}
    for label, G, rows, N, K, a_trans, w_kmajor in cs.GEMM_SHAPES:
        a, w = cs._gemm_operands(torch, gen, G, rows, N, K, a_trans,
                                 w_kmajor)
        ops[label] = (a, w, a_trans, w_kmajor, 2.0 * G * rows * N * K)
    times: dict = {}
    for order in (list(VARIANTS), list(VARIANTS)[::-1]):
        for name in order:
            _gemm._library = (lambda lib: lambda: lib)(libs[name])
            for label, (a, w, at, wk, _) in ops.items():
                call = (lambda a=a, w=w, at=at, wk=wk: _gemm.gemm_f32(
                    a, w, a_trans=at, w_kmajor=wk, precision="default"))
                times.setdefault((name, label), []).append(
                    float(cs._device_ms(torch, call, "", calls=100)))
    for label, (a, w, at, wk, flops) in ops.items():
        A = a.transpose(1, 2) if at else a
        W = w if wk else w.transpose(1, 2)

        def lib(A=A, W=W):
            with matmul_precision("default"):
                return torch.matmul(A, W)
        ref = cs._device_ms(torch, lib, "", calls=100)
        for name in VARIANTS:
            t1, t2 = times[(name, label)]
            print(f"variant {name} {label}: device {t1:.5f} / {t2:.5f} ms "
                  f"({flops / min(t1, t2) / 1e9:.1f} TFLOP/s), cuBLAS TF32 "
                  f"{ref} ms (torch.profiler, 100 calls a turn; {smi})")
    _gemm._library = lambda: libs["kernel"]
    host_cost(torch, cs, smi)


if __name__ == "__main__":
    main()
