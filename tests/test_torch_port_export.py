"""The port's frozen serving artifacts against its live predictor and the
JAX package's artifacts.

``aecf_tpu_torch.serve.export_predictor`` traces each bucket with
``torch.export``; the eval-forward kernels are the custom ops
``aecf_tpu_torch::shared_query_fwd``, ``::stream_mix`` and
``::fused_pool_fwd``, whose CPU implementation is the plain version.
Tolerances: frozen against live 1e-6 (the same ops on the same inputs),
against JAX's frozen artifact 1e-5 (``test_predictor_matches_jax``'s).
"""

import json
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from aecf_tpu.models import VisionLanguageModel as JaxVLM
from aecf_tpu.serve import FusionPredictor as JaxPredictor
from aecf_tpu.serve import export_predictor as jax_export_predictor
from aecf_tpu.serve import load_exported_predictor as jax_load_exported
from aecf_tpu_torch.convert import params_from_numpy
from aecf_tpu_torch.core.init import init_attention_pool_params
from aecf_tpu_torch.kernels import fused_pool, quantize_features
from aecf_tpu_torch.kernels import shared_query
from aecf_tpu_torch.models import VisionLanguageModel
from aecf_tpu_torch.ops import fusion_pool
from aecf_tpu_torch.serve import (
    ExportedFusionPredictor,
    FusionPredictor,
    MicroBatcher,
    export_predictor,
    load_exported_predictor,
)
from aecf_tpu_torch.serving_http import PredictionServer, predict_remote

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(img_dim=32, txt_dim=16, hidden_dim=8, num_classes=5)
BUCKETS = (8, 32)
NAMES = ("image", "text")


def _flat(params):
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _port_predictor(tm):
    return FusionPredictor(lambda image, text: tm(image, text),
                           modality_names=NAMES, buckets=BUCKETS,
                           device="cpu")


def _feats(rng, n):
    return (rng.standard_normal((n, 32)).astype(np.float32),
            rng.standard_normal((n, 16)).astype(np.float32))


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The JAX model's parameters in both packages, a live port predictor
    (dims seeded), and its frozen artifact, loaded."""
    jm = JaxVLM(**SMALL)
    jparams = jm.init(jax.random.key(0))
    tm = params_from_numpy(VisionLanguageModel(**SMALL, device="cpu"),
                           _flat(jparams)).eval()
    live = _port_predictor(tm)
    live(**dict(zip(NAMES, _feats(np.random.default_rng(9), 2))))
    path = str(tmp_path_factory.mktemp("export") / "frozen.npz")
    export_predictor(live, path)
    return dict(jm=jm, jparams=jparams, tm=tm, live=live, path=path,
                frozen=load_exported_predictor(path))


def test_export_roundtrip(small):
    live, frozen = small["live"], small["frozen"]
    assert isinstance(frozen, ExportedFusionPredictor)
    rng = np.random.default_rng(1)
    img, txt = _feats(rng, 5)
    np.testing.assert_allclose(frozen(image=img, text=txt),
                               live(image=img, text=txt), atol=1e-6)
    # a missing modality with no warm call: the dims are the artifact's
    fresh = load_exported_predictor(small["path"])
    np.testing.assert_allclose(fresh(image=img), live(image=img), atol=1e-6)
    assert fresh.calls == 1
    # chunked across the largest bucket: 32 + 32 + 6 → 8
    img, txt = _feats(rng, 70)
    np.testing.assert_allclose(fresh(image=img, text=txt),
                               live(image=img, text=txt), atol=1e-6)
    assert fresh.calls == 4


@pytest.fixture(scope="module")
def jax_frozen(small, tmp_path_factory):
    """JAX's frozen artifact of the same parameters, loaded."""
    jm = small["jm"]
    jax_pred = JaxPredictor(
        lambda p, image, text: jm.apply(p, image, text, training=False),
        small["jparams"], modality_names=NAMES, buckets=BUCKETS,
    )
    path = str(tmp_path_factory.mktemp("jax_export") / "frozen.npz")
    jax_export_predictor(jax_pred, path,
                         feature_dims={"image": 32, "text": 16})
    return jax_load_exported(path)


@pytest.mark.parametrize("rows,mods", [(5, NAMES), (70, NAMES), (6, ("image",))],
                         ids=["ragged", "chunked", "text-missing"])
def test_frozen_matches_jax_artifact(small, jax_frozen, rows, mods):
    img, txt = _feats(np.random.default_rng(rows), rows)
    req = {k: v for k, v in zip(NAMES, (img, txt)) if k in mods}
    np.testing.assert_allclose(small["frozen"](**req), jax_frozen(**req),
                               atol=1e-5)


def test_reexport_of_frozen_predictor_fails_loud(small, tmp_path):
    with pytest.raises(TypeError, match="re-export"):
        export_predictor(small["frozen"], str(tmp_path / "again.npz"))


def test_export_requires_dims(small, tmp_path):
    fresh = _port_predictor(small["tm"])
    with pytest.raises(ValueError, match="feature dims"):
        export_predictor(fresh, str(tmp_path / "x.npz"))
    # explicit dims work without a warm call
    export_predictor(fresh, str(tmp_path / "x.npz"),
                     feature_dims={"image": 32, "text": 16})
    img, txt = _feats(np.random.default_rng(3), 3)
    np.testing.assert_allclose(
        load_exported_predictor(str(tmp_path / "x.npz"))(image=img, text=txt),
        small["live"](image=img, text=txt), atol=1e-6)


def test_truncated_artifact_fails_loud(small, tmp_path):
    with np.load(small["path"]) as data:
        arrays = {k: data[k] for k in data.files}
    del arrays[next(k for k in arrays if k.startswith("bucket_"))]
    trunc = str(tmp_path / "truncated.npz")
    np.savez(trunc, **arrays)
    with pytest.raises(ValueError, match="missing programs"):
        load_exported_predictor(trunc)


def test_non_artifact_npz_fails_loud(tmp_path):
    path = str(tmp_path / "random.npz")
    np.savez(path, foo=np.zeros(3))
    with pytest.raises(ValueError, match="not an export_predictor artifact"):
        load_exported_predictor(path)


def test_cuda_artifact_needs_a_card(small, tmp_path):
    """An artifact traced for CUDA never runs on the CPU: without a card
    it fails at load with a clear error."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with np.load(small["path"]) as data:
        arrays = {k: data[k] for k in data.files}
    config = json.loads(bytes(arrays["config"]).decode())
    assert config["device"] == "cpu"
    config["device"] = "cuda"
    arrays["config"] = np.frombuffer(json.dumps(config).encode(), np.uint8)
    path = str(tmp_path / "cuda.npz")
    np.savez(path, **arrays)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_exported_predictor(path)


def test_suffixless_path(small, tmp_path):
    path = str(tmp_path / "frozen")  # no suffix: normalised to .npz
    export_predictor(small["live"], path)
    assert os.path.exists(path + ".npz")
    img, txt = _feats(np.random.default_rng(4), 4)
    np.testing.assert_allclose(
        load_exported_predictor(path)(image=img, text=txt),
        small["live"](image=img, text=txt), atol=1e-6)


def test_width_mismatch_against_the_artifact(small):
    frozen = load_exported_predictor(small["path"])
    img, txt = _feats(np.random.default_rng(5), 2)
    with pytest.raises(ValueError, match="exported artifact expects 32"):
        frozen(image=img[:, :31], text=txt)
    assert frozen.calls == 0
    frozen(image=img, text=txt)
    assert frozen._dims == {"image": 32, "text": 16}  # never committed


def test_full_stack_frozen_batcher_http(small):
    """frozen artifact → MicroBatcher → HTTP server → remote client, with
    concurrent one-row requests."""
    frozen = load_exported_predictor(small["path"])
    img, txt = _feats(np.random.default_rng(6), 8)
    want = small["live"](image=img, text=txt)
    batcher = MicroBatcher(frozen, max_batch=8, max_wait_ms=50.0)
    server = PredictionServer(batcher, port=0).start()
    url = f"http://127.0.0.1:{server.port}"
    got = [None] * 8

    def one(i):
        got[i] = predict_remote(url, image=img[i : i + 1],
                                text=txt[i : i + 1])

    threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
    try:
        np.testing.assert_allclose(predict_remote(url, image=img, text=txt),
                                   want, atol=1e-6)
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        server.stop()
        batcher.stop()
    assert not any(t.is_alive() for t in threads)
    np.testing.assert_allclose(np.concatenate(got), want, atol=1e-6)


def test_mesh_predictor_exports_the_single_device_program(small, tmp_path):
    """A predictor over a mesh (here one gloo rank) freezes the whole
    bucket's program, with no collective in it."""
    from aecf_tpu_torch.parallel import data_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        pred = FusionPredictor(
            lambda image, text: small["tm"](image, text),
            modality_names=NAMES, buckets=BUCKETS, device="cpu",
            mesh=data_mesh(1, device_type="cpu"),
        )
        img, txt = _feats(np.random.default_rng(7), 5)
        want = pred(image=img, text=txt)
        export_predictor(pred, str(tmp_path / "mesh.npz"))
    finally:
        dist.destroy_process_group()
    frozen = load_exported_predictor(str(tmp_path / "mesh.npz"))
    for program in frozen._programs.values():
        assert not [n for n in program.graph.nodes
                    if "c10d" in str(n.target)]
    np.testing.assert_allclose(frozen(image=img, text=txt), want, atol=1e-6)


# ---- the custom ops ---------------------------------------------------------


def _sq_case(H, q8, padded, training, E=16, B=6, M=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, M, E, generator=g)
    kv, scales = quantize_features(x) if q8 else (x, None)
    pad = None
    if padded:
        pad = torch.where(torch.rand(B, M, generator=g) < 0.3, -1e30, 0.0)
    u = torch.randn(H, E, generator=g)
    c = torch.randn(H, generator=g)
    wctx, bctx = torch.randn(E, E, generator=g), torch.randn(E, generator=g)
    wo = torch.randn(E, E, generator=g) if H > 1 else None
    bo = torch.randn(E, generator=g) if H > 1 else None
    return (kv, u, c, pad, wctx, bctx, wo, bo, scales, training,
            1234567, 3456789012, 0.3, 1)


@pytest.mark.parametrize("H", (1, 2))
@pytest.mark.parametrize("q8", (False, True), ids=("f32", "int8"))
@pytest.mark.parametrize("padded", (False, True), ids=("dense", "padded"))
@pytest.mark.parametrize("training", (False, True), ids=("eval", "train"))
def test_opcheck_shared_query_fwd(H, q8, padded, training):
    torch.library.opcheck(shared_query._shared_query_fwd_op,
                          _sq_case(H, q8, padded, training))


@pytest.mark.parametrize("training", (False, True), ids=("eval", "train"))
def test_opcheck_stream_mix(training):
    kv, u, c, pad, *_, scales, tr, s0, s1, p, k = _sq_case(
        1, False, True, training, E=1056, B=4)
    torch.library.opcheck(shared_query._stream_mix_op,
                          (kv, u, c, pad, scales, tr, s0, s1, p, k))


def _fused_case(expanded, H=2, E=16, B=6, M=3):
    g = torch.Generator().manual_seed(1)
    q = (torch.randn(1, E, generator=g).expand(B, E) if expanded
         else torch.randn(B, E, generator=g))
    kv = torch.randn(B, M, E, generator=g)
    in_w, in_b = torch.randn(3 * E, E, generator=g), torch.randn(3 * E, generator=g)
    out_w, out_b = torch.randn(E, E, generator=g), torch.randn(E, generator=g)
    return q, kv, in_w, in_b, out_w, out_b, H


@pytest.mark.parametrize("expanded", (True, False),
                         ids=("expanded-query", "distinct-rows"))
def test_opcheck_fused_pool_fwd(expanded):
    q, kv, in_w, in_b, out_w, out_b, H = _fused_case(expanded)
    assert (q.stride(0) == 0) == expanded
    torch.library.opcheck(fused_pool._fused_pool_fwd_op,
                          (q, kv, None, in_w, in_b, out_w, out_b, H,
                           not expanded, 5, 6, 0.15, 1))


class _Pool(torch.nn.Module):
    """``fusion_pool(..., implementation='kernel')`` over fixed parameters:
    a ``(1, 1, E)`` query for the shared-query ops, ``(B, 1, E)`` expanded
    for the per-row one."""

    def __init__(self, E, per_row):
        super().__init__()
        g = torch.Generator().manual_seed(2)
        self.pool = init_attention_pool_params(g, E)
        self.query = torch.randn(1, 1, E, generator=g)
        self.per_row = per_row

    def forward(self, kv):
        q = self.query
        if self.per_row:
            q = q.expand(kv.shape[0], 1, kv.shape[2])
        return fusion_pool(self.pool, q, kv, implementation="kernel")[0]


@pytest.mark.parametrize("op,E,per_row", [
    ("shared_query_fwd", 16, False),
    ("stream_mix", 1056, False),
    ("fused_pool_fwd", 16, True),
])
def test_exported_graph_calls_the_op(monkeypatch, op, E, per_row):
    module = _Pool(E, per_row)
    kv = torch.randn(8, 3, E, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        program = torch.export.export(module, (kv,), strict=False)
        live = module(kv)
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert f"aecf_tpu_torch.{op}.default" in targets
    assert not [t for t in targets if "softmax" in t]
    strides = []
    plain = fused_pool.fused_pool_fwd_plain

    def recording(q, *args, **kw):
        strides.append(q.stride(0))
        return plain(q, *args, **kw)

    monkeypatch.setattr(fused_pool, "fused_pool_fwd_plain", recording)
    with torch.inference_mode():
        frozen = program.module()(kv)
    torch.testing.assert_close(frozen, live, rtol=0, atol=0)
    # the expanded query reaches the frozen op with its row stride 0, so
    # the kernel runs the Q and u projections for one row
    assert strides == ([0] if per_row else [])


def test_fresh_process_loads_without_model_code(small, tmp_path):
    img, txt = _feats(np.random.default_rng(8), 5)
    np.savez(tmp_path / "req.npz", image=img, text=txt)
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from aecf_tpu_torch.serve import load_exported_predictor\n"
        f"frozen = load_exported_predictor({small['path']!r})\n"
        f"req = np.load({str(tmp_path / 'req.npz')!r})\n"
        "out = frozen(image=req['image'], text=req['text'])\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, out)\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "ref = [m for m in sys.modules if m.split('.')[0] == 'aecf_tpu']\n"
        "assert not ref, f'imported the JAX package: {ref}'\n"
        "models = [m for m in sys.modules\n"
        "          if m.startswith('aecf_tpu_torch.models')]\n"
        "assert not models, f'imported model code: {models}'\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr
    np.testing.assert_allclose(np.load(tmp_path / "out.npy"),
                               small["frozen"](image=img, text=txt),
                               atol=0)
