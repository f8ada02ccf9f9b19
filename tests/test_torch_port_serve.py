"""The port's serving path against the JAX package's.

JAX parameters are flattened to numpy and loaded with
``aecf_tpu_torch.convert.params_from_numpy``; the same numpy requests go
through both packages' predictors.  Tolerances: full-width logits 1e-4
(f32 GEMMs with K=2048 summed in another order), probabilities 1e-5.
Also: the HTTP front end, micro-batching, that importing the port never
imports JAX, and that ``chip_smoke.py`` fails on a host without a card.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from aecf_tpu.models import VisionLanguageModel as JaxVLM
from aecf_tpu.serve import FusionPredictor as JaxPredictor
from aecf_tpu_torch.convert import params_from_numpy
from aecf_tpu_torch.models import VisionLanguageModel
from aecf_tpu_torch.serve import FusionPredictor, MicroBatcher, pad_to_bucket
from aecf_tpu_torch.serving_http import PredictionServer, predict_remote

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(img_dim=32, txt_dim=16, hidden_dim=8, num_classes=5)


def _flat(params):
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _pair(seed=0, **cfg):
    jm = JaxVLM(**cfg)
    jparams = jm.init(jax.random.key(seed))
    tm = params_from_numpy(VisionLanguageModel(**cfg, device="cpu"),
                           _flat(jparams)).eval()
    return jm, jparams, tm


@pytest.fixture(scope="module")
def small():
    jm, jparams, tm = _pair(**SMALL)
    jax_pred = JaxPredictor(
        lambda p, image, text: jm.apply(p, image, text, training=False),
        jparams, modality_names=("image", "text"), buckets=(8, 32),
    )
    port_pred = FusionPredictor(
        lambda image, text: tm(image, text),
        modality_names=("image", "text"), buckets=(8, 32), device="cpu",
    )
    return jax_pred, port_pred


def test_full_width_logits_match_jax():
    jm, jparams, tm = _pair(seed=1)
    assert (tm.img_dim, tm.txt_dim, tm.hidden_dim, tm.num_classes) == (
        2048, 768, 512, 1000
    )
    rng = np.random.default_rng(0)
    img = rng.standard_normal((8, 2048)).astype(np.float32)
    txt = rng.standard_normal((8, 768)).astype(np.float32)
    want = np.asarray(jm.apply(jparams, img, txt, training=False))
    with torch.inference_mode():
        got = tm(torch.from_numpy(img), torch.from_numpy(txt))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_state_dict_keys_are_jax_paths():
    _, jparams, tm = _pair(**SMALL)
    assert set(tm.state_dict()) == {k.lstrip(".") for k in _flat(jparams)}


def test_params_from_numpy_is_strict():
    _, jparams, tm = _pair(**SMALL)
    flat = _flat(jparams)
    missing = dict(flat)
    missing.pop(".classifier.bias")
    with pytest.raises(RuntimeError, match="classifier.bias"):
        params_from_numpy(tm, missing)
    bad = dict(flat)
    bad[".fusion_query"] = np.zeros((1, 1, 9), np.float32)
    with pytest.raises(RuntimeError, match="fusion_query"):
        params_from_numpy(tm, bad)


@pytest.mark.parametrize(
    "rows,mods",
    [(5, ("image", "text")), (70, ("image", "text")), (6, ("image",)),
     (40, ("text",))],
    ids=["ragged", "chunked", "text-missing", "image-missing"],
)
def test_predictor_matches_jax(small, rows, mods):
    jax_pred, port_pred = small
    rng = np.random.default_rng(rows)
    full = {
        "image": rng.standard_normal((rows, 32)).astype(np.float32),
        "text": rng.standard_normal((rows, 16)).astype(np.float32),
    }
    # every modality's width must be known before one can be left out
    jax_pred(**full)
    port_pred(**full)
    req = {k: full[k] for k in mods}
    np.testing.assert_allclose(port_pred(**req), jax_pred(**req), atol=1e-5)


def test_predictor_validation_and_calls():
    _, _, tm = _pair(**SMALL)
    pred = FusionPredictor(lambda image, text: tm(image, text),
                           modality_names=("image", "text"), buckets=(8, 32),
                           device="cpu")
    img = np.ones((3, 32), np.float32)
    with pytest.raises(ValueError, match="At least one"):
        pred()
    with pytest.raises(ValueError, match="unknown modalities"):
        pred(audio=img)
    with pytest.raises(ValueError, match="batch, features"):
        pred(image=np.ones(32, np.float32))
    with pytest.raises(ValueError, match="batch mismatch"):
        pred(image=img, text=np.ones((4, 16), np.float32))
    with pytest.raises(ValueError, match="at least one row"):
        pred(image=img[:0])
    with pytest.raises(ValueError, match="cannot infer"):
        pred(image=img)
    with pytest.raises(RuntimeError):  # wrong width reaches the model
        pred(image=np.ones((3, 31), np.float32), text=np.ones((3, 16), np.float32))
    assert pred.calls == 0 and pred._dims == {}  # nothing committed
    out = pred(image=np.ones((70, 32), np.float32), text=np.ones((70, 16), np.float32))
    assert out.shape == (70, 5) and pred.calls == 3  # 32 + 32 + 6→8
    assert ((out > 0) & (out < 1)).all()
    with pytest.raises(ValueError, match="previously saw"):
        pred(image=np.ones((1, 33), np.float32))
    assert pad_to_bucket(9, (8, 32)) == 32 and pad_to_bucket(99, (8, 32)) == 32


def test_http_round_trip(small):
    _, port_pred = small
    rng = np.random.default_rng(1)
    img = rng.standard_normal((4, 32)).astype(np.float32)
    txt = rng.standard_normal((4, 16)).astype(np.float32)
    want = port_pred(image=img, text=txt)
    server = PredictionServer(port_pred, port=0).start()
    url = f"http://127.0.0.1:{server.port}"
    try:
        np.testing.assert_allclose(predict_remote(url, image=img, text=txt), want, atol=1e-6)
        np.testing.assert_allclose(
            predict_remote(url, binary=False, image=img, text=txt), want, atol=1e-6
        )
        with urllib.request.urlopen(url + "/healthz", timeout=10) as resp:
            assert json.loads(resp.read())["modalities"] == ["image", "text"]
        req = urllib.request.Request(
            url + "/v1/predict", data=b"[1, 2]",
            headers={"Content-Type": "application/json"},
        )
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=10)
        assert err.value.code == 400
    finally:
        server.stop()


def test_micro_batcher_coalesces_concurrent_requests():
    _, _, tm = _pair(**SMALL)
    pred = FusionPredictor(lambda image, text: tm(image, text),
                           modality_names=("image", "text"), buckets=(8, 32),
                           device="cpu")
    rng = np.random.default_rng(2)
    img = rng.standard_normal((16, 32)).astype(np.float32)
    txt = rng.standard_normal((16, 16)).astype(np.float32)
    want = pred(image=img, text=txt)
    pred.calls = 0
    batcher = MicroBatcher(pred, max_batch=16, max_wait_ms=200.0)
    got = [None] * 16

    def one(i):
        got[i] = batcher(image=img[i : i + 1], text=txt[i : i + 1])

    threads = [threading.Thread(target=one, args=(i,)) for i in range(16)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        batcher.stop()
    assert not any(t.is_alive() for t in threads)
    # other batch compositions: f32 sums in another order
    np.testing.assert_allclose(np.concatenate(got), want, atol=1e-5)
    assert 1 <= pred.calls < 16


def _run(args, cwd, env_extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_importing_the_port_never_imports_jax():
    code = (
        "import sys\n"
        "import aecf_tpu_torch, aecf_tpu_torch.core, aecf_tpu_torch.kernels\n"
        "import aecf_tpu_torch.ops, aecf_tpu_torch.models, aecf_tpu_torch.serve\n"
        "import aecf_tpu_torch.serving_http, aecf_tpu_torch.convert\n"
        "import aecf_tpu_torch.train, aecf_tpu_torch.nn\n"
        "import aecf_tpu_torch.data, aecf_tpu_torch.train.fit\n"
        "import aecf_tpu_torch.train.checkpointing, aecf_tpu_torch.train.metrics\n"
        "import aecf_tpu_torch.train.sweeps, aecf_tpu_torch.train.trainer\n"
        "import aecf_tpu_torch.train.staging\n"
        "import aecf_tpu_torch.measure, aecf_tpu_torch.utils\n"
        "import aecf_tpu_torch.data.loader, aecf_tpu_torch.data.pathology\n"
        "import aecf_tpu_torch.parallel, aecf_tpu_torch.parallel.dryrun\n"
        "import aecf_tpu_torch.parallel.checkpointing\n"
        "import aecf_tpu_torch.tune, aecf_tpu_torch.kernels.tiles\n"
        "from aecf_tpu_torch import create_fusion_pool\n"
        "import torch\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "ref = [m for m in sys.modules if m.split('.')[0] == 'aecf_tpu']\n"
        "assert not ref, f'imported the JAX package: {ref}'\n"
        "assert 'triton' not in sys.modules, 'triton imported'\n"
        "for op in ('shared_query_fwd', 'stream_mix', 'fused_pool_fwd'):\n"
        "    assert getattr(torch.ops.aecf_tpu_torch, op).default, op\n"
        "assert not torch.cuda.is_initialized(), 'CUDA initialised at import'\n"
        "assert not torch.distributed.is_initialized(), 'a process group'\n"
        "print('clean')\n"
    )
    proc = _run(["-c", code], ROOT)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr


def _last_line(text):
    lines = text.strip().splitlines()
    return lines[-1] if lines else ""


def test_chip_smoke_fails_without_a_card(tmp_path):
    """``chip_smoke.py`` must fail, and print no result, on a host with no
    CUDA device, and in a directory holding nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    proc = _run([os.path.join(ROOT, "chip_smoke.py")], ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in _last_line(proc.stdout)
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    proc = _run([str(alone)], tmp_path, {"PYTHONPATH": ""})
    assert proc.returncode != 0
    assert '"ok": true' not in _last_line(proc.stdout)
