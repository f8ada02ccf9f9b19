"""The port's ``fit(mesh=)``, ``FusionPredictor(mesh=)``, distributed
start-up and dry run.

The port runs on two gloo processes on the CPU (``torch_parallel_workers``,
spawned once for the module's main case); JAX runs in this process on the
conftest's 8-virtual-device mesh.  The counterparts of
``tests/test_fit.py::test_dp_fit_resume_matches_uninterrupted`` and
``::test_dp_fit_scan_chunk_matches_single_step`` (atol 1e-6),
``tests/test_serve.py::TestShardedPredictor``,
``tests/test_parallel.py::test_maybe_initialize_distributed_error_handling``
and ``tests/test_multihost.py`` (two processes started from torchrun's
environment), plus DP ``fit`` against JAX's (``training=False``, SGD:
loss rtol 5e-5, parameters atol 1e-5), the one-pass pool step and chunk
through ``fit(mesh=)`` and ``parallel.dryrun.dryrun_multichip(2)``.
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from aecf_tpu.models import VisionLanguageModel as JaxVLM
from aecf_tpu.models import XrayAECFModel as JaxXray
from aecf_tpu.parallel import data_mesh
from aecf_tpu.train import fit as jax_fit
from aecf_tpu.train import init_pool_classifier_params as jax_init
from aecf_tpu_torch import parallel
from aecf_tpu_torch.convert import _dotted
from aecf_tpu_torch.parallel.dryrun import dryrun_multichip
from torch_parallel_workers import ROOT, run_ranks

WORLD = 2
XRAY = dict(image_dim=16, text_dim=16, hidden_dim=8, num_classes=4)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _data():
    rs = np.random.default_rng(0)
    return {
        "fit_image": rs.normal(size=(64, 16)).astype(np.float32),
        "fit_text": rs.normal(size=(64, 16)).astype(np.float32),
        "fit_label": (rs.random((64, 4)) < 0.3).astype(np.float32),
    }


def _batch_fn(data):
    def batch_fn(step):
        sel = np.random.default_rng(step).integers(0, 64, size=16)
        return (data["fit_image"][sel], data["fit_text"][sel],
                data["fit_label"][sel])

    return batch_fn


def _inputs():
    inputs = _data()
    rs = np.random.default_rng(1)
    inputs["kv"] = rs.normal(size=(16, 2, 16)).astype(np.float32)
    inputs["labels"] = (rs.random((16, 4)) < 0.3).astype(np.float32)
    inputs["serve_img"] = rs.normal(size=(70, 32)).astype(np.float32)
    inputs["serve_txt"] = rs.normal(size=(70, 16)).astype(np.float32)
    for tag, params in (
            ("xray", JaxXray(**XRAY).init(jax.random.key(0))),
            ("pool", jax_init(jax.random.key(2), 16, 4)),
            ("vlm", JaxVLM(img_dim=32, txt_dim=16, hidden_dim=8,
                           num_classes=5).init(jax.random.key(0)))):
        inputs.update({f"{tag}:{k}": v for k, v in _flat(params).items()})
    return inputs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inputs = _inputs()
    return inputs, run_ranks("fit", WORLD, tmp_path_factory.mktemp("fit"),
                             inputs)


def _port(out, tag):
    prefix = f"{tag}:p:"
    return {k[len(prefix):]: v for k, v in out.items()
            if k.startswith(prefix)}


def test_dp_fit_resume_matches_uninterrupted(ranks):
    _, outs = ranks
    for out in outs:
        assert list(out["fit:steps"]) == [8, 4, 8]
        full = _port(out, "fit-full")
        for k, v in _port(out, "fit-resumed").items():
            np.testing.assert_allclose(v, full[k], atol=1e-6, err_msg=k)


def test_dp_fit_scan_chunk_matches_single_step(ranks):
    _, outs = ranks
    for out in outs:
        single = _port(out, "fit-single6")
        for k, v in _port(out, "fit-chunk6").items():
            np.testing.assert_allclose(v, single[k], atol=1e-6, err_msg=k)
    for k, v in _port(outs[0], "fit-full").items():  # the ranks agree
        np.testing.assert_array_equal(v, _port(outs[1], "fit-full")[k])


def test_dp_fit_matches_jax(ranks):
    inputs, outs = ranks
    model = JaxXray(**XRAY)

    def apply_fn(p, images, texts, rng):
        return model.apply(p, images, texts, training=False), {}

    state, history = jax_fit(
        apply_fn, optax.sgd(0.1), model.init(jax.random.key(0)),
        _batch_fn(inputs), num_steps=4, rng=jax.random.key(1),
        mesh=data_mesh(8), log_every=1)
    np.testing.assert_allclose(outs[0]["jaxfit:loss"], history["loss"],
                               rtol=5e-5)
    port = _port(outs[0], "jaxfit")
    for k, v in _flat(state.params).items():
        np.testing.assert_allclose(port[_dotted(k)], v, atol=1e-5, err_msg=k)


def test_dp_fit_pool_steps_resume_and_chunk(ranks):
    """The one-pass pool step and chunk with ``mesh=`` through ``fit``:
    stopped at 5 and resumed (chunks of 3, misaligned), and chunked, each
    equal to the unchunked uninterrupted run bit for bit."""
    _, outs = ranks
    for out in outs:
        assert int(out["pool-first:step"]) == 5
        full = _port(out, "pool-full")
        for tag in ("pool-resumed", "pool-chunk"):
            assert int(out[f"{tag}:step"]) == 8
            for k, v in _port(out, tag).items():
                np.testing.assert_array_equal(v, full[k], err_msg=(tag, k))


@pytest.mark.parametrize("request_kind", ["ragged", "chunked", "missing"])
def test_sharded_predictor_matches_single(ranks, request_kind):
    _, outs = ranks
    for out in outs:
        np.testing.assert_allclose(out[f"serve-{request_kind}:sharded"],
                                   out[f"serve-{request_kind}:single"],
                                   atol=1e-6)
    assert list(outs[0]["serve:calls"]) == [7, 7]
    assert list(outs[0]["serve:staged"]) == [0, 0]


def test_sharded_predictor_rejects_indivisible_buckets(ranks):
    _, outs = ranks
    msg = str(outs[0]["serve:error"])
    assert "not divisible" in msg and "[3]" in msg


def test_maybe_initialize_distributed_error_handling(monkeypatch):
    """Re-initialization is tolerated; a store failure raises — swallowing
    it would leave every rank training alone."""
    calls = []

    def record(backend, **kw):
        calls.append(backend)

    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.setattr(torch.distributed, "init_process_group", record)
    parallel.maybe_initialize_distributed()  # not launched: a no-op
    assert calls == []
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    parallel.maybe_initialize_distributed(device_type="cpu")
    parallel.maybe_initialize_distributed()
    assert calls == ["gloo", "nccl"]

    def reinit(backend, **kw):
        raise ValueError("trying to initialize the default process group "
                         "twice!")

    monkeypatch.setattr(torch.distributed, "init_process_group", reinit)
    parallel.maybe_initialize_distributed(device_type="cpu")  # tolerated

    def unreachable(backend, **kw):
        raise RuntimeError("DistStoreError: timed out after 3s")

    monkeypatch.setattr(torch.distributed, "init_process_group", unreachable)
    with pytest.raises(RuntimeError, match="timed out"):
        parallel.maybe_initialize_distributed(device_type="cpu")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_unreachable_store_raises():
    """A real unreachable store: rank 1 of 2 with nobody listening."""
    code = (
        "import datetime\n"
        "from aecf_tpu_torch.parallel import maybe_initialize_distributed\n"
        "maybe_initialize_distributed(device_type='cpu', "
        "timeout=datetime.timedelta(seconds=3))\n"
    )
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2", RANK="1",
               PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "Error" in proc.stderr


def test_two_process_env_start(tmp_path):
    """Two processes from torchrun's environment: a mesh over both, a global
    sum of their shards, and one DP pool step equal on both ranks."""
    port = _free_port()
    inputs = _inputs()

    def env(rank):
        return {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                "WORLD_SIZE": "2", "RANK": str(rank)}

    outs = run_ranks("env", 2, tmp_path, inputs, env=env)
    for out in outs:
        assert float(out["total"]) == 120.0
        assert np.isfinite(out["loss"]) and out["loss"] == outs[0]["loss"]
    for k in (k for k in outs[0] if k.startswith("env:p:")):
        np.testing.assert_array_equal(outs[1][k], outs[0][k])


def test_dryrun_multichip_two_ranks(capsys):
    dryrun_multichip(2)
    assert "dp x tp ok" in capsys.readouterr().out
