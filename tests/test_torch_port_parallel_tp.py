"""The port's tensor-parallel layer against the JAX package's.

The port runs on four gloo processes on the CPU (``torch_parallel_workers``,
spawned once for the module): a pure TP mesh ``('model',)`` of 4 with the
X-ray model at H=4, and a ``('data', 'model')`` mesh of (2, 2) at H=2.  JAX
runs ``make_tp_train_step`` in this process on its (4, 2) virtual-device
mesh from the same numpy inputs (``tests/test_parallel.py::
test_tp_step_matches_single_device``): loss rtol 5e-5, parameters (the
pools gathered whole) atol 1e-5.  Also: each replicated leaf's gradient
equals the unsharded step's (a Megatron "g" whose backward all-reduced
would multiply it by the axis size), the TP chunk bit for bit K sequential
TP steps, ``fit(mesh=)`` resumed equal to the uninterrupted run and
``scan_chunk=3`` to single steps (atol 1e-6), and the TP checkpoint
restoring into an unsharded model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from torch.distributed.tensor import Replicate, Shard

from aecf_tpu.models import XrayAECFModel as JaxXray
from aecf_tpu.parallel import data_model_mesh, make_tp_train_step
from aecf_tpu.parallel import shard_params_tp as jax_shard
from aecf_tpu.train import TrainState as JaxState
from aecf_tpu_torch.convert import _dotted
from aecf_tpu_torch.core.init import init_attention_pool_params
from aecf_tpu_torch.models import XrayAECFModel
from aecf_tpu_torch.parallel import attention_pool_pspecs, tp_param_specs
from aecf_tpu_torch.train import init_pool_classifier_params
from torch_parallel_workers import run_ranks

WORLD = 4
XRAY = dict(image_dim=32, text_dim=32, hidden_dim=16, num_classes=5)
# (tag, heads): the pure TP mesh of 4, and data x TP (2, 2)
MESHES = (("tp", 4), ("dptp", 2))

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _inputs():
    rs = np.random.default_rng(0)
    inputs = {
        "img": np.asarray(jax.random.normal(jax.random.key(1), (32, 32))),
        "txt": np.asarray(jax.random.normal(jax.random.key(2), (32, 32))),
        "lab": (np.asarray(jax.random.uniform(jax.random.key(3), (32, 5)))
                < 0.3).astype(np.float32),
        "fit_image": rs.standard_normal((64, 32)).astype(np.float32),
        "fit_text": rs.standard_normal((64, 32)).astype(np.float32),
        "fit_label": (rs.random((64, 5)) < 0.3).astype(np.float32),
    }
    for heads in (4, 2):
        params = JaxXray(**XRAY, num_heads=heads).init(jax.random.key(0))
        inputs.update({f"xray{heads}:{k}": v
                       for k, v in _flat(params).items()})
    return inputs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inputs = _inputs()
    return inputs, run_ranks("tp", WORLD, tmp_path_factory.mktemp("tp"),
                             inputs)


def _port(out, tag, kind="p"):
    prefix = f"{tag}:{kind}:"
    return {k[len(prefix):]: v for k, v in out.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("tag,heads", MESHES)
def test_tp_step_matches_jax(ranks, tag, heads):
    inputs, outs = ranks
    model = JaxXray(**XRAY, num_heads=heads)
    opt = optax.sgd(0.1)

    def apply_fn(p, images, texts, rng):
        return model.apply(p, images, texts, training=False), {}

    mesh = data_model_mesh(8, model_parallelism=2)
    params = jax_shard(mesh, model.init(jax.random.key(0)))
    state = JaxState(params, opt.init(params), jnp.zeros((), jnp.int32))
    new, loss, _ = make_tp_train_step(apply_fn, opt, mesh)(
        state, *(jnp.asarray(inputs[k]) for k in ("img", "txt", "lab")),
        jax.random.key(9))
    for out in outs:
        np.testing.assert_allclose(float(out[f"{tag}:loss"]), float(loss),
                                   rtol=5e-5)
        port = _port(out, tag)
        for k, v in _flat(new.params).items():
            np.testing.assert_allclose(port[_dotted(k)], v, atol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("tag,heads", MESHES)
def test_tp_replicated_leaf_grads_equal_unsharded(ranks, tag, heads):
    """Encoders (before the pool), the fusion query (into it) and the
    classifier (after it): the sharded step's gradient is the unsharded
    step's on every rank, not the axis size times it."""
    _, outs = ranks
    for out in outs:
        got, want = _port(out, tag, "g"), _port(out, f"{tag}-whole", "g")
        assert {"fusion_query", "image_encoder.weight",
                "classifier_out.weight", "pool.out_proj_bias"} <= set(got)
        assert set(got) <= set(want)
        for k, v in got.items():
            np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        np.testing.assert_allclose(float(out[f"{tag}:loss"]),
                                   float(out[f"{tag}-whole:loss"]), rtol=1e-6)


def test_tp_scan_chunk_matches_sequential_tp_steps(ranks):
    _, outs = ranks
    for out in outs:
        assert tuple(out["scan:entropy_shape"]) == (3,)
        np.testing.assert_array_equal(out["scan:chunk_loss"],
                                      out["scan:seq_loss"])
        seq = _port(out, "scan-seq")
        for k, v in _port(out, "scan-chunk").items():
            np.testing.assert_array_equal(v, seq[k], err_msg=k)


def test_tp_fit_resume_matches_uninterrupted(ranks):
    _, outs = ranks
    for out in outs:
        assert list(out["fit:steps"]) == [8, 4, 8]
        full = _port(out, "fit-full")
        for k, v in _port(out, "fit-resumed").items():
            np.testing.assert_allclose(v, full[k], atol=1e-6, err_msg=k)


def test_tp_fit_scan_chunk_matches_single_step(ranks):
    _, outs = ranks
    for out in outs:
        single = _port(out, "fit-single6")
        for k, v in _port(out, "fit-chunk6").items():
            np.testing.assert_allclose(v, single[k], atol=1e-6, err_msg=k)


def test_tp_checkpoint_restores_unsharded(ranks):
    """The checkpoint holds the pools whole: an unsharded model restores
    it (parameters and AdamW state) to the run's gathered parameters."""
    _, outs = ranks
    out = outs[0]
    assert int(out["restored:step"]) == 8
    resumed = _port(out, "fit-resumed")
    restored = _port(out, "restored")
    assert set(restored) == set(resumed)
    for k, v in restored.items():
        np.testing.assert_array_equal(v, resumed[k], err_msg=k)


def test_tp_param_specs_structure():
    """Placements mirror the parameters: pools head-sharded, the rest
    replicated; a biasless pool puts None in its bias slots."""
    specs = tp_param_specs(XrayAECFModel(**XRAY, device="cpu"))
    assert specs["pool.in_proj_weight"] == Shard(0)
    assert specs["pool.out_proj_weight"] == Shard(1)
    assert specs["pool.in_proj_bias"] == Shard(0)
    assert specs["pool.out_proj_bias"] == Replicate()
    assert specs["classifier_out.weight"] == Replicate()
    assert list(specs) == [n for n, _ in XrayAECFModel(
        **XRAY, device="cpu").named_parameters()]
    pc = tp_param_specs(init_pool_classifier_params(None, 8, 3, device="cpu"))
    assert pc["pool"]["in_proj_weight"] == Shard(0)
    assert pc["query"] == Replicate() and pc["head"]["w"] == Replicate()
    import torch

    g = torch.Generator().manual_seed(0)
    biasless = init_attention_pool_params(g, 8, bias=False)
    s = attention_pool_pspecs(biasless)
    assert s["in_proj_bias"] is None and s["out_proj_bias"] is None
