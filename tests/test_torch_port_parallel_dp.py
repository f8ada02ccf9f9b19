"""The port's data-parallel layer against the JAX package's.

The port runs on four gloo processes on the CPU (``torch_parallel_workers``,
spawned once for the module); JAX runs in this process on the conftest's
8-virtual-device mesh, from the same numpy inputs.  The counterparts of
``tests/test_pool_step.py::test_dp_matches_single_device``,
``::test_dp_scan_chunk_matches_single_chunk``, ``::test_packed_staged_dp_chunk``
and ``tests/test_parallel.py``'s DP cases:

* the pool DP step and chunk, ``'fused-step'`` (the one-pass kernel's
  plain version) and ``'torch'``, ``training=False``, SGD, against JAX's
  ``mesh=`` step and chunk: loss rtol 5e-5, parameters atol 1e-5;
* ``make_dp_train_step`` with ``accum_steps`` 1 and 2, and
  ``make_dp_eval_step``, on the X-ray model;
* the info as a global mean of the shards' local means; the shards' masks
  bit for bit those of the non-mesh step fed ``fold_seed_words(seed,
  rank)``; the DP chunk bit for bit K sequential DP steps; every rank's
  parameters equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from aecf_tpu.models import XrayAECFModel as JaxXray
from aecf_tpu.parallel import data_mesh, make_dp_eval_step, make_dp_train_step
from aecf_tpu.parallel import replicate, shard_batch
from aecf_tpu.train import TrainState as JaxState
from aecf_tpu.train import init_pool_classifier_params as jax_init
from aecf_tpu.train import make_pool_scan_train_step as jax_chunk
from aecf_tpu.train import make_pool_train_step as jax_step
from aecf_tpu_torch.convert import _dotted
from torch_parallel_workers import run_ranks

WORLD = 4
E, M, B, C = 64, 3, 64, 6
STEPS, K = 3, 3
XRAY = dict(image_dim=32, text_dim=32, hidden_dim=16, num_classes=5)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _inputs():
    pool = jax_init(jax.random.key(0), E, C)
    kv = np.asarray(jax.random.normal(jax.random.key(1), (B, M, E)))
    labels = (np.asarray(jax.random.uniform(jax.random.key(2), (B, C)))
              < 0.3).astype(np.float32)
    xray = JaxXray(**XRAY).init(jax.random.key(0))
    img = np.asarray(jax.random.normal(jax.random.key(1), (64, 32)))
    txt = np.asarray(jax.random.normal(jax.random.key(2), (64, 32)))
    lab = (np.asarray(jax.random.uniform(jax.random.key(3), (64, 5)))
           < 0.3).astype(np.float32)
    inputs = {"kv": kv, "labels": labels, "img": img, "txt": txt, "lab": lab,
              "steps": np.asarray(STEPS), "chunk_k": np.asarray(K)}
    inputs.update({f"pool:{k}": v for k, v in _flat(pool).items()})
    inputs.update({f"xray:{k}": v for k, v in _flat(xray).items()})
    return inputs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inputs = _inputs()
    return inputs, run_ranks("dp", WORLD, tmp_path_factory.mktemp("dp"),
                             inputs)


def _port_params(out, tag):
    prefix = f"{tag}:p:"
    return {k[len(prefix):]: v for k, v in out.items()
            if k.startswith(prefix)}


def _close_to_jax(port, jax_flat, atol, dotted=False):
    assert port
    for k, v in jax_flat.items():
        got = port[_dotted(k) if dotted else k]
        np.testing.assert_allclose(got, v, atol=atol, err_msg=k)


def _pool_state(opt):
    params = jax_init(jax.random.key(0), E, C)
    return JaxState(params, opt.init(params), jnp.zeros((), jnp.int32))


@pytest.mark.parametrize("impl", ["fused-step", "torch"])
def test_dp_pool_step_matches_jax(ranks, impl):
    inputs, outs = ranks
    opt = optax.sgd(0.1)
    kw = dict(training=False, precision="highest", donate=False,
              mesh=data_mesh(8))
    if impl == "fused-step":
        kw["interpret"] = True
    step = jax_step(opt, impl="xla" if impl == "torch" else impl, **kw)
    state = _pool_state(opt)
    for i in range(STEPS):
        state, loss, _ = step(state, jnp.asarray(inputs["kv"]),
                              jnp.asarray(inputs["labels"]),
                              jax.random.fold_in(jax.random.key(3), i))
        np.testing.assert_allclose(outs[0][f"step-{impl}:loss"][i],
                                   float(loss), rtol=5e-5)
    _close_to_jax(_port_params(outs[0], f"step-{impl}"), _flat(state.params),
                  1e-5)


@pytest.mark.parametrize("impl", ["fused-step", "fused-step-packed", "torch"])
def test_dp_pool_chunk_matches_jax(ranks, impl):
    inputs, outs = ranks
    opt = optax.sgd(0.1)
    kw = dict(training=False, donate=False, mesh=data_mesh(8),
              impl="xla" if impl == "torch" else "fused-step")
    if impl != "torch":
        kw["interpret"] = True
    chunk = jax_chunk(opt, **kw)
    kv = jnp.broadcast_to(jnp.asarray(inputs["kv"]), (K, B, M, E))
    if impl.endswith("packed"):
        kv = kv.reshape(K, B, M * E)
    labels = jnp.broadcast_to(jnp.asarray(inputs["labels"]), (K, B, C))
    state, losses, _ = chunk(_pool_state(opt), kv, labels,
                             jax.random.key(13))
    np.testing.assert_allclose(outs[0][f"chunk-{impl}:loss"],
                               np.asarray(losses), rtol=5e-5)
    _close_to_jax(_port_params(outs[0], f"chunk-{impl}"), _flat(state.params),
                  1e-5)


def test_dp_ranks_stay_equal(ranks):
    """The same update on every rank: every parameter of every run equal
    bit for bit across the ranks."""
    _, outs = ranks
    keys = [k for k in outs[0] if ":p:" in k]
    assert len(keys) > 50
    for out in outs[1:]:
        for k in keys:
            np.testing.assert_array_equal(out[k], outs[0][k], err_msg=k)


def _jax_xray():
    model = JaxXray(**XRAY)
    params = model.init(jax.random.key(0))
    return model, params


@pytest.mark.parametrize("accum", [1, 2])
def test_dp_train_step_accum_matches_jax(ranks, accum):
    inputs, outs = ranks
    model, params = _jax_xray()
    opt = optax.sgd(0.1)
    mesh = data_mesh(8)

    def apply_fn(p, images, texts, rng):
        return model.apply(p, images, texts, training=False), {}

    step = make_dp_train_step(apply_fn, opt, mesh, donate=False,
                              accum_steps=accum)
    state = replicate(mesh, JaxState(params, opt.init(params),
                                     jnp.zeros((), jnp.int32)))
    batch = shard_batch(mesh, tuple(jnp.asarray(inputs[k])
                                    for k in ("img", "txt", "lab")))
    new, loss, _ = step(state, *batch, jax.random.key(9))
    np.testing.assert_allclose(float(outs[0][f"accum{accum}:loss"]),
                               float(loss), rtol=5e-5)
    _close_to_jax(_port_params(outs[0], f"accum{accum}"), _flat(new.params),
                  1e-5, dotted=True)


def test_dp_eval_step_matches_jax(ranks):
    inputs, outs = ranks
    model, params = _jax_xray()
    mesh = data_mesh(8)

    def apply(p, batch):
        return model.apply(p, batch["image"], batch["text"], training=False)

    eval_step = make_dp_eval_step(apply, mesh)
    batch = {"image": jnp.asarray(inputs["img"][:32]),
             "text": jnp.asarray(inputs["txt"][:32])}
    want = np.asarray(eval_step(replicate(mesh, params),
                                shard_batch(mesh, batch)))
    for out in outs:  # every rank holds the whole output
        np.testing.assert_allclose(out["eval:out"], want, atol=1e-5)


def test_dp_info_is_global_mean(ranks):
    _, outs = ranks
    assert int(outs[0]["info:entropy_ndim"]) == 0
    local = np.mean([float(o["info:local_entropy"]) for o in outs])
    for out in outs:
        assert np.isfinite(out["info:entropy"])
        np.testing.assert_allclose(float(out["info:entropy"]), local,
                                   rtol=1e-6)


def test_dp_shard_masks_bit_for_bit(ranks):
    """Rank r's masks in the DP step are the non-mesh step's on its rows
    fed ``fold_seed_words(seed, r)``; the unfolded seed draws others, and
    so do the shards."""
    _, outs = ranks
    for out in outs:
        np.testing.assert_array_equal(out["masks:dp"], out["masks:single"])
        assert not np.array_equal(out["masks:dp"], out["masks:unfolded"])
    assert not np.array_equal(outs[0]["masks:dp"], outs[1]["masks:dp"])


def test_dp_scan_chunk_matches_sequential_dp_steps(ranks):
    _, outs = ranks
    out = outs[0]
    assert tuple(out["scan:entropy_shape"]) == (K,)
    np.testing.assert_array_equal(out["scan:chunk_loss"], out["scan:seq_loss"])
    seq = _port_params(out, "scan-seq")
    for k, v in _port_params(out, "scan-chunk").items():
        np.testing.assert_array_equal(v, seq[k], err_msg=k)
