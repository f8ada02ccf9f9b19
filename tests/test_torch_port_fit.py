"""The port's elastic loop and checkpoints against the JAX package's.

* ``make_epoch_batch_fn``: the JAX function's batches for the same arrays
  and seed, exactly (both are numpy).
* ``fit`` in lockstep with JAX ``fit`` (``training=False``: the gradients
  do not depend on the draw, quirk Q1), SGD: history loss rtol 2e-5, final
  parameters atol 2e-5, as ``test_torch_port_pool_step.py`` holds the
  single step.
* Resume, and a chunked resume misaligned with the chunks, equal the
  uninterrupted run exactly (the same steps on the same seed words, from
  checkpoints that hold the state exactly).
* ``CheckpointManager``: a round trip with AdamW's state, ``max_to_keep``,
  an empty directory giving ``None``, and no half checkpoint after a failed
  write.
* The stager: the streams come back equal to the host arrays, exactly,
  the feature streams side by side in one buffer; ``as_fit_step`` on such
  views equals it on separate tensors, exactly.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from aecf_tpu.train import as_fit_step as jax_as_fit_step
from aecf_tpu.train import fit as jax_fit
from aecf_tpu.train import init_pool_classifier_params as jax_init
from aecf_tpu.train import make_epoch_batch_fn as jax_batch_fn
from aecf_tpu.train import make_pool_train_step as jax_make
from aecf_tpu_torch.convert import (
    pool_classifier_params_from_numpy,
    pool_classifier_params_to_numpy,
)
from aecf_tpu_torch.parallel import data_mesh
from aecf_tpu_torch.train import (
    CheckpointManager,
    TrainState,
    as_fit_chunk,
    as_fit_step,
    fit,
    load_params,
    make_epoch_batch_fn,
    make_pool_scan_train_step,
    make_pool_train_step,
    param_leaves,
    save_params,
)
from aecf_tpu_torch.train.pool_step import _side_by_side
from aecf_tpu_torch.train.staging import Stager

E, C, B, ROWS = 24, 5, 16, 72


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _data(seed=0, rows=ROWS):
    rng = np.random.default_rng(seed)
    return {
        "image": rng.standard_normal((rows, E)).astype(np.float32),
        "text": rng.standard_normal((rows, E)).astype(np.float32),
        "label": (rng.random((rows, C)) < 0.3).astype(np.float32),
    }


@pytest.mark.parametrize("shuffle", [True, False])
def test_epoch_batches_equal_jax(shuffle):
    data = _data()
    data = {"label": data["label"], "text": data["text"],
            "image": data["image"]}  # canonical order whatever the dict's
    ours = make_epoch_batch_fn(data, B, seed=3, shuffle=shuffle)
    theirs = jax_batch_fn(data, B, seed=3, shuffle=shuffle)
    for step in (0, 1, 3, 4, 9, 4, 2):  # across epochs, and back
        for a, b in zip(ours(step), theirs(step)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="exceeds"):
        make_epoch_batch_fn(data, ROWS + 1)
    with pytest.raises(ValueError, match="row mismatch"):
        make_epoch_batch_fn({"a": np.zeros(3), "b": np.zeros(4)}, 1)


@functools.lru_cache(maxsize=None)
def _jax_run(steps):
    params = jax_init(jax.random.key(0), E, C)
    opt = optax.sgd(1e-2)
    step = jax_as_fit_step(jax_make(opt, impl="xla", training=False,
                                    donate=False))
    state, history = jax_fit(
        None, opt, params, jax_batch_fn(_data(), B, seed=1),
        num_steps=steps, rng=jax.random.key(1), step_fn=step, log_every=1)
    return _flat(params), history["loss"], _flat(state.params)


def _sgd(ps):
    return torch.optim.SGD(ps, lr=1e-2)


def test_fit_lockstep_with_jax(capsys):
    flat0, losses_j, final_j = _jax_run(6)
    state, history = fit(
        None, _sgd, pool_classifier_params_from_numpy(flat0, device="cpu"),
        make_epoch_batch_fn(_data(), B, seed=1), num_steps=6, rng=1,
        step_fn=as_fit_step(make_pool_train_step(impl="torch",
                                                 training=False)),
        log_every=1)
    assert state.step == 6 and history["step"] == list(range(6))
    assert "step 5: loss=" in capsys.readouterr().out
    np.testing.assert_allclose(history["loss"], losses_j, rtol=2e-5)
    final = pool_classifier_params_to_numpy(state.params)
    for k, v in final_j.items():
        np.testing.assert_allclose(final[k], v, atol=2e-5, err_msg=k)
    assert {"entropy", "mask_rate"} <= set(history)


def _run(flat, num_steps, ckpt=None, chunk=1, impl="fused-step"):
    return fit(
        None, lambda ps: torch.optim.AdamW(ps, lr=1e-2, weight_decay=0.01),
        pool_classifier_params_from_numpy(flat, device="cpu"),
        make_epoch_batch_fn(_data(), B, seed=2), num_steps=num_steps, rng=5,
        checkpoint_dir=ckpt, save_every=4, log_every=1,
        step_fn=as_fit_step(make_pool_train_step(impl=impl)),
        chunk_fn=as_fit_chunk(make_pool_scan_train_step(impl=impl)),
        scan_chunk=chunk)


@pytest.mark.parametrize("chunk,stop", [(1, 7), (3, 7), (4, 5)])
def test_resume_equals_the_uninterrupted_run(tmp_path, chunk, stop):
    """Stopped at ``stop`` (misaligned with the chunks where ``chunk`` does
    not divide it) and resumed by a second call: the uninterrupted run's
    parameters and losses exactly, and the unchunked run's."""
    flat = _flat(jax_init(jax.random.key(2), E, C))
    full, hist = _run(flat, 12, chunk=chunk)
    plain, plain_hist = _run(flat, 12)
    first, _ = _run(flat, stop, ckpt=str(tmp_path), chunk=chunk)
    assert first.step == stop
    assert CheckpointManager(str(tmp_path)).latest_step() == stop
    resumed, hist2 = _run(flat, 12, ckpt=str(tmp_path), chunk=chunk)
    assert resumed.step == 12
    assert hist2["step"][0] == stop
    assert hist2["loss"] == hist["loss"][stop:] == plain_hist["loss"][stop:]
    for other in (full, plain):
        for a, b in zip(param_leaves(other.params),
                        param_leaves(resumed.params)):
            assert torch.equal(a, b)


@contextlib.contextmanager
def _one_rank(tmp_path):
    """A one-rank gloo job in this process, and its ('data',) mesh."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield data_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_fit_options(tmp_path):
    flat = _flat(jax_init(jax.random.key(2), E, C))
    params = pool_classifier_params_from_numpy(flat, device="cpu")
    batch_fn = make_epoch_batch_fn(_data(), B)
    step = as_fit_step(make_pool_train_step())
    # mesh= over one rank: the plain run's parameters (the gradients do
    # not depend on the shard's draws, quirk Q1)
    with _one_rank(tmp_path) as mesh:
        dp, _ = fit(None, _sgd,
                    pool_classifier_params_from_numpy(flat, device="cpu"),
                    batch_fn, num_steps=2, rng=0, mesh=mesh,
                    step_fn=as_fit_step(make_pool_train_step(mesh=mesh)))
    plain, _ = fit(None, _sgd,
                   pool_classifier_params_from_numpy(flat, device="cpu"),
                   batch_fn, num_steps=2, rng=0, step_fn=step)
    for a, b in zip(param_leaves(dp.params), param_leaves(plain.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="scan_chunk"):
        fit(None, _sgd, params, batch_fn, num_steps=1, rng=0, scan_chunk=0)
    with pytest.raises(ValueError, match="custom step_fn"):
        fit(None, _sgd, params, batch_fn, num_steps=1, rng=0, step_fn=step,
            scan_chunk=2)
    opt = torch.optim.SGD(param_leaves(params), lr=0.1)  # a built optimizer
    state, history = fit(None, opt, params, batch_fn, num_steps=2, rng=0,
                         step_fn=step)
    assert state.optimizer is opt and state.step == 2
    assert history == {"loss": [], "step": []}


def _adam_state(seed):
    flat = _flat(jax_init(jax.random.key(seed), E, C))
    params = pool_classifier_params_from_numpy(flat, device="cpu")
    return TrainState(params, torch.optim.AdamW(param_leaves(params),
                                                lr=1e-2, weight_decay=0.01))


def _train(state, steps=2):
    step = make_pool_train_step(impl="torch")
    data = _data()
    kv = torch.from_numpy(np.stack([data["image"], data["text"]], 1))[:B]
    labels = torch.from_numpy(data["label"][:B])
    for _ in range(steps):
        state, _, _ = step(state, kv, labels, (1, 2))
    return state


def test_checkpoint_round_trip_with_adamw_state(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=2,
                            max_to_keep=2)
    assert mgr.restore(_adam_state(0)) is None  # an empty directory
    assert mgr.latest_step() is None
    state = _train(_adam_state(0))
    assert mgr.save(1, state)  # the first save, whatever the interval
    assert not mgr.save(3, state)  # off the interval
    for s in (2, 4, 6):
        assert mgr.save(s, state)
    assert mgr.all_steps() == [4, 6]  # max_to_keep
    assert not mgr.save(6, state)  # at the latest step
    other = _adam_state(1)
    restored = mgr.restore(other)
    assert restored is other and other.step == state.step == 2
    for a, b in zip(param_leaves(state.params), param_leaves(other.params)):
        assert torch.equal(a, b)
    sa, sb = state.optimizer.state_dict(), other.optimizer.state_dict()
    for k, v in sa["state"].items():
        for name, t in v.items():
            assert torch.equal(torch.as_tensor(t),
                               torch.as_tensor(sb["state"][k][name])), name
    # both go on alike
    _train(state, 1), _train(other, 1)
    for a, b in zip(param_leaves(state.params), param_leaves(other.params)):
        assert torch.equal(a, b)
    mgr.wait()
    mgr.close()


def test_failed_write_leaves_no_half_checkpoint(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=1)
    state = _adam_state(0)
    assert mgr.save(1, state)

    def broken(obj, f, *a, **k):
        with open(f, "wb") as fh:
            fh.write(b"half")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(2, state)
    monkeypatch.undo()
    assert mgr.latest_step() == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_1.pt"]
    assert mgr.restore(_adam_state(1)).step == 0


def test_save_and_load_params(tmp_path):
    state = _train(_adam_state(0))
    path = str(tmp_path / "params.pt")
    save_params(path, state.params)
    fresh = _adam_state(1).params
    assert load_params(path, fresh) is fresh
    for a, b in zip(param_leaves(state.params), param_leaves(fresh)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("stacked", [False, True])
def test_stager_packs_the_feature_streams(stacked):
    batch_fn = make_epoch_batch_fn(_data(), B, seed=1)
    steps = [batch_fn(s) for s in range(3 if stacked else 1)]
    count = len(steps) if stacked else None
    images, texts, labels = Stager("cpu")(iter(steps), count=count)
    want = [np.stack(a) if stacked else a[0] for a in zip(*steps)]
    for got, w in zip((images, texts, labels), want):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), w)
    packed = _side_by_side(images, texts)
    assert packed is not None and packed.shape[-1] == 2 * E
    assert packed.data_ptr() == images.data_ptr()
    assert _side_by_side(texts, images) is None
    assert _side_by_side(images, labels) is None
    # streams of another dtype are not packed
    odd = [(a, b.astype(np.float64), c) for a, b, c in steps]
    i2, t2, _ = Stager("cpu")(odd, count=count)
    assert t2.dtype == torch.float64 and _side_by_side(i2, t2) is None
    assert i2.is_contiguous() and t2.is_contiguous()
    np.testing.assert_array_equal(i2.numpy(), want[0])
    if stacked:
        return
    flat = _flat(jax_init(jax.random.key(0), E, C))
    states = []
    for feats in ((images, texts), (images.clone(), texts.clone())):
        params = pool_classifier_params_from_numpy(flat, device="cpu")
        state = TrainState(params, torch.optim.SGD(param_leaves(params),
                                                   lr=1e-2))
        state, loss, _ = as_fit_step(make_pool_train_step(impl="torch"))(
            state, *feats, labels, (3, 4))
        states.append((loss, param_leaves(state.params)))
    assert torch.equal(states[0][0], states[1][0])
    for x, y in zip(states[0][1], states[1][1]):
        assert torch.equal(x, y)
