"""The port's K-step chunk, the step at every width, staged addressing and
a custom ``row_loss``, against the port's single steps and the JAX package.

On the CPU every route of the chunk runs its K steps eagerly through the
kernels' plain versions (the CUDA graph is the card's route;
``chip_smoke.py`` holds it to the eager steps there).  Tolerances:

* the chunk against K single steps fed the same seed words, and packed
  against 4-D staging: exactly (the same computation);
* against JAX ``make_pool_scan_train_step(impl='xla', training=False)`` and
  ``make_pool_train_step`` in lockstep: loss rtol 2e-5, parameters atol
  2e-5, as ``test_torch_port_pool_step.py`` holds the single step (f32
  sums in other orders);
* a custom ``row_loss`` through the two-pass route against the plain step:
  ``torch.testing.assert_close``'s f32 defaults (rtol 1.3e-6, atol 1e-5),
  masks exactly (the same Philox words).
"""

import functools
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aecf_tpu.train import TrainState as JaxState
from aecf_tpu.train import init_pool_classifier_params as jax_init
from aecf_tpu.train import make_pool_scan_train_step as jax_scan
from aecf_tpu.train import make_pool_train_step as jax_make
from aecf_tpu_torch.convert import (
    pool_classifier_params_from_numpy,
    pool_classifier_params_to_numpy,
)
from aecf_tpu_torch.kernels import (
    fused_pool_train_step,
    train_step,
    train_step_plain,
)
from aecf_tpu_torch.kernels.draws import fold_seed_words, seed_words_of
from aecf_tpu_torch.kernels.shared_query import _prep
from aecf_tpu_torch.train import (
    TrainState,
    as_fit_chunk,
    make_pool_scan_train_step,
    make_pool_train_step,
    param_leaves,
)
from aecf_tpu_torch.train.pool_step import _check_graph_optimizer, _signature

E, M, B, C, K = 32, 3, 24, 5, 4


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _state(flat, opt=lambda ps: torch.optim.SGD(ps, lr=1e-2)):
    params = pool_classifier_params_from_numpy(flat, device="cpu")
    return TrainState(params, opt(param_leaves(params)))


def _adamw(ps):
    return torch.optim.AdamW(ps, lr=1e-2, weight_decay=0.01)


def _data(seed, K=K, B=B, M=M, E=E, C=C):
    rng = np.random.default_rng(seed)
    kv = rng.standard_normal((K, B, M, E)).astype(np.float32)
    labels = (rng.random((K, B, C)) < 0.3).astype(np.float32)
    return kv, labels


def _params_equal(a, b):
    for x, y in zip(param_leaves(a.params), param_leaves(b.params)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("impl", ["torch", "fused-step", "kernel"])
@pytest.mark.parametrize("with_head", [True, False])
def test_chunk_equals_single_steps(impl, with_head):
    """K chunked steps = K single steps fed ``fold_seed_words(rng, step)``,
    exactly, with the mask drawn (``training=True``); two chunks chain."""
    flat = _flat(jax_init(jax.random.key(0), E, C if with_head else None))
    kv, labels = _data(1)
    kv, labels = torch.from_numpy(kv), torch.from_numpy(labels)
    if not with_head:
        labels = None
    chunked, single = _state(flat, _adamw), _state(flat, _adamw)
    chunk = make_pool_scan_train_step(impl=impl, entropy_coeff=0.1)
    step = make_pool_train_step(impl=impl, entropy_coeff=0.1)
    for half in (slice(0, 2), slice(2, K)):
        chunked, losses, infos = chunk(
            chunked, kv[half], None if labels is None else labels[half], 9)
        want = []
        for i in range(half.start, half.stop):
            single, loss, info = step(
                single, kv[i], None if labels is None else labels[i],
                fold_seed_words(9, single.step))
            want.append(loss)
            for k, v in info.items():
                assert torch.equal(infos[k][i - half.start], v.float().mean()), k
        assert torch.equal(losses, torch.stack(want))
    assert chunked.step == single.step == K
    assert 0 < float(infos["mask_rate"].mean()) < 1
    _params_equal(chunked, single)


def test_chunk_packed_staging_and_full_info():
    """Packed ``(K, B, M·E)`` staging (through ``as_fit_chunk``, streams
    side by side in one buffer or apart) gives the 4-D staging's steps
    exactly: losses, the full info dict of per-step means, parameters."""
    flat = _flat(jax_init(jax.random.key(0), E, C))
    kv, labels = map(torch.from_numpy, _data(2))
    a, b, c = _state(flat), _state(flat), _state(flat)
    four = make_pool_scan_train_step(impl="fused-step")
    a, la, ia = four(a, kv, labels, (5, 6))
    fit_chunk = as_fit_chunk(make_pool_scan_train_step(impl="fused-step"))
    b, lb, ib = fit_chunk(b, kv[:, :, 0], torch.cat(
        [kv[:, :, 1], kv[:, :, 2]], dim=-1), labels, (5, 6))
    packed = kv.reshape(K, B, M * E).clone()
    c, lc, ic = fit_chunk(c, packed[..., :E], packed[..., E:], labels, (5, 6))
    assert torch.equal(la, lb) and torch.equal(la, lc)
    assert set(ia) == {"entropy", "mask_rate", "target_entropy",
                       "attention_weights", "masked_attention_weights"}
    for k in ia:
        assert ia[k].shape == (K,), k
        assert torch.equal(ia[k], ib[k]) and torch.equal(ia[k], ic[k]), k
    _params_equal(a, b)
    _params_equal(a, c)


@functools.lru_cache(maxsize=None)
def _jax_chunks(with_head, E=E, B=B, seed=3):
    params = jax_init(jax.random.key(seed), E, C if with_head else None)
    opt = optax.sgd(1e-2)
    state = JaxState(params, opt.init(params), jnp.zeros((), jnp.int32))
    chunk = jax_scan(opt, impl="xla", training=False, entropy_coeff=0.01,
                     donate=False)
    kv, labels = _data(seed, E=E, B=B)
    losses = []
    for half in (slice(0, 2), slice(2, K)):
        state, l, _ = chunk(state, jnp.asarray(kv[half]),
                            jnp.asarray(labels[half]) if with_head else None,
                            jax.random.key(0))
        losses += list(np.asarray(l))
    return _flat(params), losses, _flat(state.params)


@pytest.mark.parametrize("impl", ["torch", "fused-step", "auto"])
@pytest.mark.parametrize("with_head", [True, False])
def test_chunk_lockstep_with_jax(impl, with_head):
    flat0, losses_j, final_j = _jax_chunks(with_head)
    state = _state(flat0)
    chunk = make_pool_scan_train_step(impl=impl, training=False,
                                      entropy_coeff=0.01)
    kv, labels = map(torch.from_numpy, _data(3))
    losses = []
    for half in (slice(0, 2), slice(2, K)):
        state, l, _ = chunk(state, kv[half].reshape(-1, B, M * E),
                            labels[half] if with_head else None, 0)
        losses += l.tolist()
    np.testing.assert_allclose(losses, losses_j, rtol=2e-5, atol=2e-5)
    final = pool_classifier_params_to_numpy(state.params)
    for k in final_j:
        np.testing.assert_allclose(final[k], final_j[k], atol=2e-5, err_msg=k)


@pytest.mark.parametrize("width", [30, 258])
def test_auto_step_at_widths_not_divisible_by_4(width):
    """``make_pool_train_step(impl='auto')`` at E=30 and E=258 (the widths
    the card's step now takes) against JAX's XLA step, 4 SGD steps."""
    Bw = 20
    params = jax_init(jax.random.key(4), width, C)
    opt = optax.sgd(1e-2)
    js = JaxState(params, opt.init(params), jnp.zeros((), jnp.int32))
    jstep = jax_make(opt, impl="xla", training=False, donate=False)
    state = _state(_flat(params))
    step = make_pool_train_step(impl="auto", training=False)
    kv, labels = _data(5, K=1, B=Bw, E=width)
    for _ in range(4):
        js, jl, _ = jstep(js, jnp.asarray(kv[0]), jnp.asarray(labels[0]),
                          jax.random.key(0))
        state, loss, _ = step(state, torch.from_numpy(kv[0]),
                              torch.from_numpy(labels[0]), None)
        np.testing.assert_allclose(float(loss), float(jl), rtol=2e-5)
    final = pool_classifier_params_to_numpy(state.params)
    for k, v in _flat(js.params).items():
        np.testing.assert_allclose(final[k], v, atol=2e-5, err_msg=k)


def _step_inputs(seed, B=B, M=M, E=E):
    rng = np.random.default_rng(seed)
    flat = _flat(jax_init(jax.random.key(seed), E, C))
    params = pool_classifier_params_from_numpy(flat, device="cpu")
    with torch.no_grad():
        u, c, wvo, bctx, _, _ = _prep(params["pool"], params["query"][0, 0], 1)
    kv = torch.from_numpy(rng.standard_normal((B, M, E)).astype(np.float32))
    labels = torch.from_numpy((rng.random((B, C)) < 0.3).astype(np.float32))
    return params, (kv, u[0], c, None, wvo, bctx), labels


@pytest.mark.parametrize("with_head", [True, False])
def test_custom_row_loss_runs_the_two_pass_route(with_head):
    """A custom ``row_loss`` (chosen by the arguments, on any device) goes
    through the forward and backward kernels' wrappers — their plain
    versions here — and equals the plain step with the same seed words."""
    params, args, labels = _step_inputs(6)
    inv = 1.0 / (B * (C if with_head else E))
    kw = dict(inv=inv, want_dkv=True, training=True, seed=(11, 12),
              mask_prob=0.6)
    if with_head:
        kw.update(head_w=params["head"]["w"].detach(),
                  head_b=params["head"]["b"].detach(), labels=labels)

        def row_loss(x, y):
            bce = (x.clamp_min(0) - x * y + torch.log1p(torch.exp(-x.abs())))
            return bce.sum(-1, keepdim=True) * inv, (torch.sigmoid(x) - y) * inv
    else:
        def row_loss(x):
            return (x * x).sum(-1, keepdim=True) * inv, x * (2 * inv)

    got = train_step(*args, row_loss=row_loss, **kw)
    want = train_step_plain(*args, row_loss=row_loss, **kw)
    builtin = train_step_plain(*args, **kw)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], msg=k)
        torch.testing.assert_close(got[k], builtin[k], msg=k)
    assert torch.equal(got["mw"], want["mw"])
    assert torch.equal(got["rate"], want["rate"])


def test_staged_addressing_equals_the_unstaged_step():
    """``row_offset``/``batch_rows`` into 3-D and packed 2-D staged rows
    give the step on those rows, exactly; the rejections."""
    params, _, _ = _step_inputs(7)
    kv, labels = map(torch.from_numpy, _data(8))
    kw = dict(generator=(1, 2), head_w=params["head"]["w"],
              head_b=params["head"]["b"])
    i = 2
    want = fused_pool_train_step(params["pool"], params["query"], kv[i],
                                 labels=labels[i], **kw)
    for staged in (kv.reshape(K * B, M, E), kv.reshape(K * B, M * E)):
        got = fused_pool_train_step(
            params["pool"], params["query"], staged,
            labels=labels.reshape(K * B, C), row_offset=i * B, batch_rows=B,
            **kw)
        assert torch.equal(got[0], want[0])
        for k in want[1]:
            if want[1][k] is not None:
                assert torch.equal(got[1][k], want[1][k]), k
        for k in want[-1]:
            assert torch.equal(got[-1][k], want[-1][k]), k
    call = functools.partial(fused_pool_train_step, params["pool"],
                             params["query"], kv.reshape(K * B, M, E),
                             training=False)
    with pytest.raises(ValueError, match="requires batch_rows"):
        call(row_offset=0)
    with pytest.raises(ValueError, match="outside"):
        call(row_offset=K * B, batch_rows=B)
    with pytest.raises(ValueError, match="staged labels"):
        call(row_offset=0, batch_rows=B, head_w=params["head"]["w"],
             labels=labels[0])
    with pytest.raises(ValueError, match="not a multiple of embed"):
        fused_pool_train_step(params["pool"], params["query"],
                              kv.reshape(K * B, M * E)[:, :-1],
                              training=False)


def test_seed_words_and_the_fold():
    """A step's seed words as a device tensor equal them by value; the fold
    is a pure function of (seed, step) and differs from step to step."""
    params, args, labels = _step_inputs(9)
    kw = dict(inv=0.1, want_dkv=False, training=True, mask_prob=0.9)
    a = train_step(*args, seed=(7, 8), **kw)
    b = train_step(*args, seed_words=torch.tensor([7, 8], dtype=torch.int32),
                   **kw)
    for k in a:
        assert (a[k] is None and b[k] is None) or torch.equal(a[k], b[k]), k
    with pytest.raises(ValueError, match="seed_words"):
        train_step(*args, seed_words=torch.tensor([7, 8]), **kw)
    assert fold_seed_words(5, 3) == fold_seed_words((5, 0), 3)
    assert fold_seed_words(5, 3) != fold_seed_words(5, 4)
    assert seed_words_of(2**32 + 3) == (3, 1)


def test_chunk_rejections():
    with pytest.raises(ValueError, match="no 'data' axis"):
        make_pool_scan_train_step(
            mesh=SimpleNamespace(mesh_dim_names=("model",)))
    with pytest.raises(ValueError, match="accum_steps"):
        make_pool_scan_train_step(accum_steps=0)
    with pytest.raises(ValueError, match="unknown impl"):
        make_pool_scan_train_step(impl="pallas")
    flat = _flat(jax_init(jax.random.key(0), E, C))
    state = _state(flat)
    chunk = make_pool_scan_train_step()
    kv, labels = map(torch.from_numpy, _data(10))
    with pytest.raises(ValueError, match="not a multiple of embed"):
        chunk(state, kv.reshape(K, B, M * E)[..., :-1], labels, 0)
    with pytest.raises(ValueError, match="labels must be"):
        chunk(state, kv, labels[:-1], 0)
    leaves = param_leaves(state.params)
    for bad in (torch.optim.AdamW(leaves), torch.optim.Adam(leaves),
                torch.optim.RMSprop(leaves)):
        with pytest.raises(ValueError, match="capturable=True"):
            _check_graph_optimizer(bad)
    _check_graph_optimizer(torch.optim.SGD(leaves, lr=0.1))
    with pytest.raises(ValueError, match="dampening"):
        _check_graph_optimizer(torch.optim.SGD(leaves, lr=0.1, momentum=0.9,
                                               dampening=0.5))


def test_accumulated_chunk_equals_accumulated_steps():
    """``accum_steps > 1`` runs eagerly: each step microbatches with the
    step's seed words folded with the microbatch index."""
    flat = _flat(jax_init(jax.random.key(0), E, C))
    kv, labels = map(torch.from_numpy, _data(11))
    a, b = _state(flat), _state(flat)
    a, la, _ = make_pool_scan_train_step(accum_steps=2)(a, kv, labels, 4)
    step = make_pool_train_step(accum_steps=2)
    for i in range(K):
        b, lb, _ = step(b, kv[i], labels[i], fold_seed_words(4, b.step))
        assert torch.equal(la[i], lb)
    _params_equal(a, b)


@pytest.mark.parametrize("make_opt, key, value", [
    (lambda ps: torch.optim.AdamW(ps, lr=1e-3, capturable=True), "lr", 5e-4),
    (lambda ps: torch.optim.AdamW(ps, lr=1e-3, capturable=True),
     "weight_decay", 0.1),
    (lambda ps: torch.optim.AdamW(ps, lr=1e-3, capturable=True),
     "betas", (0.8, 0.99)),
    (lambda ps: torch.optim.SGD(ps, lr=1e-2, momentum=0.9), "momentum", 0.5),
], ids=["lr", "weight_decay", "betas", "sgd-momentum"])
def test_signature_follows_hyperparameters(make_opt, key, value):
    """A captured chunk graph bakes the optimizer's hyperparameters in, so
    a change of any of them must change ``_signature`` (and recapture);
    an unchanged state keeps its signature."""
    state = _state(_flat(jax_init(jax.random.key(0), E, C)), make_opt)
    before = _signature(state)
    assert _signature(state) == before
    state.optimizer.param_groups[0][key] = value
    assert _signature(state) != before


@pytest.mark.parametrize("how", ["table", "env"])
def test_signature_follows_the_plan(how, monkeypatch, tmp_path):
    """A captured chunk graph bakes its step chain's plan in, so a plan
    table or env change between chunk calls must change ``_signature``
    (and recapture); a change at another site does not."""
    from aecf_tpu_torch.kernels import tiles

    monkeypatch.setenv(tiles.ENV_TABLE, str(tmp_path / "tiles.json"))
    monkeypatch.delenv("AECF_TORCH_STEP_PLAN", raising=False)
    tiles.set_table(None)
    state = _state(_flat(jax_init(jax.random.key(0), E, C)))
    kv4 = torch.zeros((K, B, M, E))
    before = _signature(state, kv4)
    assert _signature(state, kv4) == before
    key = tiles.site_key("step_resident", M=M, E=E, H=1, kv_dtype="float32",
                         want_dkv=False)
    plan = {"d_mix": [128, 1]}  # the step's products can take it
    tiles.set_table({key.replace("E=", "E=1"): plan})
    assert _signature(state, kv4) == before
    if how == "table":
        tiles.set_table({key: plan})
    else:
        monkeypatch.setenv("AECF_TORCH_STEP_PLAN", json.dumps(plan))
    try:
        assert _signature(state, kv4) != before
    finally:
        tiles.set_table(None)


def test_chunk_with_step_lr_follows_the_schedule():
    """A ``StepLR`` stepped between chunk calls: the chunk's steps equal
    eager single steps under the same schedule, exactly, and each
    scheduler step changes the signature a graph is held to."""
    flat = _flat(jax_init(jax.random.key(0), E, C))
    kv, labels = map(torch.from_numpy, _data(12))
    chunked, single = _state(flat), _state(flat)
    sched_c = torch.optim.lr_scheduler.StepLR(chunked.optimizer, 1, 0.5)
    sched_s = torch.optim.lr_scheduler.StepLR(single.optimizer, 1, 0.5)
    chunk = make_pool_scan_train_step(impl="fused-step")
    step = make_pool_train_step(impl="fused-step")
    for half in (slice(0, 2), slice(2, K)):
        chunked, losses, _ = chunk(chunked, kv[half], labels[half], 6)
        for i in range(half.start, half.stop):
            single, loss, _ = step(single, kv[i], labels[i],
                                   fold_seed_words(6, single.step))
            assert torch.equal(losses[i - half.start], loss)
        before = _signature(chunked)
        sched_c.step()
        sched_s.step()
        assert _signature(chunked) != before
    assert chunked.optimizer.param_groups[0]["lr"] == 1e-2 / 4
    _params_equal(chunked, single)
