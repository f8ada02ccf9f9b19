"""The port's pool-protocol train step against the JAX package's.

A 12-step SGD lockstep of the port's ``make_pool_train_step`` — every
``impl``, on the CPU through the plain versions of the kernels — against
the JAX ``make_pool_train_step(impl='xla')``, with and without the
classifier head, as ``tests/test_pool_step.py`` holds the JAX impls to
each other: loss rtol 2e-5, parameters atol 2e-5 (``training=False``: the
gradients do not depend on the draw, quirk Q1).  Also one AdamW update
against ``optax.adamw`` with the same gradients and an explicit
``weight_decay``, the parameter converter, microbatching and the options
the port does not cover.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aecf_tpu.train import TrainState as JaxState
from aecf_tpu.train import init_pool_classifier_params as jax_init
from aecf_tpu.train import make_pool_train_step as jax_make
from aecf_tpu_torch.convert import (
    pool_classifier_params_from_numpy,
    pool_classifier_params_to_numpy,
)
from aecf_tpu_torch.train import (
    TrainState,
    as_fit_step,
    init_pool_classifier_params,
    make_pool_train_step,
    param_leaves,
)
from aecf_tpu_torch.kernels.draws import fold_seed_words

E, M, B, C = 64, 3, 64, 6
STEPS = 12


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _data(with_head):
    kv = np.array(jax.random.normal(jax.random.key(1), (B, M, E)))
    labels = None
    if with_head:
        labels = (np.asarray(jax.random.uniform(jax.random.key(2), (B, C)))
                  < 0.3).astype(np.float32)
    return kv, labels


@functools.lru_cache(maxsize=None)
def _jax_trajectory(with_head):
    """Initial parameters, per-step losses and final parameters of the
    JAX XLA step (computed once per head setting)."""
    params = jax_init(jax.random.key(0), E, C if with_head else None)
    opt = optax.sgd(1e-2)
    state = JaxState(params, opt.init(params), jnp.zeros((), jnp.int32))
    step = jax_make(opt, impl="xla", training=False, entropy_coeff=0.01,
                    precision="highest", donate=False)
    kv, labels = _data(with_head)
    losses = []
    for i in range(STEPS):
        state, loss, _ = step(state, jnp.asarray(kv),
                              None if labels is None else jnp.asarray(labels),
                              jax.random.key(i))
        losses.append(float(loss))
    return _flat(params), losses, _flat(state.params)


def _port_state(flat, opt=lambda ps: torch.optim.SGD(ps, lr=1e-2)):
    params = pool_classifier_params_from_numpy(flat, device="cpu")
    return TrainState(params, opt(param_leaves(params)))


@pytest.mark.parametrize("impl", ["torch", "fused-step", "kernel", "auto"])
@pytest.mark.parametrize("with_head", [True, False])
def test_lockstep_with_jax(impl, with_head):
    flat0, losses_j, final_j = _jax_trajectory(with_head)
    state = _port_state(flat0)
    step = make_pool_train_step(impl=impl, training=False, entropy_coeff=0.01)
    kv, labels = _data(with_head)
    kv = torch.from_numpy(kv)
    labels = None if labels is None else torch.from_numpy(labels)
    for i in range(STEPS):
        state, loss, info = step(state, kv, labels, None)
        np.testing.assert_allclose(float(loss), losses_j[i], rtol=2e-5,
                                   atol=2e-5)
    assert state.step == STEPS
    final_t = pool_classifier_params_to_numpy(state.params)
    assert set(final_t) == set(final_j)
    for k in final_j:
        np.testing.assert_allclose(final_t[k], final_j[k], atol=2e-5,
                                   err_msg=k)
    assert {"entropy", "mask_rate", "attention_weights",
            "masked_attention_weights"} <= set(info)


def test_adamw_update_matches_optax():
    """torch.optim.AdamW's decoupled decay equals optax.adamw's when the
    decay is passed to both (their defaults differ: 1e-2 vs 1e-4)."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((5, 7)).astype(np.float32)
    grads = [rng.standard_normal((5, 7)).astype(np.float32) for _ in range(3)]
    opt = optax.adamw(1e-3, weight_decay=0.01)
    pj = jnp.asarray(p0)
    sj = opt.init(pj)
    pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = torch.optim.AdamW([pt], lr=1e-3, weight_decay=0.01)
    for g in grads:
        upd, sj = opt.update(jnp.asarray(g), sj, pj)
        pj = optax.apply_updates(pj, upd)
        pt.grad = torch.from_numpy(g)
        topt.step()
    # the two sum the same terms in other orders: f32 ulps of |p| ~ 2
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), atol=1e-6)


@pytest.mark.parametrize("bias", [True, False])
def test_params_converter_round_trips(bias):
    flat = _flat(jax_init(jax.random.key(3), E, C, bias=bias,
                          head_bias=bias))
    params = pool_classifier_params_from_numpy(flat, device="cpu")
    assert tuple(params["head"]["w"].shape) == (E, C)  # JAX layout, (E, C)
    assert (params["pool"].in_proj_bias is None) == (not bias)
    back = pool_classifier_params_to_numpy(params)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    with pytest.raises(KeyError, match="unknown"):
        pool_classifier_params_from_numpy(
            {**flat, "['extra']": flat["['query']"]}, device="cpu")


def test_init_shapes_and_leaves():
    g = torch.Generator().manual_seed(0)
    p = init_pool_classifier_params(g, E, C, device="cpu")
    assert tuple(p["head"]["w"].shape) == (E, C) and tuple(p["head"]["b"].shape) == (C,)
    assert tuple(p["query"].shape) == (1, 1, E)
    assert len(param_leaves(p)) == 7
    p2 = init_pool_classifier_params(g, E, C, head_bias=False, bias=False,
                                     device="cpu")
    assert "b" not in p2["head"] and len(param_leaves(p2)) == 4
    assert "head" not in init_pool_classifier_params(g, E, device="cpu")


@pytest.mark.parametrize("impl, rng", [
    ("torch", None), ("fused-step", None),
    ("torch", "generator"), ("torch", "words"),
], ids=["torch", "fused-step", "torch-generator", "torch-words"])
def test_accumulation_equals_the_full_batch(impl, rng):
    """Microbatching takes the full batch's means.  Without a draw
    (``training=False``) the accumulated step equals one full-batch step.
    In training, microbatch ``i`` of the pool route draws from the step's
    CPU generator passed through whole (each microbatch takes its own seed
    words from it, in order), or from the step's seed words folded with
    ``i``: loss, gradients and masks equal the means of single steps on the
    microbatches fed those draws."""
    flat0, _, _ = _jax_trajectory(True)
    kv, labels = (torch.from_numpy(a) for a in _data(True))
    if rng is None:
        full = _port_state(flat0)
        acc = _port_state(flat0)
        s1 = make_pool_train_step(impl=impl, training=False)
        s2 = make_pool_train_step(impl=impl, training=False, accum_steps=4)
        full, l1, i1 = s1(full, kv, labels, None)
        acc, l2, i2 = s2(acc, kv, labels, None)
        torch.testing.assert_close(l1, l2)
        for a, b in zip(param_leaves(full.params), param_leaves(acc.params)):
            torch.testing.assert_close(a, b)
        assert i2["entropy"].shape == i1["entropy"].shape
        return

    def draws():
        return (torch.Generator().manual_seed(5) if rng == "generator"
                else (7, 11))

    acc = _port_state(flat0)
    acc, loss, info = make_pool_train_step(impl=impl, accum_steps=2)(
        acc, kv, labels, draws())
    single = make_pool_train_step(impl=impl)
    ref, half = draws(), B // 2
    losses, grads, masked = [], [], []
    for i in range(2):
        state = _port_state(flat0, lambda ps: torch.optim.SGD(ps, lr=0.0))
        rows = slice(i * half, (i + 1) * half)
        state, loss_i, info_i = single(
            state, kv[rows], labels[rows],
            ref if rng == "generator" else fold_seed_words(ref, i))
        losses.append(loss_i)
        grads.append([p.grad for p in param_leaves(state.params)])
        masked.append(info_i["masked_attention_weights"])
    torch.testing.assert_close(loss, torch.stack(losses).mean())
    for got, a, b in zip(param_leaves(acc.params), *grads):
        torch.testing.assert_close(got.grad, (a + b) / 2)
    assert (masked[0] == 0).any() and (masked[1] == 0).any()
    assert torch.equal(info["masked_attention_weights"], torch.cat(masked))


def test_training_draws_from_the_generator_and_fit_step_stacks():
    flat0, _, _ = _jax_trajectory(True)
    state = _port_state(flat0)
    step = as_fit_step(make_pool_train_step(impl="fused-step"))
    kv, labels = (torch.from_numpy(a) for a in _data(True))
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="generator"):
        step(state, kv[:, 0], kv[:, 1], labels, None)
    state, loss, info = step(state, kv[:, 0], kv[:, 1], labels, g)
    assert info["attention_weights"].shape == (B, 1, 2)
    assert set(info) >= {"target_entropy", "mask_rate"}
    assert 0.0 <= float(info["mask_rate"].mean()) <= 1.0


def test_builder_rejects_what_it_does_not_cover():
    with pytest.raises(ValueError, match="no 'data' axis"):
        make_pool_train_step(mesh=SimpleNamespace(mesh_dim_names=("model",)))
    with pytest.raises(ValueError, match="unknown impl"):
        make_pool_train_step(impl="pallas")
    with pytest.raises(ValueError, match="accum_steps"):
        make_pool_train_step(accum_steps=0)
