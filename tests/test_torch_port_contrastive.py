"""The port's contrastive steps (BASELINE config 5) against the JAX
package's and the plain reference's, on the CPU.

The JAX side is ``examples/train_contrastive.py``'s ``local_step`` built
from the package's pieces (``ops.fusion_pool`` in training with
``kv_grad=False``, ``models.layers.linear``, ``jax.lax.all_gather`` inside
``jax.shard_map``, ``optax.adamw(3e-4)``) on a ``('data',)`` mesh of the
conftest's virtual CPU devices: one device against the port's world 1, two
against its two gloo ranks, from the same weights and inputs.  The JAX
package draws its masks from ``jax.random`` and the port from Philox, but
the mask never changes the pooled output (quirk Q1), so each step's loss,
the gradients and the parameters after K steps are compared; the masks are
compared with the reference's Philox draw.

``perfbench/reference/contrastive.py`` computes the global step over every
shard's rows in one process (the pool from its equations, InfoNCE over the
concatenated targets, autograd, AdamW); the port runs
:func:`~aecf_tpu_torch.train.make_contrastive_scan_train_step` at world 1
here and over two gloo ranks (``torch_parallel_workers``, case
``contrastive``), on the same weights and inputs:

* each step's global loss, the first and last steps' gradients of every
  leaf, every leaf after the K AdamW steps, and each step's masks bit for
  bit;
* the row gather's backward against autograd through a concatenation;
* the local-negatives fault (InfoNCE over a shard's own targets) outside
  every tolerance used here;
* the collectives one call counts: K of each.

Tolerances, both sides IEEE float32 on the CPU: the port restructures the
pool (the scores as ``kv·u + c``, ``W_vo = Wo Wv``), which moves the sums
by a few ulps.  Loss ``rtol 2e-6``: ~10 ulps of a loss near ln(32).
Gradients ``2e-5`` of the leaf's norm: reassociated sums of 16-32 rows.
Parameters ``atol 2e-7`` after 3 steps of lr 3e-4: Adam divides each
gradient by its own root mean square, so a leaf entry whose gradient is
round-off moves by up to lr a step on either side; the bound is a
thousandth of the 3·lr such an entry can move, and every entry whose
reference gradient is round-off is left out (``_settled``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec

from aecf_tpu.core.attention import AttentionPoolParams
from aecf_tpu.models.layers import LinearParams, linear
from aecf_tpu.ops import fusion_pool
from aecf_tpu.parallel import data_mesh

from aecf_tpu_torch.kernels.draws import fold_seed_words
from aecf_tpu_torch.parallel import collectives
from aecf_tpu_torch.train import (
    TrainState,
    init_contrastive_params,
    make_contrastive_scan_train_step,
    make_contrastive_train_step,
    param_leaves,
)
from perfbench.reference import contrastive as ref
from torch_parallel_workers import run_ranks

E, M, P, K = 64, 4, 16, 3
WORLD = 2
N = 32  # global rows: 16 a rank over two ranks
SEED = 2**33 + 17
TEMPERATURE = 0.1
OPT = {"lr": 3e-4, "betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 1e-4}
LOSS_RTOL = 2e-6
GRAD_TOL = 2e-5
PARAM_ATOL = 2e-7


def _weights():
    g = torch.Generator().manual_seed(5)
    inv = 1.0 / math.sqrt(E)

    def u(*shape, bound=inv):
        return (torch.rand(shape, generator=g) * 2 - 1) * bound

    return {"in_proj_weight": u(3 * E, E, bound=math.sqrt(6 / (4 * E))),
            "out_proj_weight": u(E, E), "in_proj_bias": u(3 * E),
            "out_proj_bias": u(E),
            "query": torch.randn((1, 1, E), generator=g) * math.sqrt(2 / E),
            "proj_w": u(P, E), "proj_b": u(P),
            "target_proj_w": u(P, E), "target_proj_b": u(P)}


def _inputs(rows=N):
    """The example's draw: each modality ``base + 0.5·N``, the target
    ``base + 0.3·N``; ``(kv (K, rows, M, E), target (K, rows, E))``."""
    g = torch.Generator().manual_seed(6)
    base = torch.randn((K, rows, 1, E), generator=g)
    kv = base + 0.5 * torch.randn((K, rows, M, E), generator=g)
    target = base[:, :, 0] + 0.3 * torch.randn((K, rows, E), generator=g)
    return kv, target


def _jax_params(w):
    w = {k: jnp.asarray(v.numpy()) for k, v in w.items()}
    return {"pool": AttentionPoolParams(
                in_proj_weight=w["in_proj_weight"],
                out_proj_weight=w["out_proj_weight"],
                in_proj_bias=w["in_proj_bias"],
                out_proj_bias=w["out_proj_bias"]),
            "query": w["query"],
            # the package's linear keeps nn.Linear's (out, in) layout
            "proj": LinearParams(w["proj_w"], w["proj_b"]),
            "target_proj": LinearParams(w["target_proj_w"],
                                        w["target_proj_b"])}


def _jax_leaves(tree) -> dict:
    """The JAX tree's leaves under the reference's names."""
    pool = tree["pool"]
    return {n: torch.from_numpy(np.array(x)) for n, x in zip(ref.LEAVES, (
        pool.in_proj_weight, pool.out_proj_weight, pool.in_proj_bias,
        pool.out_proj_bias, tree["query"], tree["proj"].weight,
        tree["proj"].bias, tree["target_proj"].weight,
        tree["target_proj"].bias))}


def _jax_run(kv, target, shards):
    """The example's ``local_step`` for K steps on a ``shards``-device
    mesh: each step's loss, each step's (global) gradients and the
    parameters after the last."""
    opt = optax.adamw(OPT["lr"])  # its defaults are OPT's

    def local_step(params, opt_state, modal, target, rng):
        axis_size = jax.lax.axis_size("data")
        shard_rng = jax.random.fold_in(rng, jax.lax.axis_index("data"))

        def loss_fn(p):
            fused, _, _, info = fusion_pool(
                p["pool"], p["query"], modal, rng=shard_rng, training=True,
                base_mask_prob=0.15, kv_grad=False)
            z = linear(p["proj"], fused.squeeze(1))
            t = linear(p["target_proj"], target)
            z = z / (jnp.linalg.norm(z, axis=-1, keepdims=True) + 1e-8)
            t = t / (jnp.linalg.norm(t, axis=-1, keepdims=True) + 1e-8)
            t_all = jax.lax.all_gather(t, "data").reshape(-1, t.shape[-1])
            logits = z @ t_all.T / TEMPERATURE
            local_b = z.shape[0]
            labels = jax.lax.axis_index("data") * local_b + jnp.arange(
                local_b)
            loss = optax.softmax_cross_entropy_with_integer_labels(
                logits, labels).mean()
            return loss / axis_size, info

        (scaled, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), opt_state,
                jax.lax.psum(scaled, "data"), grads)

    step = jax.jit(jax.shard_map(
        local_step, mesh=data_mesh(shards),
        in_specs=(PartitionSpec(), PartitionSpec(), PartitionSpec("data"),
                  PartitionSpec("data"), PartitionSpec()),
        out_specs=(PartitionSpec(),) * 4))
    params = _jax_params(_weights())
    opt_state = opt.init(params)
    losses, grads = [], []
    for i in range(K):
        params, opt_state, loss, g = step(
            params, opt_state, jnp.asarray(kv[i].numpy()),
            jnp.asarray(target[i].numpy()), jax.random.key(i))
        losses.append(float(loss))
        grads.append(_jax_leaves(g))
    return {"losses": losses, "grads": grads, "params": _jax_leaves(params)}


def _reference(kv, target, shards, **fault):
    B = kv.shape[1] // shards
    batches = [[(kv[i, s * B:(s + 1) * B], target[i, s * B:(s + 1) * B])
                for s in range(shards)] for i in range(K)]
    return ref.train(_weights(), batches, rng=SEED, precision="f32",
                     optimizer=OPT, temperature=TEMPERATURE, mask_prob=0.15,
                     min_active=1, **fault)


def _state():
    params = init_contrastive_params(None, E, P, device="cpu")
    leaves = param_leaves(params)
    w = _weights()
    with torch.no_grad():
        for p, name in zip(leaves, ref.LEAVES):
            p.copy_(w[name].reshape(p.shape))
    return TrainState(params, torch.optim.AdamW(leaves, **OPT))


def _settled(want_first):
    """Entries whose first reference gradient is more than round-off."""
    return {k: v.abs() > 1e-6 * v.abs().max() for k, v in want_first.items()}


def _leaf_gap(got, want):
    return float((got.reshape(-1) - want.reshape(-1)).norm()
                 / want.norm().clamp_min(1e-30))


@pytest.fixture(scope="module")
def world1():
    """K single steps at world 1, each step's gradients and masks kept,
    and the reference's global step over the same rows."""
    kv, target = _inputs(N // WORLD)
    state = _state()
    step = make_contrastive_train_step(temperature=TEMPERATURE)
    losses, grads, masks = [], [], []
    for i in range(K):
        state, loss, info = step(state, kv[i], target[i],
                                 fold_seed_words(SEED, state.step))
        losses.append(float(loss))
        grads.append({n: p.grad.clone() for n, p in
                      zip(ref.LEAVES, param_leaves(state.params))})
        masks.append(info["masked_attention_weights"][:, 0, :] > 0)
    params = {n: p.detach().clone()
              for n, p in zip(ref.LEAVES, param_leaves(state.params))}
    # without a mesh a step's draw takes the step's words unfolded
    return {"losses": losses, "grads": grads, "masks": torch.stack(masks),
            "params": params,
            "want": _reference(kv, target, 1, unfolded_masks=True),
            "jax": _jax_run(kv, target, 1)}


def _close_to_jax(got_params, got_grad, jax_run, leaf):
    """The port's last gradient and parameters of ``leaf`` against the
    JAX run's, at the tolerances the reference is held to; the entries
    whose first JAX gradient is round-off are left out of the
    parameters."""
    assert _leaf_gap(got_grad, jax_run["grads"][-1][leaf]) < GRAD_TOL
    want = jax_run["params"][leaf]
    keep = _settled(jax_run["grads"][0])[leaf]
    got = got_params.reshape(want.shape)
    assert keep.any()
    np.testing.assert_allclose(got[keep].numpy(), want[keep].numpy(),
                               atol=PARAM_ATOL, rtol=0)


def test_world1_losses_match_jax(world1):
    np.testing.assert_allclose(world1["losses"], world1["jax"]["losses"],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("leaf", ref.LEAVES)
def test_world1_matches_jax(world1, leaf):
    _close_to_jax(world1["params"][leaf], world1["grads"][-1][leaf],
                  world1["jax"], leaf)


def test_world1_losses(world1):
    np.testing.assert_allclose(world1["losses"],
                               world1["want"]["losses"].numpy(),
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("leaf", ref.LEAVES)
@pytest.mark.parametrize("which", ["first", "last"])
def test_world1_gradients(world1, leaf, which):
    got = world1["grads"][0 if which == "first" else -1][leaf]
    want = world1["want"][f"grads_{which}"][leaf]
    assert _leaf_gap(got, want) < GRAD_TOL


@pytest.mark.parametrize("leaf", ref.LEAVES)
def test_world1_parameters(world1, leaf):
    want = world1["want"]["params"][leaf]
    keep = _settled(world1["want"]["grads_first"])[leaf]
    got = world1["params"][leaf].reshape(want.shape)
    assert keep.any()
    np.testing.assert_allclose(got[keep].numpy(), want[keep].numpy(),
                               atol=PARAM_ATOL, rtol=0)


def test_world1_masks_bit_for_bit(world1):
    assert torch.equal(world1["masks"], world1["want"]["masks"][:, 0] > 0.5)


def test_world1_chunk_is_its_single_steps(world1):
    """The K-step chunk (eager on the CPU) gives the single steps' run bit
    for bit, and counts no collective without a mesh."""
    kv, target = _inputs(N // WORLD)
    state = _state()
    chunk = make_contrastive_scan_train_step(temperature=TEMPERATURE)
    before = dict(vars(collectives.counted))
    state, losses, infos = chunk(state, kv.reshape(K, N // WORLD, M * E),
                                 target, SEED)
    assert dict(vars(collectives.counted)) == before
    assert state.step == K
    assert losses.tolist() == pytest.approx(world1["losses"], rel=0, abs=0)
    for n, p in zip(ref.LEAVES, param_leaves(state.params)):
        assert torch.equal(p.detach(), world1["params"][n]), n
    assert set(infos) >= {"entropy", "mask_rate", "target_entropy"}


def test_target_shape_is_checked():
    kv, target = _inputs(8)
    chunk = make_contrastive_scan_train_step()
    with pytest.raises(ValueError, match="target must be"):
        chunk(_state(), kv.reshape(K, 8, M * E), target[:, :4], SEED)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    kv, target = _inputs()
    w = _weights()
    g = torch.Generator().manual_seed(7)
    inputs = {"kv": kv.numpy(), "target": target.numpy(),
              "seed": np.asarray(SEED),
              "leaves": np.asarray(ref.LEAVES),
              "gather_t": torch.randn((N, P), generator=g).numpy(),
              "gather_w": torch.randn((WORLD, N, P), generator=g).numpy()}
    inputs.update({f"w:{k}": v.numpy() for k, v in w.items()})
    outs = run_ranks("contrastive", WORLD,
                     tmp_path_factory.mktemp("contrastive"), inputs)
    return inputs, outs, _reference(kv, target, WORLD)


@pytest.fixture(scope="module")
def ranks_jax():
    if len(jax.devices()) < WORLD:
        pytest.skip(f"needs {WORLD} (virtual) devices")
    return _jax_run(*_inputs(), WORLD)


def test_ranks_losses_match_jax(ranks, ranks_jax):
    _, outs, _ = ranks
    for out in outs:
        np.testing.assert_allclose(out["losses"], ranks_jax["losses"],
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("leaf", ref.LEAVES)
def test_ranks_match_jax(ranks, ranks_jax, leaf):
    _, outs, _ = ranks
    for out in outs:
        _close_to_jax(torch.from_numpy(out[f"param:{leaf}"]),
                      torch.from_numpy(out[f"grad:{leaf}"]), ranks_jax, leaf)


def test_ranks_losses(ranks):
    _, outs, want = ranks
    for out in outs:
        np.testing.assert_allclose(out["losses"], want["losses"].numpy(),
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("leaf", ref.LEAVES)
def test_ranks_last_gradients(ranks, leaf):
    _, outs, want = ranks
    for out in outs:
        got = torch.from_numpy(out[f"grad:{leaf}"])
        assert _leaf_gap(got, want["grads_last"][leaf]) < GRAD_TOL


@pytest.mark.parametrize("leaf", ref.LEAVES)
def test_ranks_parameters(ranks, leaf):
    _, outs, want = ranks
    keep = _settled(want["grads_first"])[leaf]
    for out in outs:
        got = torch.from_numpy(out[f"param:{leaf}"]).reshape(keep.shape)
        np.testing.assert_allclose(got[keep].numpy(),
                                   want["params"][leaf][keep].numpy(),
                                   atol=PARAM_ATOL, rtol=0)


def test_ranks_stay_equal(ranks):
    _, outs, _ = ranks
    for leaf in ref.LEAVES:
        for out in outs[1:]:
            assert np.array_equal(out[f"param:{leaf}"],
                                  outs[0][f"param:{leaf}"]), leaf


def test_ranks_masks_bit_for_bit(ranks):
    _, outs, want = ranks
    for r, out in enumerate(outs):
        assert np.array_equal(out["masks"], want["masks"][:, r].numpy() > 0.5)


def test_row_gather_backward_is_the_concatenations(ranks):
    inputs, outs, _ = ranks
    for out in outs:
        np.testing.assert_array_equal(out["gather"], inputs["gather_t"])
        np.testing.assert_allclose(out["gather_grad"], out["concat_grad"],
                                   rtol=1e-6, atol=1e-6)
    # each rank's rows get every rank's cotangent, not its own alone
    B = N // WORLD
    np.testing.assert_allclose(outs[1]["gather_grad"],
                               inputs["gather_w"][:, B:].sum(0), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name", collectives.COLLECTIVES)
def test_ranks_count_k_of_each_collective(ranks, name):
    _, outs, _ = ranks
    sizes = {"all_reduce": None, "all_gather": N * P * 4,
             "reduce_scatter": N * P * 4}
    for out in outs:
        assert int(out[f"counted:{name}"]) == K
        if sizes[name] is not None:
            assert int(out[f"counted:{name}_bytes"]) == K * sizes[name]


def test_row_gather_without_a_group_is_the_rows():
    t = torch.randn(3, 2)
    assert collectives.all_gather_rows(t, None) is t


@pytest.mark.parametrize("shards", [1, WORLD])
def test_local_negatives_lie_outside_every_tolerance(shards):
    """InfoNCE over a shard's own targets: at one shard the same loss; over
    two shards the loss, gradients and parameters all leave their
    tolerances."""
    kv, target = _inputs(N if shards > 1 else N // WORLD)
    want = _reference(kv, target, shards)
    fault = _reference(kv, target, shards, local_negatives=True)
    gap = float(((fault["losses"] - want["losses"]).abs()
                 / want["losses"].abs()).max())
    grad = max(_leaf_gap(fault["grads_last"][k], want["grads_last"][k])
               for k in ref.LEAVES)
    keep = _settled(want["grads_first"])
    param = max(float((fault["params"][k] - want["params"][k])[keep[k]]
                      .abs().max()) for k in ref.LEAVES)
    if shards == 1:
        assert gap <= LOSS_RTOL and grad < GRAD_TOL
        return
    assert gap > 100 * LOSS_RTOL
    assert grad > 100 * GRAD_TOL
    assert param > 10 * PARAM_ATOL
