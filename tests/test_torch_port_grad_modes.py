"""The matmul mode of the port's backward passes, against JAX's rule.

JAX binds the precision into every dot it traces, the transposed dots of
a gradient among them: the torch route's gradients run at the mode its
forward's ``precision`` names, and the per-row kernel's backward
(``_fused_bwd_impl``) under ``"highest"`` whatever the caller set.  The
port enters that mode inside each backward
(:func:`aecf_tpu_torch.core.run_at`, ``_FusedPool.backward``).

A :class:`~torch_parallel_workers.MatmulModeSpy` records torch's float32
matmul mode at every ``aten.mm``/``bmm``/``addmm`` of a backward, for
each process mode (``'high'``, ``'medium'``, ``'highest'``), precision
(``'highest'``, ``'default'``) and site: the per-row kernel #7 at H=1 and
H=4 (its plain forward on the CPU), ``ops.fusion_pool``'s torch route at
H=4, ``MultimodalAttentionPool``'s torch route at H=4 (plain, with
``use_checkpoint=True``, with ``apply_masking_to_output=True``, and both),
and the TP pool on a gloo mesh of two CPU processes.  Every backward
product must run at the forward's mode (IEEE for #7 always), and the
process's mode must come back after a full backward, a partial one
(``torch.autograd.grad`` with respect to the query only) and one that
raises.  The repaired route's ``'highest'`` gradients are held to
``jax.grad`` of JAX's ``fusion_pool`` at ``'highest'`` (rtol 2e-4, atol
2e-5, the f32 tolerances of ``test_torch_port_heads.py``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aecf_tpu.core.attention import AttentionPoolParams as JaxParams
from aecf_tpu.ops import fusion_pool as jax_fusion_pool
from aecf_tpu_torch import ops
from aecf_tpu_torch.convert import attention_pool_from_numpy
from aecf_tpu_torch.core import AttentionPoolParams
from aecf_tpu_torch.nn import CurriculumMasking, MultimodalAttentionPool
from torch_parallel_workers import (
    GRAD_KINDS,
    GRAD_PRECISIONS,
    GRAD_PROCESS_MODES,
    backward_under_spy,
    run_ranks,
)

POOL = ("in_proj_weight", "in_proj_bias", "out_proj_weight", "out_proj_bias")
B, M, E = 6, 3, 16
TOL = dict(rtol=2e-4, atol=2e-5)
SITES = ("fused-h1", "fused-h4", "ops-h4", "module-h4", "module-h4-ckpt",
         "module-h4-masked-out", "module-h4-ckpt-masked-out")


@pytest.fixture
def process_mode():
    before = torch.get_float32_matmul_precision()
    yield
    torch.set_float32_matmul_precision(before)


def _arrays(seed):
    """Pool parameters at the reference's init scales (biases nonzero), a
    per-row query (B, 1, E), a shared one (1, 1, E) and features."""
    rng = np.random.default_rng(seed)
    bound = math.sqrt(6.0 / (4 * E))
    arrs = {
        "in_proj_weight": rng.uniform(-bound, bound, (3 * E, E)),
        "out_proj_weight": rng.uniform(-E ** -0.5, E ** -0.5, (E, E)),
        "in_proj_bias": 0.1 * rng.standard_normal(3 * E),
        "out_proj_bias": 0.1 * rng.standard_normal(E),
        "rows": rng.standard_normal((B, 1, E)),
        "q": rng.standard_normal((1, 1, E)),
        "kv": rng.standard_normal((B, M, E)),
    }
    return {k: v.astype(np.float32) for k, v in arrs.items()}


def _want(site, precision):
    """torch's mode every backward product of ``site`` must run at."""
    if site.startswith("fused") or precision == "highest":
        return "highest"
    return "high"  # 'default': TF32 on the card


def _site_loss(site, precision, x):
    """``(loss, query)`` of one forward of ``site`` on ``x``'s inputs, its
    parameters, query and features requiring gradients; the query is the
    leaf a partial backward takes."""
    kv = torch.from_numpy(x["kv"]).requires_grad_()
    if site.startswith("fused"):
        H = 1 if site == "fused-h1" else 4
        params = AttentionPoolParams(**{
            k: torch.from_numpy(x[k]) for k in POOL})
        q = torch.from_numpy(x["rows"]).requires_grad_()
        out, w, _, info = ops.fusion_pool(
            params, q, kv, num_heads=H, implementation="kernel",
            precision=precision)
        return (out ** 2).sum() + w.sum() + 0.1 * info["entropy"].sum(), q
    q = torch.from_numpy(x["q"]).requires_grad_()
    if site == "ops-h4":
        params = AttentionPoolParams(**{
            k: torch.from_numpy(x[k]) for k in POOL})
        out, w, _, info = ops.fusion_pool(
            params, q, kv, num_heads=4, implementation="torch",
            precision=precision)
        return (out ** 2).sum() + w.sum() + 0.1 * info["entropy"].sum(), q
    pool = MultimodalAttentionPool(
        E, num_heads=4, curriculum_masking=CurriculumMasking(),
        implementation="torch", precision=precision,
        apply_masking_to_output=site.endswith("masked-out"), device="cpu")
    attention_pool_from_numpy(pool, {k: x[k] for k in POOL})
    out, info = pool.train()(
        q, kv, generator=torch.Generator().manual_seed(7), return_info=True,
        use_checkpoint="ckpt" in site)
    return (out ** 2).sum() + info["attention_weights"].sum(), q


@pytest.mark.parametrize("site", SITES)
@pytest.mark.parametrize("precision", GRAD_PRECISIONS)
@pytest.mark.parametrize("process", GRAD_PROCESS_MODES)
def test_backward_products_run_at_the_forwards_mode(process_mode, site,
                                                    precision, process):
    """Every backward product runs at the forward's mode — IEEE for the
    per-row kernel at every precision — whatever the process set, and
    the process's mode is its own again afterwards."""
    torch.set_float32_matmul_precision(process)
    loss, _ = _site_loss(site, precision, _arrays(10))
    spy = backward_under_spy(loss, "full")
    assert spy.seen, "the backward ran no product"
    assert set(spy.seen) == {_want(site, precision)}, spy.seen
    assert torch.get_float32_matmul_precision() == process


@pytest.mark.parametrize("site", SITES)
@pytest.mark.parametrize("precision", GRAD_PRECISIONS)
@pytest.mark.parametrize("kind,process", [("partial", "medium"),
                                          ("raise", "high")])
def test_partial_and_raising_backwards_restore_the_mode(
        process_mode, site, precision, kind, process):
    """A backward taken with respect to the query only runs its products
    at the forward's mode too, and it and a backward whose first product
    raises both leave the process at its own mode."""
    torch.set_float32_matmul_precision(process)
    loss, q = _site_loss(site, precision, _arrays(11))
    spy = backward_under_spy(loss, kind, wrt=[q])
    assert spy.seen and set(spy.seen) == {_want(site, precision)}, spy.seen
    assert torch.get_float32_matmul_precision() == process


@pytest.fixture(scope="module")
def tp_ranks(tmp_path_factory):
    x = _arrays(12)
    inputs = {f"pool:{k}": x[k] for k in POOL}
    inputs.update(q=x["q"], kv=x["kv"])
    return run_ranks("grad_modes", 2, tmp_path_factory.mktemp("grad_modes"),
                     inputs)


@pytest.mark.parametrize("kind", GRAD_KINDS)
@pytest.mark.parametrize("precision", GRAD_PRECISIONS)
@pytest.mark.parametrize("process", GRAD_PROCESS_MODES)
def test_tp_pool_backward_runs_at_the_forwards_mode(tp_ranks, process,
                                                    precision, kind):
    """The TP pool (H=4 over two gloo ranks): on every rank each backward
    product runs at the forward's mode — the collectives stay outside the
    block — and the process's mode comes back after a full, a partial and
    a raising backward."""
    tag = f"{process}:{precision}:{kind}"
    for out in tp_ranks:
        modes = [str(m) for m in out[f"{tag}:modes"]]
        assert modes and set(modes) == {_want("tp", precision)}, modes
        assert str(out[f"{tag}:after"]) == process


def _jax_grads(x, H, entropy):
    """``jax.grad`` of JAX's ``fusion_pool`` (its XLA path, eval) at
    ``'highest'`` with respect to the pool, the shared query and the
    features; the loss takes the entropy where ``entropy``."""

    def loss(p, q, kv):
        out, w, _, info = jax_fusion_pool(
            p, q, kv, num_heads=H, implementation="xla",
            precision="highest")
        ent = 0.1 * jnp.sum(info["entropy"]) if entropy else 0.0
        return jnp.sum(out ** 2) + jnp.sum(w) + ent

    params = JaxParams(**{k: jnp.asarray(x[k]) for k in POOL})
    return jax.value_and_grad(loss, (0, 1, 2))(
        params, jnp.asarray(x["q"]), jnp.asarray(x["kv"]))


@pytest.mark.parametrize("H", [1, 4])
@pytest.mark.parametrize("route", ["ops", "module", "module-ckpt"])
def test_highest_gradients_match_jax_under_a_tf32_process(process_mode, route,
                                                          H):
    """With the process at torch's ``'high'``, the torch route's
    ``'highest'`` gradients — through ``run_at``'s inner graph, and
    through the checkpoint's recompute inside it — equal ``jax.grad`` of
    JAX's function at ``'highest'``.  ``ops.fusion_pool`` runs eval, its
    loss taking the entropy; the module runs training (its entropy is
    detached there, quirk Q2), whose output and weights are eval's (quirk
    Q1: the mask never reaches the output)."""
    torch.set_float32_matmul_precision("high")
    x = _arrays(20 + H)
    loss_j, (dp_j, dq_j, dkv_j) = _jax_grads(x, H, entropy=route == "ops")
    q = torch.from_numpy(x["q"]).requires_grad_()
    kv = torch.from_numpy(x["kv"]).requires_grad_()
    if route == "ops":
        params = AttentionPoolParams(**{
            k: torch.from_numpy(x[k].copy()).requires_grad_() for k in POOL})
        out, w, _, info = ops.fusion_pool(
            params, q, kv, num_heads=H, implementation="torch",
            precision="highest")
        loss = (out ** 2).sum() + w.sum() + 0.1 * info["entropy"].sum()
    else:
        pool = MultimodalAttentionPool(
            E, num_heads=H, curriculum_masking=CurriculumMasking(),
            implementation="torch", device="cpu")
        attention_pool_from_numpy(pool, {k: x[k] for k in POOL})
        params = pool.params
        out, info = pool.train()(
            q, kv, generator=torch.Generator().manual_seed(3),
            return_info=True, use_checkpoint=route == "module-ckpt")
        loss = (out ** 2).sum() + info["attention_weights"].sum()
    loss.backward()
    assert torch.get_float32_matmul_precision() == "high"
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-6)
    for name in POOL:
        np.testing.assert_allclose(
            getattr(params, name).grad.numpy(),
            np.asarray(getattr(dp_j, name)), **TOL, err_msg=name)
    np.testing.assert_allclose(q.grad.numpy(), np.asarray(dq_j), **TOL)
    np.testing.assert_allclose(kv.grad.numpy(), np.asarray(dkv_j), **TOL)


def test_run_at_keeps_its_graph_as_the_backward_asks(process_mode):
    """``run_at``'s inner graph lives as long as the outer one: a backward
    with ``retain_graph=True`` may be taken again, with the same
    gradients, and one without it frees the graph, so a second backward
    raises as autograd's own does — the process's mode restored each
    time."""
    from aecf_tpu_torch.core import run_at

    torch.set_float32_matmul_precision("medium")
    x = _arrays(13)
    w = torch.from_numpy(x["out_proj_weight"]).requires_grad_()
    kv = torch.from_numpy(x["kv"])
    out = run_at("highest", lambda a, b: (b @ a.T).square().sum(), w, kv)
    out.backward(retain_graph=True)
    first = w.grad.clone()
    w.grad = None
    out.backward()
    torch.testing.assert_close(w.grad, first, rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="second time"):
        out.backward()
    assert torch.get_float32_matmul_precision() == "medium"
