"""The torch route's one-query pool (``attention_pool_core`` at T = 1
without ``attn_mask``): scores and context as broadcast products summed
over ``Dh`` and ``S``, a shared query projected once in IEEE f32.

On the CPU: values and every gradient (the pool's four tensors, the
query — a shared query's summed over the batch — and the features)
against the einsum form written out here, to 1e-6 of the largest entry;
shared and per-row queries, H ∈ {1, 2, 4, 8}, M ∈ {2, 3}, with and
without biases, a key-padding mask (a fully padded row keeps the oracle's
NaN weights); T > 1 and ``attn_mask`` still on the einsums; the X-ray
pool's shape against the plain reference's formulation
(``perfbench/reference/xray.py``); ``ops.routes.torch_one_query``.

On the card (``card``): one X-ray chunk's CUDA graph launches no GEMV,
counts a one-query call for each torch-route call, and equals the eager
route bit for bit.  This file imports no JAX: ``python -m pytest
--noconftest tests/test_torch_port_one_query_pool.py -m card``.
"""

import math

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from aecf_tpu_torch import ops
from aecf_tpu_torch.core import (
    AttentionPoolParams,
    PoolTensors,
    attention_pool_core,
)
from aecf_tpu_torch.core.attention import _merge_masks
from perfbench.reference.common import mm

B, E = 6, 32


def _einsum_pool(params, query, key, value, *, num_heads,
                 key_padding_mask=None, attn_mask=None):
    """The einsum form: the query expanded to the batch and projected row
    by row, scores and context as batched products over ``B·H``."""
    Bk, S, Ek = key.shape
    H, Dh = num_heads, Ek // num_heads
    query = query.expand(Bk, *query.shape[1:])
    T = query.shape[1]
    w_q, w_k, w_v = params.in_proj_weight.chunk(3, dim=0)
    b_q, b_k, b_v = (params.in_proj_bias.chunk(3, dim=0)
                     if params.in_proj_bias is not None else (None,) * 3)

    def proj(x, w, b):
        y = torch.einsum("bse,fe->bsf", x, w)
        return y if b is None else y + b

    q = proj(query, w_q, b_q).reshape(Bk, T, H, Dh)
    k = proj(key, w_k, b_k).reshape(Bk, S, H, Dh)
    v = proj(value, w_v, b_v).reshape(Bk, S, H, Dh)
    scores = torch.einsum("bthd,bshd->bhts", q * float(Dh) ** -0.5, k)
    attn = torch.softmax(
        _merge_masks(scores, key_padding_mask, attn_mask), dim=-1)
    context = torch.einsum("bhts,bshd->bthd", attn, v).reshape(Bk, T, Ek)
    out = torch.einsum("bte,fe->btf", context, params.out_proj_weight)
    if params.out_proj_bias is not None:
        out = out + params.out_proj_bias
    return out, attn.mean(dim=1)


def _inputs(seed, *, M, H, rows, bias, width=E, batch=B, T=1):
    """Pool tensors at the reference's init scales, a query of ``rows``
    rows (1: shared) and features, each requiring gradients; fixed
    cotangents for the output and the weights."""
    g = torch.Generator().manual_seed(seed)
    bound = math.sqrt(6.0 / (4 * width))
    tensors = {
        "in_proj_weight": (torch.rand((3 * width, width), generator=g)
                           * 2 - 1) * bound,
        "out_proj_weight": (torch.rand((width, width), generator=g) * 2 - 1)
        * width ** -0.5,
        "in_proj_bias": 0.1 * torch.randn(3 * width, generator=g),
        "out_proj_bias": 0.1 * torch.randn(width, generator=g),
    }
    if not bias:
        tensors["in_proj_bias"] = tensors["out_proj_bias"] = None
    leaves = {k: None if v is None else v.requires_grad_()
              for k, v in tensors.items()}
    query = torch.randn((rows, T, width), generator=g).requires_grad_()
    kv = torch.randn((batch, M, width), generator=g).requires_grad_()
    cot = (torch.randn((batch, T, width), generator=g),
           torch.randn((batch, T, M), generator=g))
    return leaves, query, kv, cot


def _grads(fn, leaves, query, kv, cot):
    """``fn``'s output and weights, and the gradients of ``out · cot₀ +
    weights · cot₁`` with respect to every tensor that requires one."""
    params = AttentionPoolParams(**leaves)
    out, w = fn(params, query, kv)
    wrt = [query, kv] + list(params.parameters())
    loss = (out * cot[0]).sum() + (w * cot[1]).sum()
    return out, w, torch.autograd.grad(loss, wrt)


def _close(got, want):
    """Within 1e-6 of ``want``'s largest entry (NaNs where ``want``'s)."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    got, want = got[~nan], want[~nan]
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-6 * scale


class _Products(TorchDispatchMode):
    """The batch of every ``aten.mm``/``bmm``/``addmm`` dispatched."""

    def __init__(self):
        super().__init__()
        self.batches = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.bmm.default:
            self.batches.append(args[0].shape[0])
        elif func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.batches.append(1)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mask", [None, "partial"])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("M", [2, 3])
@pytest.mark.parametrize("H", [1, 2, 4, 8])
@pytest.mark.parametrize("rows", [1, B], ids=["shared", "per-row"])
def test_one_query_form_equals_the_einsums(rows, H, M, bias, mask):
    """Output, weights and every gradient against the einsum form; no
    product batched over the rows or heads, forward or backward."""
    leaves, query, kv, cot = _inputs(H * 10 + M, M=M, H=H, rows=rows,
                                     bias=bias)
    kpm = None
    if mask == "partial":  # every other row loses its last slot
        kpm = torch.zeros((B, M), dtype=torch.bool)
        kpm[::2, -1] = True

    def one(p, q, x):
        return attention_pool_core(p, q, x, x, num_heads=H,
                                   key_padding_mask=kpm)

    def oracle(p, q, x):
        return _einsum_pool(p, q, x, x, num_heads=H, key_padding_mask=kpm)

    with _Products() as spy:
        got = _grads(one, leaves, query, kv, cot)
    want = _grads(oracle, leaves, query, kv, cot)
    assert spy.batches and set(spy.batches) == {1}, spy.batches
    for g, w in zip(got[:2] + tuple(got[2]), want[:2] + tuple(want[2])):
        assert g.shape == w.shape
        _close(g, w)


@pytest.mark.parametrize("H", [1, 4])
@pytest.mark.parametrize("rows", [1, B], ids=["shared", "per-row"])
def test_a_fully_padded_row_keeps_nan_weights(rows, H):
    """A row whose every slot is padding reads NaN weights and output, as
    the oracle's; the other rows equal the einsum form's."""
    leaves, query, kv, _ = _inputs(7 + H, M=3, H=H, rows=rows, bias=True)
    kpm = torch.zeros((B, 3), dtype=torch.bool)
    kpm[1] = True
    kpm[4, 0] = True
    params = AttentionPoolParams(**leaves)
    out, w = attention_pool_core(params, query, kv, kv, num_heads=H,
                                 key_padding_mask=kpm)
    out_o, w_o = _einsum_pool(params, query, kv, kv, num_heads=H,
                              key_padding_mask=kpm)
    assert bool(torch.isnan(w[1]).all()) and bool(torch.isnan(out[1]).all())
    _close(w.detach(), w_o.detach())
    _close(out.detach(), out_o.detach())


def test_expanded_query_is_projected_once():
    """A query expanded to the batch (stride 0) takes the shared form: the
    shared query's values and gradient, no product over its rows."""
    leaves, query, kv, cot = _inputs(3, M=2, H=4, rows=1, bias=True)
    params = AttentionPoolParams(**leaves)
    with _Products() as spy:
        out, w = attention_pool_core(params, query.expand(B, 1, E), kv, kv,
                                     num_heads=4)
    # the K and V projections and the out projection: three products
    assert spy.batches == [1, 1, 1]
    out_s, w_s = attention_pool_core(params, query, kv, kv, num_heads=4)
    assert torch.equal(out, out_s) and torch.equal(w, w_s)


@pytest.mark.parametrize("case", ["tokens", "attn_mask"])
def test_more_tokens_or_an_attn_mask_take_the_einsums(monkeypatch, case):
    """T > 1, or an ``attn_mask`` at T = 1, keeps the batched score and
    context einsums (and their values)."""
    T = 3 if case == "tokens" else 1
    leaves, query, kv, cot = _inputs(5, M=3, H=2, rows=1, bias=True, T=T)
    am = None
    if case == "attn_mask":
        am = torch.zeros((B, 1, 3), dtype=torch.bool)
        am[0, 0, 2] = True
    seen, real = [], torch.einsum

    def spy(eq, *operands):
        seen.append(eq)
        return real(eq, *operands)

    monkeypatch.setattr(torch, "einsum", spy)
    params = AttentionPoolParams(**leaves)
    out, w = attention_pool_core(params, query, kv, kv, num_heads=2,
                                 attn_mask=am)
    assert "bthd,bshd->bhts" in seen and "bhts,bshd->bthd" in seen
    monkeypatch.setattr(torch, "einsum", real)
    out_o, w_o = _einsum_pool(params, query, kv, kv, num_heads=2,
                              attn_mask=am)
    assert torch.equal(out, out_o) and torch.equal(w, w_o)
    seen.clear()
    monkeypatch.setattr(torch, "einsum", spy)
    attention_pool_core(params, query[:, :1], kv, kv, num_heads=2)
    assert "bthd,bshd->bhts" not in seen and "bhts,bshd->bthd" not in seen


def _reference_pool(p, fusion_query, kv, H):
    """The X-ray pool as ``perfbench/reference/xray.py`` (lines 103-110)
    writes it, in IEEE f32: output (B, E) and weights (B, 2)."""
    Bk, _, Ek = kv.shape
    wq, wk, wv = p["in_proj_weight"].chunk(3, dim=0)
    bq, bk, bv = p["in_proj_bias"].chunk(3, dim=0)
    dh = Ek // H
    q = (mm(fusion_query.reshape(1, Ek), wq.T, "f32") + bq).reshape(H, dh)
    rows = kv.reshape(Bk * 2, Ek)
    k = (mm(rows, wk.T, "f32") + bk).reshape(Bk, 2, H, dh)
    v = (mm(rows, wv.T, "f32") + bv).reshape(Bk, 2, H, dh)
    scores = (k * q[None, None]).sum(-1) / math.sqrt(dh)
    a = torch.softmax(scores, dim=1)
    ctx = (a[..., None] * v).sum(1).reshape(Bk, Ek)
    pooled = mm(ctx, p["out_proj_weight"].T, "f32") + p["out_proj_bias"]
    return pooled, a.mean(dim=2)


def test_xray_pool_shape_equals_the_plain_reference():
    """B=64, M=2, E=256, H=4, the model's shared ``(1, 1, E)`` query:
    output, weights and every gradient against the reference's
    formulation."""
    H, Bx, Ex = 4, 64, 256
    leaves, query, kv, cot = _inputs(11, M=2, H=H, rows=1, bias=True,
                                     width=Ex, batch=Bx)

    def ours(p, q, x):
        return attention_pool_core(p, q, x, x, num_heads=H)

    def reference(p, q, x):
        out, w = _reference_pool(PoolTensors.of(p)._asdict(), q, x, H)
        return out[:, None], w[:, None]

    got = _grads(ours, leaves, query, kv, cot)
    want = _grads(reference, leaves, query, kv, cot)
    for g, w in zip(got[:2] + tuple(got[2]), want[:2] + tuple(want[2])):
        _close(g, w)


def test_torch_one_query_counts_the_calls_that_take_the_form():
    """``routes.torch_one_query`` counts torch-route calls at T = 1
    (shared and per-row queries) and neither the kernel route's calls nor
    a torch-route call at T > 1."""
    leaves, query, kv, _ = _inputs(2, M=3, H=4, rows=1, bias=True)
    params = AttentionPoolParams(**leaves)
    r = ops.routes

    def calls(q, implementation, H=4):
        before = r.torch_route, r.torch_one_query, r.kernel_route
        ops.fusion_pool(params, q, kv, num_heads=H,
                        implementation=implementation)
        return (r.torch_route - before[0], r.torch_one_query - before[1],
                r.kernel_route - before[2])

    assert calls(query, "torch") == (1, 1, 0)
    assert calls(query.detach().expand(B, 1, E).clone(), "torch") == (1, 1, 0)
    assert calls(query, "auto") == (1, 1, 0)  # CPU features: the torch route
    assert calls(query, "kernel", H=1) == (0, 0, 1)
    three = torch.randn((B, 3, E))
    assert calls(three, "torch") == (1, 0, 0)


# ---- on the card ------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the chunk's CUDA graph")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_xray_chunk_graph_launches_no_gemv(card, precision):
    """One X-ray chunk (K=2, the cell's widths): its profiled replay
    launches no GEMV, each replay adds K torch-route calls and K
    one-query calls, and the graph equals K eager steps bit for bit."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from aecf_tpu_torch.core import matmul_precision
    from aecf_tpu_torch.kernels.draws import fold_seed_words
    from aecf_tpu_torch.models import XrayAECFModel
    from aecf_tpu_torch.train import (
        TrainState,
        make_scan_train_step,
        make_train_step,
    )

    I, T, Ex, C, H, Bx, K = 512, 512, 256, 14, 4, 4096, 2
    rng = 2**40 + 29

    def state():
        model = XrayAECFModel(I, T, C, hidden_dim=Ex, num_heads=H,
                              generator=torch.Generator().manual_seed(0),
                              device=card)
        return TrainState(model, torch.optim.AdamW(
            model.parameters(), lr=1e-3, weight_decay=0.01, capturable=True))

    def apply(model, images, texts, generator):
        model.train()
        return model(images, texts, generator=generator,
                     curriculum_enabled=True, missing_modality_training=True,
                     return_info=True)

    g = torch.Generator().manual_seed(1)
    img = torch.randn((K, Bx, I), generator=g).to(card)
    txt = torch.randn((K, Bx, T), generator=g).to(card)
    lab = (torch.rand((K, Bx, C), generator=g) < 0.25).float().to(card)
    chunk, single = make_scan_train_step(apply), make_train_step(apply)
    graphed, eager = state(), state()
    r = ops.routes
    with matmul_precision(precision):
        for call in range(2):
            before = r.torch_route, r.torch_one_query
            if call:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    graphed, losses, _ = chunk(graphed, img, txt, lab, rng)
                    torch.cuda.synchronize()
                assert r.torch_route - before[0] == K
            else:
                graphed, losses, _ = chunk(graphed, img, txt, lab, rng)
                torch.cuda.synchronize()
            assert (r.torch_one_query - before[1]
                    == r.torch_route - before[0])
            want = []
            for i in range(K):
                eager, loss, _ = single(eager, img[i], txt[i], lab[i],
                                        fold_seed_words(rng, eager.step))
                want.append(loss)
            assert torch.equal(losses, torch.stack(want))
            for p, q in zip(graphed.params.parameters(),
                            eager.params.parameters()):
                assert torch.equal(p, q)
    kernels = [e.name() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
    assert kernels, "the profiler recorded no device operation"
    assert not [n for n in kernels if "gemv" in n.lower()], kernels
    assert next(iter(chunk._graphs.values())).replays == 2
