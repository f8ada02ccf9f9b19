"""InfoNCE's loss and gradient in one kernel (``kernels/infonce.py``,
``csrc/infonce.cu``).

On the CPU: the plain version against ATen's route as the contrastive
step took it before the kernel (``F.cross_entropy(raw / τ, labels,
reduction="none") · scale`` and its autograd gradient with respect to the
raw product), at row widths below, at and above a block's vector width
and past the kernel's resident rows, with the labels of the first and the
last shard; the wrapper's refusals; and the contrastive step at world 1
against the pre-kernel step written out here.  Tolerance ``1e-6``
relative (the gradient's to its largest entry): the two differ only where
``exp`` rounds another way on a value near zero.

On the card (``card``): the kernel against the plain version on the same
tensors, on its resident rows (16-byte and scalar loads) and its two-pass
rows; two calls bit for bit; a contrastive chunk's replay adding K
launches and equal to its eager single steps bit for bit.

This file imports no JAX, so the ``card`` tests run on a machine without
it: ``python -m pytest --noconftest tests/test_torch_port_infonce.py -m
card``.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from aecf_tpu_torch.kernels import (
    fused_pool_train_step,
    infonce_rows,
    infonce_rows_plain,
    shared_query_fwd,
)
from aecf_tpu_torch.kernels.draws import fold_seed_words
from aecf_tpu_torch.train import (
    TrainState,
    init_contrastive_params,
    make_contrastive_scan_train_step,
    make_contrastive_train_step,
    param_leaves,
)
from aecf_tpu_torch.train.contrastive import _normalise
from aecf_tpu_torch.train.update import _make_step

TAU = 0.07
REL = 1e-6
SHAPES = [(1, 1), (3, 5), (64, 256), (16, 8195)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the InfoNCE kernel is CUDA's")
    return torch.device("cuda")


def _raw(B, N, device="cpu", seed=0):
    """The contrastive step's raw product: unit rows of z against unit
    rows of the gathered targets, so ``raw / τ`` spans ``±1/τ``."""
    g = torch.Generator(device).manual_seed(seed)
    z = F.normalize(torch.randn((B, 32), generator=g, device=device), dim=1)
    t = F.normalize(torch.randn((N, 32), generator=g, device=device), dim=1)
    return z @ t.T


def _aten(raw, label_offset, scale):
    """The pre-kernel route: row losses and the gradient of their sum with
    respect to ``raw``."""
    r = raw.clone().requires_grad_(True)
    labels = torch.arange(raw.shape[0], device=raw.device) + label_offset
    rows = F.cross_entropy(r / TAU, labels, reduction="none") * scale
    (grad,) = torch.autograd.grad(rows.sum(), r)
    return rows.detach(), grad


def _close(got, want, rel):
    torch.testing.assert_close(got, want, rtol=rel,
                               atol=rel * float(want.abs().max()))


@pytest.mark.parametrize("shard", ["first", "last"])
@pytest.mark.parametrize("B,N", SHAPES)
def test_plain_matches_aten(B, N, shard):
    offset = 0 if shard == "first" else (N // B - 1) * B
    raw = _raw(B, N)
    scale = 0.25 / B
    want_rows, want_grad = _aten(raw, offset, scale)
    launches = infonce_rows.launches
    rows = infonce_rows(raw, label_offset=offset, temperature=TAU,
                        scale=scale)
    assert infonce_rows.launches == launches  # the plain version counts none
    assert rows.shape == (B,) and raw.shape == (B, N)
    _close(rows, want_rows, REL)
    _close(raw, want_grad, REL)  # raw now holds the gradient


@pytest.mark.parametrize("case", [
    "past_the_row", "negative_offset", "non_contiguous", "float64", "1-d",
    "empty", "meta",
])
def test_wrapper_refuses(case):
    raw, offset = torch.zeros((4, 8)), 0
    if case == "past_the_row":
        offset = 5
    elif case == "negative_offset":
        offset = -1
    elif case == "non_contiguous":
        raw = torch.zeros((8, 4)).T
    elif case == "float64":
        raw = raw.double()
    elif case == "1-d":
        raw = torch.zeros(8)
    elif case == "empty":
        raw = torch.zeros((0, 8))
    else:
        raw = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError):
        infonce_rows(raw, label_offset=offset, temperature=TAU, scale=1.0)


# ---- the contrastive step against the pre-kernel step -----------------------

E, M, P, B = 32, 3, 8, 12


def _pre_kernel_local_step(temperature):
    """The contrastive local step at world 1 as it was before the kernel:
    InfoNCE through ATen's cross-entropy and autograd."""

    def local_step(params, kv, target, generator, loss_scale, **staged):
        proj, tproj = params["proj"], params["target_proj"]
        leaves = list(proj.parameters()) + list(tproj.parameters())
        head_grads = []

        def infonce(out, tgt):
            n = out.shape[0]
            with torch.enable_grad():
                x = out.detach().requires_grad_(True)
                z = _normalise(F.linear(x, proj.weight, proj.bias))
                t = _normalise(F.linear(tgt, tproj.weight, tproj.bias))
                logits = z @ t.T / temperature
                labels = torch.arange(n, device=out.device)
                rows = F.cross_entropy(logits, labels, reduction="none")
                rows = rows * (loss_scale / n)
                grads = torch.autograd.grad(rows.sum(), [x] + leaves)
            head_grads.extend(grads[1:])
            return rows.detach(), grads[0]

        loss, d_pool, d_query, _, info = fused_pool_train_step(
            params["pool"], params["query"], kv, generator=generator,
            training=True, base_mask_prob=0.15, entropy_target=0.7,
            min_active=1, precision="default", kv_grad=False,
            row_loss=infonce, row_extras=(target,), loss_scale=loss_scale,
            **staged)
        names = [n for n, _ in params["pool"].named_parameters()]
        grads = [d_pool[n] for n in names] + [d_query] + head_grads
        return loss, info, grads

    return local_step


def _state(device="cpu", capturable=False):
    params = init_contrastive_params(torch.Generator().manual_seed(3), E, P,
                                     device=device)
    return TrainState(params, torch.optim.AdamW(
        param_leaves(params), lr=3e-4, weight_decay=1e-4,
        capturable=capturable))


def _batch(steps, device="cpu"):
    g = torch.Generator().manual_seed(4)
    base = torch.randn((steps, B, 1, E), generator=g)
    kv = base + 0.5 * torch.randn((steps, B, M, E), generator=g)
    target = base[:, :, 0] + 0.3 * torch.randn((steps, B, E), generator=g)
    return kv.to(device), target.to(device)


@pytest.mark.parametrize("temperature", [0.1, 0.05])
def test_step_matches_the_pre_kernel_step(temperature):
    kv, target = _batch(2)
    got_state, want_state = _state(), _state()
    step = make_contrastive_train_step(temperature=temperature)
    want_step = _make_step(_pre_kernel_local_step(temperature))
    for i in range(2):
        words = fold_seed_words(9, i)
        got_state, got, _ = step(got_state, kv[i], target[i], words)
        want_state, want, _ = want_step(want_state, kv[i], target[i], words)
        _close(got, want, REL)
        for p, q in zip(param_leaves(got_state.params),
                        param_leaves(want_state.params)):
            _close(p.grad, q.grad, REL)


# ---- on the card -------------------------------------------------------------

CARD_CASES = [(2048, 8192, 0), (2048, 8192, 6144), (1024, 1024, 0),
              (7, 1003, 0), (7, 1003, 996), (64, 65536, 0), (3, 65533, 7)]


@pytest.mark.card
@pytest.mark.parametrize("B,N,offset", CARD_CASES)
def test_kernel_matches_plain(card, B, N, offset):
    raw = _raw(B, N, card)
    scale = 0.25 / B
    plain = raw.clone()
    want = infonce_rows_plain(plain, label_offset=offset, temperature=TAU,
                              scale=scale)
    launches = infonce_rows.launches
    got = infonce_rows(raw, label_offset=offset, temperature=TAU,
                       scale=scale)
    torch.cuda.synchronize()
    assert infonce_rows.launches == launches + 1
    # the sums' order differs: a few ulps of log s, carried into exp(o)
    _close(got, want, 1e-5)
    _close(raw, plain, 1e-5)


@pytest.mark.card
@pytest.mark.parametrize("B,N", [(2048, 8192), (7, 1003), (64, 65536)])
def test_two_calls_are_equal(card, B, N):
    raw = _raw(B, N, card, seed=1)
    again = raw.clone()
    rows = infonce_rows(raw, label_offset=0, temperature=TAU, scale=1 / B)
    rows2 = infonce_rows(again, label_offset=0, temperature=TAU, scale=1 / B)
    assert torch.equal(rows, rows2) and torch.equal(raw, again)


@pytest.mark.card
def test_chunk_replay_counts_and_equals_its_single_steps(card):
    K = 3
    kv, target = _batch(K, card)
    chunk = make_contrastive_scan_train_step(temperature=0.1)
    single = make_contrastive_train_step(temperature=0.1)
    graphed, eager = _state(card, True), _state(card, True)
    for call in range(2):
        fwd, nce = shared_query_fwd.launches, infonce_rows.launches
        graphed, losses, _ = chunk(graphed, kv.reshape(K, B, M * E), target,
                                   17)
        torch.cuda.synchronize()
        added = infonce_rows.launches - nce
        assert added == shared_query_fwd.launches - fwd
        if call:  # the first call also runs the capture's warm-up step
            assert added == K
        want = []
        for i in range(K):
            eager, loss, _ = single(eager, kv[i], target[i],
                                    fold_seed_words(17, eager.step))
            want.append(loss)
        assert torch.equal(losses, torch.stack(want))
        for p, q in zip(param_leaves(graphed.params),
                        param_leaves(eager.params)):
            assert torch.equal(p, q)
    assert len(chunk._graphs) == 1
    assert all(math.isfinite(x) for x in losses.tolist())
