"""The pool chunk on the streamed split (``make_pool_scan_train_step`` on
the ``'kernel'`` route above the resident cap) and the streamed forward's
device seed words (``stream_mix(seed_words=)``).

On the CPU, at the smallest width the split takes (E = 1028), B = 8, M = 3,
C = 5, K = 3: the chunk (the kernels' plain versions) against the plain
reference ``perfbench/reference/pool_classifier.py`` on the same weights,
and against K single steps fed the folded words.  Tolerances: the program
restructures the pool (the query projected once, ``W_vo = Wo·Wv``), so its
f32 sums of up to E = 1028 terms run in another order than the
reference's: losses 2e-6 relative, attention weights 1e-6 (about ten
times what they read); each leaf's last gradients 1e-4 and its parameter
change 5e-4, as the norm of the difference over the leaf's norm — Adam
divides each element's moment by its root mean square, so an element
whose gradient is round-off steps by up to ±lr on either side, and that
spreads into the later steps' gradients; masks from the same seed words
are equal bit for bit.  ``stream_mix_plain`` and the
op with the words as a ``(2,)`` int32 tensor equal the words by value.

On the card (``card``), at E = 3584, B = 256, H = 1 (``impl='auto'``) and
H = 2 (``'kernel'``): the chunk's CUDA graph against the eager K-step loop
bit for bit (losses, parameters, attention weights, masks), one graph, K
launches of each streamed kernel a replay, and the kernel with its words
read from the card against the words by value.  This file imports no
JAX, so the ``card`` tests run on a machine without it: ``python -m pytest
--noconftest tests/test_torch_port_stream_chunk.py -m card``.
"""

import pytest
import torch

from aecf_tpu_torch.kernels import (
    stream_bwd,
    stream_bwd_mh,
    stream_mix,
    stream_mix_plain,
)
from aecf_tpu_torch.kernels.draws import fold_seed_words
from aecf_tpu_torch.train import (
    TrainState,
    make_pool_scan_train_step,
    make_pool_train_step,
    param_leaves,
)
from perfbench import models
from perfbench.reference import pool_classifier as ref

B, M, E, C, K = 8, 3, 1028, 5, 3
RNG = 2**41 + 17
OPT = dict(lr=1e-3, weight_decay=0.01, betas=(0.9, 0.999), eps=1e-8)
LOSS_REL = 2e-6
W_TOL = 1e-6
GRAD_REL = 1e-4
UPDATE_REL = 5e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the streamed kernels are CUDA's")
    return torch.device("cuda")


def _weights(E=E, C=C, device="cpu", seed=3):
    return models.pool_classifier_weights(
        {"embed_dim": E, "num_classes": C}, seed, torch.device(device))


def _state(weights, E=E, C=C):
    params = models.pool_classifier_params(
        {"embed_dim": E, "num_classes": C}, weights)
    cuda = weights["query"].is_cuda
    opt = torch.optim.AdamW(param_leaves(params), lr=OPT["lr"],
                            betas=OPT["betas"], eps=OPT["eps"],
                            weight_decay=OPT["weight_decay"], capturable=cuda)
    return TrainState(params, opt)


def _batches(B=B, E=E, C=C, device="cpu", seed=5):
    g = torch.Generator().manual_seed(seed)
    kv = torch.randn((K, B, M, E), generator=g)
    labels = (torch.rand((K, B, C), generator=g) < 0.3).float()
    return kv.to(device), labels.to(device)


def _chunk_and_step(num_heads=1, precision="highest", impl="kernel"):
    kw = dict(num_heads=num_heads, impl=impl, precision=precision)
    return make_pool_scan_train_step(**kw), make_pool_train_step(**kw)


def _eager_steps(single, state, kv, labels):
    """K single steps fed the folded words: losses, and each step's
    attention weights and masked weights ``(B, M)``."""
    losses, weights, masked = [], [], []
    for i in range(K):
        state, loss, info = single(state, kv[i], labels[i],
                                   fold_seed_words(RNG, state.step))
        losses.append(loss)
        weights.append(info["attention_weights"][:, 0, :].detach())
        masked.append(info["masked_attention_weights"][:, 0, :])
    return (state, torch.stack(losses), torch.stack(weights),
            torch.stack(masked))


def _leaf_gap(got, want):
    return float(torch.linalg.vector_norm((got - want).double())
                 / torch.linalg.vector_norm(want.double()))


def test_streamed_chunk_matches_the_reference():
    weights = _weights()
    kv, labels = _batches()
    chunk, single = _chunk_and_step()
    state, losses, _ = chunk(_state(weights), kv, labels, RNG)
    assert state.step == K
    eager, want_losses, w, mw = _eager_steps(single, _state(weights), kv,
                                             labels)
    # the chunk is K single steps fed the folded words
    assert torch.equal(losses, want_losses)
    for p, q in zip(param_leaves(state.params), param_leaves(eager.params)):
        assert torch.equal(p, q)

    want = ref.train(weights, list(zip(kv, labels)), rng=RNG, precision="f32",
                     optimizer=OPT, mask_prob=0.15, min_active=1)
    rel = ((losses.double() - want["losses"].double()).abs()
           / want["losses"].double().abs())
    assert float(rel.max()) < LOSS_REL
    assert float((w - want["weights"]).abs().max()) < W_TOL
    assert torch.equal(mw > 0, want["masks"] > 0.5)
    leaves = dict(zip(ref.LEAVES, param_leaves(state.params)))
    for name, p in leaves.items():
        g = want["grads_last"][name]
        assert _leaf_gap(p.grad.reshape(g.shape), g) < GRAD_REL, name
        w0 = weights[name].reshape(p.shape)
        moved = want["params"][name].reshape(p.shape) - w0
        assert _leaf_gap(p.detach() - w0, moved) < UPDATE_REL, name


@pytest.mark.parametrize("words", [(0, 0), (1234567, 3456789012),
                                   (2**32 - 1, 2**31)])
def test_stream_mix_device_words_equal_words_by_value(words):
    g = torch.Generator().manual_seed(7)
    kv = torch.randn((64, M, E), generator=g)
    u = torch.randn((2, E), generator=g) * 0.05
    c = torch.randn((2,), generator=g)
    on_device = torch.tensor(words, dtype=torch.int64).to(torch.int32)
    kw = dict(training=True, mask_prob=0.6, min_active=1)
    want = stream_mix_plain(kv, u, c, None, seed=words, **kw)
    for got in (stream_mix_plain(kv, u, c, None, seed_words=on_device, **kw),
                stream_mix(kv, u, c, None, seed_words=on_device, **kw)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="seed_words"):
        stream_mix(kv, u, c, None, seed_words=on_device.long(), **kw)


@pytest.mark.card
@pytest.mark.parametrize("num_heads,impl", [(1, "auto"), (2, "kernel")])
def test_streamed_chunk_graph_equals_the_eager_loop(card, num_heads, impl):
    """Two replays of the chunk's graph against 2K eager single steps fed
    the folded words, bit for bit; one graph; each replay adds K to
    ``stream_mix.launches`` and to the backward's.  ``'auto'`` takes the
    streamed split above the resident cap as ``'kernel'`` does."""
    bwd = stream_bwd if num_heads == 1 else stream_bwd_mh
    weights = _weights(3584, device=card)
    kv, labels = _batches(256, 3584, device=card)
    chunk, single = _chunk_and_step(num_heads, "default", impl)
    graphed, eager = _state(weights, 3584), _state(weights, 3584)
    for call in range(2):
        before = (stream_mix.launches, bwd.launches)
        graphed, losses, _ = chunk(graphed, kv, labels, RNG)
        torch.cuda.synchronize()
        if call:  # the first call also runs the capture's warm-up step
            assert (stream_mix.launches - before[0],
                    bwd.launches - before[1]) == (K, K)
        eager, want, w, mw = _eager_steps(single, eager, kv, labels)
        assert torch.equal(losses, want)
        for p, q in zip(param_leaves(graphed.params),
                        param_leaves(eager.params)):
            assert torch.equal(p, q)
        info = next(iter(chunk._graphs.values())).step_info
        for i in range(K):
            assert torch.equal(info[i]["attention_weights"][:, 0, :], w[i])
            assert torch.equal(info[i]["masked_attention_weights"][:, 0, :],
                               mw[i])
    assert len(chunk._graphs) == 1
    assert next(iter(chunk._graphs.values())).replays == 2


@pytest.mark.card
@pytest.mark.parametrize("num_heads", [1, 2])
def test_stream_mix_reads_its_words_from_the_card(card, num_heads):
    g = torch.Generator(device=card).manual_seed(11)
    kv = torch.randn((256, M, 3584), generator=g, device=card)
    u = torch.randn((num_heads, 3584), generator=g, device=card) * 0.02
    c = torch.randn((num_heads,), generator=g, device=card)
    words = fold_seed_words(RNG, 9)
    on_card = torch.tensor(words, dtype=torch.int64).to(torch.int32).to(card)
    for precision in ("highest", "default"):
        kw = dict(training=True, mask_prob=0.6, min_active=1,
                  precision=precision)
        by_value = stream_mix(kv, u, c, None, seed=words, **kw)
        read = stream_mix(kv, u, c, None, seed_words=on_card, **kw)
        for a, b in zip(read, by_value):
            assert torch.equal(a, b)
