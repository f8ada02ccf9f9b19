"""The X-ray AECF model's K-step chunk (``make_scan_train_step`` over
``XrayAECFModel``, curriculum and missing-modality simulation on) and the
model families' device-keyed draws (``kernels/draws.py``,
``csrc/draws.cu``).

On the CPU, at E = 32, B = 64, K = 4: the chunk against the plain
reference ``perfbench/reference/xray.py`` on the same weights — losses,
gradients and parameters after K steps, every missing-modality, dropout
and curriculum-mask bit equal; a K-chunk against two K/2-chunks, K single
steps fed the folded words, and a run resumed from a saved state; the
draw rule against the reference's Philox; the rates of the draws.

On the card (``card``): the draw kernels against their plain version bit
for bit (words by value and read from the card), and the chunk's CUDA
graph against the eager route bit for bit, with what a replay adds to the
counters.  This file imports no JAX, so the ``card`` tests run on a
machine without it: ``python -m pytest --noconftest
tests/test_torch_port_xray_chunk.py -m card``.
"""

import math

import pytest
import torch

from aecf_tpu_torch import ops
from aecf_tpu_torch.kernels import draws
from aecf_tpu_torch.kernels.draws import (
    Draws,
    fold_key,
    fold_seed_words,
    uniforms,
    uniforms_plain,
)
from aecf_tpu_torch.models import XrayAECFModel
from aecf_tpu_torch.train import (
    TrainState,
    make_scan_train_step,
    make_train_step,
)
from perfbench.reference import philox
from perfbench.reference import xray as ref

I, T, E, C, H = 48, 40, 32, 5, 4
B, K = 64, 4
CFG = dict(hidden_dim=E, num_heads=H, missing_prob=0.3, base_mask_prob=0.15,
           entropy_target=0.7, min_active=1,
           optimizer=dict(lr=1e-3, weight_decay=0.01, betas=(0.9, 0.999),
                          eps=1e-8))
RNG = 2**40 + 11


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the draw kernels are CUDA's")
    return torch.device("cuda")


def _model(device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    return XrayAECFModel(I, T, C, hidden_dim=E, num_heads=H, generator=g,
                         device=device)


def _state(device="cpu", seed=0):
    model = _model(device, seed)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.01,
                            capturable=torch.device(device).type == "cuda")
    return TrainState(model, opt)


def _batches(device="cpu", steps=K, seed=1):
    g = torch.Generator().manual_seed(seed)
    img = torch.randn((steps, B, I), generator=g)
    txt = torch.randn((steps, B, T), generator=g)
    lab = (torch.rand((steps, B, C), generator=g) < 0.25).float()
    return [x.to(device) for x in (img, txt, lab)]


def _apply(model, images, texts, generator):
    model.train()
    return model(images, texts, generator=generator, curriculum_enabled=True,
                 missing_modality_training=True, return_info=True)


class _Recorded:
    """The uniforms of every model-level draw, in call order."""

    def __init__(self, monkeypatch):
        self.got = []
        original = Draws.uniforms

        def spy(d, rows, cols, device):
            u = original(d, rows, cols, device)
            self.got.append(u)
            return u

        monkeypatch.setattr(Draws, "uniforms", spy)


def _bits(got, steps):
    """Each step's missing-modality and dropout bits, the reference's
    order."""
    per = len(got) // steps
    out = []
    for i in range(steps):
        u, *drops = got[i * per:(i + 1) * per]
        di, dt, keep = u[:, 0] < 0.3, u[:, 1] < 0.3, u[:, 2] > 0.5
        both = di & dt
        bits = [torch.where(both, ~keep, di), torch.where(both, keep, dt),
                keep] + [d < 0.9 for d in drops]
        out.append(torch.cat([b.reshape(-1) for b in bits]))
    return torch.stack(out)


def test_chunk_matches_the_plain_reference(monkeypatch):
    """K updates of the chunk against the reference's on the same weights
    and seed words: every draw bit equal, the curriculum masks equal
    (single steps give them), losses, gradients and parameters to float32
    round-off."""
    state = _state()
    weights = {k: v.detach().clone() for k, v in state.params.state_dict()
               .items() if not k.endswith("_eps")}
    img, txt, lab = _batches()
    rec = _Recorded(monkeypatch)
    state, losses, _ = make_scan_train_step(_apply)(state, img, txt, lab, RNG)
    want = ref.train(weights, list(zip(img, txt, lab)), rng=RNG,
                     precision="f32", cfg=CFG)
    assert torch.equal(_bits(rec.got, K), want["drops"])
    torch.testing.assert_close(losses, want["losses"], rtol=1e-5, atol=0)
    for name, p in state.params.named_parameters():
        torch.testing.assert_close(p.grad, want["grads_last"][name],
                                   rtol=1e-4, atol=1e-7, msg=name)
        torch.testing.assert_close(p.detach(), want["params"][name],
                                   rtol=1e-5, atol=1e-6, msg=name)
    # the curriculum masks, step by step
    single = make_train_step(_apply)
    again = _state()
    for i in range(K):
        again, _, info = single(again, img[i], txt[i], lab[i],
                                fold_seed_words(RNG, i))
        mask = info["masked_attention_weights"][:, 0, :] > 0
        assert torch.equal(mask, want["masks"][i])


@pytest.mark.parametrize("split", [(4,), (2, 2), (1, 1, 1, 1)])
def test_chunkings_and_resume_give_the_same_parameters(split):
    """A K-chunk, two K/2-chunks, K single steps fed the folded words, and
    a run saved after two steps and resumed in a fresh state: equal
    parameters bit for bit."""
    img, txt, lab = _batches()
    whole = _state()
    whole, _, _ = make_scan_train_step(_apply)(whole, img, txt, lab, RNG)
    chunk = make_scan_train_step(_apply)
    state, at = _state(), 0
    for k in split:
        state, _, _ = chunk(state, img[at:at + k], txt[at:at + k],
                            lab[at:at + k], RNG)
        at += k
    for p, q in zip(whole.params.parameters(), state.params.parameters()):
        assert torch.equal(p, q)
    # resume: the model's and the optimizer's state after two steps
    half = _state()
    half, _, _ = chunk(half, img[:2], txt[:2], lab[:2], RNG)
    resumed = _state(seed=5)
    resumed.params.load_state_dict(half.params.state_dict())
    resumed.optimizer.load_state_dict(half.optimizer.state_dict())
    resumed.step = half.step
    resumed, _, _ = chunk(resumed, img[2:], txt[2:], lab[2:], RNG)
    for p, q in zip(whole.params.parameters(), resumed.params.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("tag", [0, 1, 5, 2**31 + 3])
@pytest.mark.parametrize("cols", [1, 3, 4, 7, 256])
def test_draw_rule_equals_the_references_philox(tag, cols):
    words = fold_seed_words(RNG, 3)
    got = uniforms(words, 9, cols, tag=tag)
    want = ref.uniforms(words, 9, cols, tag, "cpu")
    assert torch.equal(got, want)
    if tag == 0:
        assert torch.equal(got, philox.uniforms(words, 9, cols))
    assert fold_key(words, tag) == philox.fold(words, tag)
    # a words tensor on the CPU draws what its host words draw
    t = torch.tensor(words, dtype=torch.int64).to(torch.int32)
    assert torch.equal(uniforms(t, 9, cols, tag=tag), got)


def test_draws_take_their_sites_in_call_order():
    words = (7, 11)
    d = Draws.of(words)
    a, key, b = d.uniforms(4, 3, "cpu"), d.fork(), d.uniforms(4, 8, "cpu")
    assert torch.equal(a, uniforms_plain(words, 4, 3, tag=1))
    assert key == fold_seed_words(words, 2)
    assert torch.equal(b, uniforms_plain(words, 4, 8, tag=3))
    assert Draws.of(None) is None and Draws.of(d) is d
    g, h = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    w = torch.randint(0, 2**32, (2,), generator=h)
    assert Draws.of(g).key == (int(w[0]), int(w[1]))


def test_dropout_and_missing_modality_rates():
    """Dropout keeps ``1 - rate``; each modality drops at ``p - p²/2``,
    never both; from one step's words, as the chunk draws them."""
    n = 20000
    model = XrayAECFModel(8, 8, 2, hidden_dim=8, device="cpu")
    d = Draws.of(fold_seed_words(RNG, 0))
    img, txt = model.simulate_missing_modalities(d, torch.ones(n, 8),
                                                 torch.ones(n, 8))
    gone_img, gone_txt = img.sum(1) == 0, txt.sum(1) == 0
    assert not bool((gone_img & gone_txt).any())
    want = 0.3 - 0.3 * 0.3 / 2
    sigma = math.sqrt(want * (1 - want) / n)
    for gone in (gone_img, gone_txt):
        assert abs(float(gone.float().mean()) - want) < 5 * sigma
    from aecf_tpu_torch.models.layers import dropout

    kept = dropout(torch.ones(n, 16), 0.1, d, True) > 0
    sigma = math.sqrt(0.9 * 0.1 / kept.numel())
    assert abs(float(kept.float().mean()) - 0.9) < 5 * sigma


def test_curriculum_mask_rate_follows_the_entropy():
    """Uniform weights (entropy log M) keep ``1 - base_mask_prob``; the
    torch route draws the mask at tag 0 of its words, as the kernels."""
    from aecf_tpu_torch.core.masking import curriculum_mask

    n, M = 20000, 2
    w = torch.full((n, 1, M), 0.5)
    words = fold_seed_words(RNG, 9)
    masked, info = curriculum_mask(w, generator=words, training=True,
                                   base_mask_prob=0.15)
    kept = masked > 0
    # a row that drew no slot keeps its first (min_active=1)
    drew = uniforms_plain(words, n, M) < 0.85
    want = torch.where(drew.sum(1, keepdim=True) < 1,
                       torch.tensor([True, False]), drew)
    assert torch.equal(kept[:, 0, :], want)
    rate = float(drew.float().mean())
    assert abs(rate - 0.85) < 5 * math.sqrt(0.85 * 0.15 / (n * M))


def test_the_torch_route_counts_its_pool_calls():
    before = ops.routes.torch_route, ops.routes.kernel_route
    img, txt, lab = _batches()
    make_scan_train_step(_apply)(_state(), img, txt, lab, RNG)
    assert ops.routes.torch_route - before[0] == K
    assert ops.routes.kernel_route == before[1]


@pytest.mark.parametrize("mode,want", [(None, "highest"),
                                       ("highest", "highest"),
                                       ("default", "default")])
def test_the_pool_follows_the_process_matmul_mode(monkeypatch, mode, want):
    """The model's pool runs at the float32 matmul mode its caller set
    (:func:`matmul_precision`), as its linear layers do: IEEE f32 outside
    any block."""
    import aecf_tpu_torch.models.xray as xray
    from aecf_tpu_torch.core import matmul_precision

    seen, real = [], xray.fusion_pool

    def spy(*args, precision, **kwargs):
        seen.append(precision)
        return real(*args, precision=precision, **kwargs)

    monkeypatch.setattr(xray, "fusion_pool", spy)
    img, txt, lab = _batches(steps=1)
    model = _model()
    if mode is None:
        _apply(model, img[0], txt[0], RNG)
    else:
        with matmul_precision(mode):
            _apply(model, img[0], txt[0], RNG)
    assert seen == [want]


# ---- on the card ------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("rows,cols", [(1, 1), (5, 3), (64, 256), (4096, 2),
                                       (33, 257)])
def test_draw_kernel_equals_its_plain_version(card, rows, cols):
    words = fold_seed_words(RNG, rows)
    on_card = torch.tensor(words, dtype=torch.int64).to(torch.int32).to(card)
    for tag in (0, 4, 2**32 - 1):
        want = uniforms_plain(words, rows, cols, tag=tag)
        launches = draws.counted.launches
        by_value = uniforms(words, rows, cols, tag=tag, device=card)
        read = uniforms(on_card, rows, cols, tag=tag, device=card)
        assert draws.counted.launches == launches + 2
        assert torch.equal(by_value.cpu(), want)
        assert torch.equal(read.cpu(), want)
    folded = fold_key(on_card, 2**33 + 5)
    assert tuple(x & 0xFFFFFFFF for x in folded.tolist()) == fold_seed_words(
        words, 2**33 + 5)


@pytest.mark.card
def test_chunk_graph_equals_the_eager_route(card):
    """Two replays of the chunk's CUDA graph against 2K eager single steps
    fed the folded words: losses and parameters bit for bit; each replay
    adds its capture's draws and K torch-route pool calls."""
    img, txt, lab = _batches(card)
    chunk = make_scan_train_step(_apply)
    single = make_train_step(_apply)
    graphed, eager = _state(card), _state(card)
    for call in range(2):
        n, routes = draws.counted.launches, ops.routes.torch_route
        graphed, losses, _ = chunk(graphed, img, txt, lab, RNG)
        torch.cuda.synchronize()
        if call:  # the first call also runs the capture's warm-up step
            assert ops.routes.torch_route - routes == K
            assert draws.counted.launches - n == 6 * K
        want = []
        for i in range(K):
            eager, loss, _ = single(eager, img[i], txt[i], lab[i],
                                    fold_seed_words(RNG, eager.step))
            want.append(loss)
        assert torch.equal(losses, torch.stack(want))
        for p, q in zip(graphed.params.parameters(),
                        eager.params.parameters()):
            assert torch.equal(p, q)
    assert len(chunk._graphs) == 1
    assert next(iter(chunk._graphs.values())).replays == 2
