"""The optimizer step of the update engine: Adam and AdamW in one pass
(``kernels/adam.py``, ``csrc/adam.cu``) and the engine's dispatch between
it and ``optimizer.step()`` (``train/update.py``, ``_optimizer_step``).

On the CPU: the plain version against ``torch.optim.AdamW`` and ``Adam`` on
CPU tensors over 16 steps — decay 0 and 0.01, one-element, odd-sized and 2-D
leaves, two param groups with different ``lr`` — and at ``lr = 0`` bit for
bit. A CPU optimizer steps through torch's non-capturable branch, which
computes the bias corrections in double from the exact Python numbers, where
the capturable order (the plain version's and the kernel's) computes them in
float32 from ``β1`` and ``β2`` rounded to float32: 0.999 becomes 0.99900001,
and ``1 − β2^t`` magnifies that rounding a thousandfold, so the two updates
differ by up to about 2^-17 of their size (at most about 4·lr), and the
final addition can round p either way. So after k steps each element of p is
held to ``k·(2^-14·lr + 2^-23·|p|)``, about six times the most 30 seeds
read; ``m``, ``v`` and the step agree bit for bit (the same ops in the same
order), except under Adam's L2 term, where the gradient holds p and ``m``
and ``v`` inherit its difference: each is held to ``k·2^-23`` of its largest
entry (about twenty times what they read). Then the dispatch: every
optimizer the kernel does not take (SGD, ``capturable`` off, ``amsgrad``,
``maximize``, a tensor ``lr``, a bf16 leaf, and a capturable Adam on the
CPU) runs ``optimizer.step()`` and counts as a torch-route update, and a CPU
chunk leaves ``state_dict()`` as K ``optimizer.step()`` calls do.

On the card (``card``): the kernel against torch's ``AdamW(capturable=
True)`` foreach step bit for bit (p, m, v, step) — one step and 16, Adam and
AdamW, a warm-up from ``lr = 0``, gradients as views at odd offsets of a
flat buffer, more leaves than one launch takes, the omni cell's leaves
(53.29 M parameters) — a ``state_dict()`` round trip followed by torch's
step, the ineligible optimizers on the torch route, and each training
builder's chunk graph equal to its eager loop bit for bit, each replay
adding K kernel-route updates, none on the torch route and 2K launches. This
file imports no JAX, so the ``card`` tests run on a machine without it:
``python -m pytest --noconftest tests/test_torch_port_adam.py -m card``.
"""

import copy

import pytest
import torch

from aecf_tpu_torch.kernels import (
    AdamHyper,
    adam_optimizer_step,
    adam_step,
    supports_adam,
)
from aecf_tpu_torch.kernels.adam import _refusal
from aecf_tpu_torch.kernels.draws import fold_seed_words
from aecf_tpu_torch.train import (
    TrainState,
    init_contrastive_params,
    init_pool_classifier_params,
    make_contrastive_scan_train_step,
    make_contrastive_train_step,
    make_pool_scan_train_step,
    make_pool_train_step,
    make_scan_train_step,
    make_train_step,
    param_leaves,
)
from aecf_tpu_torch.train.update import _optimizer_step, optimizer_routes

LR = 1e-3
SHAPES = ((1,), (7,), (33, 5))
STEPS = 16
RNG = 2**40 + 23


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the optimizer kernel is CUDA's")
    return torch.device("cuda")


def _leaves(shapes=SHAPES, device="cpu", seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(device, dtype).requires_grad_(True)
            for s in shapes]


def _groups(leaves, two_groups):
    if not two_groups:
        return [{"params": leaves}]
    return [{"params": leaves[:1]}, {"params": leaves[1:], "lr": 3 * LR}]


def _twins(cls, wd, two_groups=False, shapes=SHAPES, device="cpu", **kw):
    """Two optimizers of class ``cls`` over equal copies of the leaves."""
    a = _leaves(shapes, device)
    b = [p.detach().clone().requires_grad_(True) for p in a]
    return [(leaves, cls(_groups(leaves, two_groups), lr=LR, weight_decay=wd,
                         **kw)) for leaves in (a, b)]


def _feed(step, *leaf_sets, scale=True):
    """The same gradients for every leaf set, some of them small."""
    g = torch.Generator().manual_seed(1000 + step)
    for i, p in enumerate(leaf_sets[0]):
        grad = torch.randn(p.shape, generator=g)
        if scale:
            grad = grad * 10.0 ** (i % 3 - 2)
        for leaves in leaf_sets:
            leaves[i].grad = grad.to(leaves[i].device, leaves[i].dtype)


def _close(got, want, tol):
    assert bool(((got - want).abs() <= tol).all()), float(
        ((got - want).abs() - tol).max())


# ---- on the CPU -------------------------------------------------------------


@pytest.mark.parametrize("two_groups", [False, True], ids=["one", "two"])
@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("cls", [torch.optim.AdamW, torch.optim.Adam])
def test_plain_version_follows_torch_on_the_cpu(cls, wd, two_groups):
    (ours, opt), (theirs, ref) = _twins(cls, wd, two_groups)
    for step in range(STEPS):
        _feed(step, ours, theirs)
        adam_optimizer_step(opt)
        ref.step()
    _held(ours, opt, theirs, ref, LR, STEPS,
          bitwise=wd == 0 or cls is torch.optim.AdamW)


def _held(ours, opt, theirs, ref, lr, k, bitwise=True):
    """The plain route's leaves and state against torch's after k CPU
    steps, to the tolerances of the module's docstring."""
    for p, q in zip(ours, theirs):
        p, q = p.detach(), q.detach()
        _close(p, q, k * (2**-14 * lr + 2**-23 * q.abs()))
    for p, q in zip(ours, theirs):
        st, want = opt.state[p], ref.state[q]
        assert torch.equal(st["step"], want["step"])
        for name in ("exp_avg", "exp_avg_sq"):
            if bitwise:
                assert torch.equal(st[name], want[name]), name
            else:
                _close(st[name], want[name],
                       k * 2**-23 * want[name].abs().max())


def test_plain_version_takes_each_leafs_hyperparameters():
    """``adam_step`` on CPU tensors with hyperparameters of its own for
    each leaf — among them ``β1 = 0.4``, whose lerp weight 0.6 takes
    ATen's other formula — against one torch optimizer a leaf."""
    hypers = [AdamHyper(1e-3, 0.9, 0.999, 1e-8, 0.01, True),
              AdamHyper(3e-4, 0.8, 0.99, 1e-6, 0.1, False),
              AdamHyper(1e-2, 0.4, 0.9, 1e-8, 0.0, True)]
    leaves = [p.detach() for p in _leaves()]
    theirs = [p.clone().requires_grad_(True) for p in leaves]
    refs = [(torch.optim.AdamW if h.decoupled else torch.optim.Adam)(
        [q], lr=h.lr, betas=(h.beta1, h.beta2), eps=h.eps,
        weight_decay=h.weight_decay) for q, h in zip(theirs, hypers)]
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    steps = [torch.zeros(()) for _ in leaves]
    for step in range(STEPS):
        _feed(step, theirs)
        adam_step(leaves, [q.grad for q in theirs], m, v, steps, hypers)
        for ref in refs:
            ref.step()
    for i, (ref, h) in enumerate(zip(refs, hypers)):
        q = theirs[i].detach()
        _close(leaves[i], q, STEPS * (2**-14 * h.lr + 2**-23 * q.abs()))
        want = ref.state[theirs[i]]
        assert torch.equal(steps[i], want["step"])
        for got, name in ((m[i], "exp_avg"), (v[i], "exp_avg_sq")):
            if h.decoupled:
                assert torch.equal(got, want[name]), name
            else:
                _close(got, want[name],
                       STEPS * 2**-23 * want[name].abs().max())


@pytest.mark.parametrize("cls", [torch.optim.AdamW, torch.optim.Adam])
def test_a_learning_rate_of_zero_leaves_p_as_torch_does(cls):
    """``lr = 0``, where a cosine schedule ends or a warm-up starts: the
    step size comes out as ``1 / −inf = −0``, so p stays as it was, and p,
    m, v and the step equal torch's bit for bit (the gradient's L2 term
    reads the same p in both)."""
    ours = _leaves()
    theirs = [p.detach().clone().requires_grad_(True) for p in ours]
    start = [p.detach().clone() for p in ours]
    opt, ref = (cls(x, lr=0.0, weight_decay=0.01) for x in (ours, theirs))
    for step in range(3):
        _feed(step, ours, theirs)
        adam_optimizer_step(opt)
        ref.step()
    for p, q, p0 in zip(ours, theirs, start):
        assert torch.equal(p, p0) and torch.equal(q, p0)
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][name], ref.state[q][name]), name


# each optimizer the kernel does not take: its keywords (or None: SGD) and
# the reason it is refused for
REFUSED = {
    "sgd": (None, "not exactly torch.optim.Adam or AdamW"),
    "capturable_off": ({}, "capturable=False"),
    "amsgrad": ({"amsgrad": True}, "amsgrad"),
    "maximize": ({"maximize": True}, "maximize"),
    "tensor_lr": ({"lr": torch.tensor(LR)}, "lr not Python numbers"),
    "bf16_leaf": ({}, "a leaf or gradient not dense float32"),
}


def _refused(case, leaves, capturable):
    kw, _ = REFUSED[case]
    if kw is None:
        return torch.optim.SGD(leaves, lr=LR, momentum=0.9)
    kw = {"lr": LR, **kw}
    if case != "capturable_off":
        kw["capturable"] = capturable
    return torch.optim.AdamW(leaves, **kw)


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_an_optimizer_the_kernel_does_not_take_steps_through_torch(case):
    dtype = torch.bfloat16 if case == "bf16_leaf" else torch.float32
    a = _leaves(dtype=dtype)
    b = [p.detach().clone().requires_grad_(True) for p in a]
    opt, twin = _refused(case, a, False), _refused(case, b, False)
    before = (optimizer_routes.kernel, optimizer_routes.torch)
    for step in range(3):
        _feed(step, a, b)
        assert _refusal(opt) == REFUSED[case][1]
        assert not supports_adam(opt)
        _optimizer_step(opt)
        twin.step()
    assert (optimizer_routes.kernel - before[0],
            optimizer_routes.torch - before[1]) == (0, 3)
    for p, q in zip(a, b):
        assert torch.equal(p, q)


def test_a_transposed_gradient_is_read_through_a_copy():
    """A gradient that is a transposed view (as a product's backward can
    give) is no refusal, and the update equals the one from its
    contiguous copy."""
    (ours, opt), (theirs, twin) = _twins(torch.optim.AdamW, 0.01,
                                         capturable=True)
    _feed(0, ours, theirs)
    for p, q in zip(ours, theirs):
        if p.ndim == 2:
            p.grad = p.grad.t().contiguous().t()
            assert not p.grad.is_contiguous() and torch.equal(p.grad, q.grad)
    assert _refusal(opt) == "no kernel for device cpu"
    adam_optimizer_step(opt)
    adam_optimizer_step(twin)
    for p, q in zip(ours, theirs):
        assert torch.equal(p, q)


def test_a_capturable_adam_on_the_cpu_is_refused_for_its_device():
    opt = torch.optim.AdamW(_leaves(), lr=LR, capturable=True)
    assert _refusal(opt) == "no gradients"
    _feed(0, opt.param_groups[0]["params"])
    assert _refusal(opt) == "no kernel for device cpu"
    opt.register_step_pre_hook(lambda *a: None)
    assert _refusal(opt) == "step hooks"


def test_an_lr_schedulers_step_wrapper_is_no_refusal():
    leaves = _leaves()
    opt = torch.optim.AdamW(leaves, lr=LR, capturable=True)
    torch.optim.lr_scheduler.StepLR(opt, 1, 0.5)
    _feed(0, leaves)
    assert _refusal(opt) == "no kernel for device cpu"
    opt.step = lambda *a, **k: None
    assert _refusal(opt) == "a step of its own"


def test_kernel_route_state_dict_is_torchs():
    """The kernel route's state — made where missing as torch's
    ``_init_group`` makes it — gives torch's ``state_dict()`` (the same
    keys, dtypes, shapes and devices; m, v and the step bit for bit), and
    a fresh torch optimizer loading it steps on from there."""
    (ours, opt), (theirs, ref) = _twins(torch.optim.AdamW, 0.01, True)
    for step in range(4):
        _feed(step, ours, theirs)
        adam_optimizer_step(opt)
        ref.step()
    got, want = opt.state_dict(), ref.state_dict()
    assert got["param_groups"] == want["param_groups"]
    assert got["state"].keys() == want["state"].keys()
    for i in want["state"]:
        assert got["state"][i].keys() == want["state"][i].keys()
        for k, v in want["state"][i].items():
            w = got["state"][i][k]
            assert (w.dtype, w.shape, w.device) == (v.dtype, v.shape, v.device)
            assert torch.equal(w, v), k
    again = [p.detach().clone().requires_grad_(True) for p in ours]
    resumed = torch.optim.AdamW(_groups(again, True), lr=LR,
                                weight_decay=0.01)
    resumed.load_state_dict(copy.deepcopy(got))
    _feed(4, ours, again)
    adam_optimizer_step(opt)
    resumed.step()
    _held(ours, opt, again, resumed, 3 * LR, 1)


def test_a_cpu_chunk_leaves_torchs_state_dict():
    """The pool chunk on the CPU (eager): K torch-route updates, and the
    ``state_dict()`` of K single steps that call ``optimizer.step()``."""
    K, B, M, E, C = 3, 8, 3, 16, 4
    g = torch.Generator().manual_seed(5)
    kv = torch.randn((K, B, M, E), generator=g)
    labels = (torch.rand((K, B, C), generator=g) < 0.3).float()
    states = []
    for _ in range(2):
        params = init_pool_classifier_params(
            torch.Generator().manual_seed(3), E, C, device="cpu")
        states.append(TrainState(params, torch.optim.AdamW(
            param_leaves(params), lr=LR, weight_decay=0.01)))
    chunk = make_pool_scan_train_step(num_heads=1, impl="torch")
    before = (optimizer_routes.kernel, optimizer_routes.torch)
    chunked, _, _ = chunk(states[0], kv, labels, RNG)
    assert (optimizer_routes.kernel - before[0],
            optimizer_routes.torch - before[1]) == (0, K)
    single = make_pool_train_step(num_heads=1, impl="torch")
    stepped = states[1]
    for i in range(K):
        stepped, _, _ = single(stepped, kv[i], labels[i],
                               fold_seed_words(RNG, stepped.step))
    got, want = (s.optimizer.state_dict() for s in (chunked, stepped))
    assert got["param_groups"] == want["param_groups"]
    for i, st in want["state"].items():
        for k, v in st.items():
            assert torch.equal(got["state"][i][k], v), (i, k)


def test_adam_step_checks_its_inputs():
    leaves = [p.detach() for p in _leaves()]
    m = [torch.zeros_like(p) for p in leaves]
    steps = [torch.zeros(()) for _ in leaves]
    h = [AdamHyper(LR, 0.9, 0.999, 1e-8, 0.0, True)] * len(leaves)
    with pytest.raises(ValueError, match="one length"):
        adam_step(leaves, m[:1], m, m, steps, h)
    with pytest.raises(ValueError, match="float32"):
        adam_step(leaves, [x.double() for x in m], m, m, steps, h)
    with pytest.raises(ValueError, match="the step must be one float32"):
        adam_step(leaves, m, m, m, [torch.zeros(2)] * len(leaves), h)
    with pytest.raises(ValueError, match="contiguous"):
        adam_step([torch.zeros(4, 4).t()], [torch.zeros(4, 4)],
                  [torch.zeros(4, 4)], [torch.zeros(4, 4)], steps[:1], h[:1])


# ---- on the card ------------------------------------------------------------


def _state_of(opt, p):
    st = opt.state[p]
    return st["step"], st["exp_avg"], st["exp_avg_sq"]


def _bitwise(ours, opt, theirs, ref):
    for p, q in zip(ours, theirs):
        assert torch.equal(p, q)
        for a, b in zip(_state_of(opt, p), _state_of(ref, q)):
            assert torch.equal(a, b)


@pytest.mark.card
@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("cls", [torch.optim.AdamW, torch.optim.Adam])
@pytest.mark.parametrize("steps", [1, STEPS])
def test_kernel_equals_torchs_capturable_step(card, cls, wd, steps):
    shapes = SHAPES + ((4099,), (256, 1030), (2, 3, 5))
    (ours, opt), (theirs, ref) = _twins(cls, wd, True, shapes, card,
                                        capturable=True)
    launches = adam_step.launches
    for step in range(steps):
        _feed(step, ours, theirs)
        _optimizer_step(opt)
        ref.step()
        _bitwise(ours, opt, theirs, ref)
    assert adam_step.launches - launches == 2 * steps


@pytest.mark.card
@pytest.mark.parametrize("cls", [torch.optim.AdamW, torch.optim.Adam])
def test_a_warm_up_from_a_learning_rate_of_zero(card, cls):
    """A ``LambdaLR`` warm-up from ``lr = 0`` (factors 0, 1/2, 1): the
    kernel route equals torch's capturable step bit for bit at every step,
    and the first step, at ``lr = 0``, leaves p as it was."""
    (ours, opt), (theirs, ref) = _twins(cls, 0.01, True, device=card,
                                        capturable=True)
    start = [p.detach().clone() for p in ours]
    schedules = [torch.optim.lr_scheduler.LambdaLR(o, lambda s: s / 2)
                 for o in (opt, ref)]
    assert opt.param_groups[0]["lr"] == 0.0
    before = (optimizer_routes.kernel, optimizer_routes.torch)
    for step in range(3):
        _feed(step, ours, theirs)
        _optimizer_step(opt)
        ref.step()
        _bitwise(ours, opt, theirs, ref)
        if step == 0:
            assert all(torch.equal(p, p0) for p, p0 in zip(ours, start))
        for schedule in schedules:
            schedule.step()
    assert (optimizer_routes.kernel - before[0],
            optimizer_routes.torch - before[1]) == (3, 0)


@pytest.mark.card
def test_gradients_at_odd_offsets_of_a_flat_buffer(card):
    """Gradients as views of one flat buffer at offsets of one element and
    more (no 16-byte vector of g; p, m and v in vectors)."""
    shapes = ((5,), (1027,), (64, 33), (9000,))
    (ours, opt), (theirs, ref) = _twins(torch.optim.AdamW, 0.01, False,
                                        shapes, card, capturable=True)
    for step in range(3):
        _feed(step, theirs)
        flat = torch.zeros(1 + sum(p.numel() for p in ours) + 3, device=card)
        at = 1
        for p, q in zip(ours, theirs):
            view = flat[at:at + p.numel()].view(p.shape)
            view.copy_(q.grad)
            p.grad = view
            at += p.numel() + 1
        assert supports_adam(opt)
        _optimizer_step(opt)
        ref.step()
        _bitwise(ours, opt, theirs, ref)


@pytest.mark.card
def test_more_leaves_than_one_launch_takes(card):
    shapes = [(i + 1,) for i in range(45)] + [(3, 3)] * 45
    (ours, opt), (theirs, ref) = _twins(torch.optim.AdamW, 0.01, False,
                                        shapes, card, capturable=True)
    launches = adam_step.launches
    for step in range(2):
        _feed(step, ours, theirs)
        _optimizer_step(opt)
        ref.step()
    _bitwise(ours, opt, theirs, ref)
    assert adam_step.launches - launches == 2 * 2 * 3


@pytest.mark.card
def test_the_omni_cells_leaves(card):
    """The omni cell's seven leaves (E=3584, C=527: 53.29 M parameters),
    two steps."""
    params = init_pool_classifier_params(torch.Generator().manual_seed(7),
                                         3584, 527, device=card)
    ours = param_leaves(params)
    assert sum(p.numel() for p in ours) == 53_287_439
    theirs = [p.detach().clone().requires_grad_(True) for p in ours]
    opt, ref = (torch.optim.AdamW(x, lr=1e-4, weight_decay=0.01,
                                  capturable=True) for x in (ours, theirs))
    for step in range(2):
        g = torch.Generator(device=card).manual_seed(step)
        for p, q in zip(ours, theirs):
            p.grad = torch.randn(p.shape, generator=g, device=card) * 1e-3
            q.grad = p.grad.clone()
        _optimizer_step(opt)
        ref.step()
    _bitwise(ours, opt, theirs, ref)


@pytest.mark.card
def test_state_dict_round_trip_then_torchs_step(card):
    (ours, opt), (theirs, ref) = _twins(torch.optim.AdamW, 0.01, True,
                                        device=card, capturable=True)
    for step in range(3):
        _feed(step, ours, theirs)
        _optimizer_step(opt)
        ref.step()
    again = [p.detach().clone().requires_grad_(True) for p in ours]
    resumed = torch.optim.AdamW(_groups(again, True), lr=LR,
                                weight_decay=0.01, capturable=True)
    resumed.load_state_dict(copy.deepcopy(opt.state_dict()))
    _feed(3, again, theirs)
    resumed.step()
    ref.step()
    _bitwise(again, resumed, theirs, ref)


@pytest.mark.card
@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_optimizers_on_the_card_take_torchs_step(card, case):
    dtype = torch.bfloat16 if case == "bf16_leaf" else torch.float32
    leaves = _leaves(device=card, dtype=dtype)
    opt = _refused(case, leaves, True)
    _feed(0, leaves)
    assert _refusal(opt) == REFUSED[case][1]
    before = (optimizer_routes.kernel, optimizer_routes.torch)
    _optimizer_step(opt)
    assert (optimizer_routes.kernel - before[0],
            optimizer_routes.torch - before[1]) == (0, 1)


def _pool(card, E, impl, K=4, B=64, M=3, C=5):
    g = torch.Generator().manual_seed(9)
    kv = torch.randn((K, B, M, E), generator=g).to(card)
    labels = (torch.rand((K, B, C), generator=g) < 0.3).float().to(card)

    def state():
        params = init_pool_classifier_params(
            torch.Generator().manual_seed(3), E, C, device=card)
        return TrainState(params, torch.optim.AdamW(
            param_leaves(params), lr=LR, weight_decay=0.01, capturable=True))

    kw = dict(num_heads=1, impl=impl, precision="default")
    return (make_pool_scan_train_step(**kw), make_pool_train_step(**kw),
            state, (kv, labels))


def _contrastive(card, K=4, B=64, M=3, E=64):
    g = torch.Generator().manual_seed(10)
    kv = torch.randn((K, B, M, E), generator=g).to(card)
    target = torch.randn((K, B, E), generator=g).to(card)

    def state():
        params = init_contrastive_params(torch.Generator().manual_seed(4), E,
                                         32, device=card)
        return TrainState(params, torch.optim.AdamW(
            param_leaves(params), lr=LR, weight_decay=0.01, capturable=True))

    return (make_contrastive_scan_train_step(),
            make_contrastive_train_step(), state, (kv, target))


def _xray(card, K=4, B=64, I=48, T=40, C=5):
    from aecf_tpu_torch.models import XrayAECFModel

    g = torch.Generator().manual_seed(11)
    img = torch.randn((K, B, I), generator=g).to(card)
    txt = torch.randn((K, B, T), generator=g).to(card)
    lab = (torch.rand((K, B, C), generator=g) < 0.25).float().to(card)

    def apply(model, images, texts, generator):
        model.train()
        return model(images, texts, generator=generator,
                     curriculum_enabled=True, missing_modality_training=True,
                     return_info=True)

    def state():
        model = XrayAECFModel(I, T, C, hidden_dim=32, num_heads=4,
                              generator=torch.Generator().manual_seed(0),
                              device=card)
        return TrainState(model, torch.optim.AdamW(
            model.parameters(), lr=LR, weight_decay=0.01, capturable=True))

    return (make_scan_train_step(apply), make_train_step(apply), state,
            (img, txt, lab))


BUILDERS = {
    "pool_one_pass": lambda card: _pool(card, 64, "auto"),
    "pool_streamed": lambda card: _pool(card, 1028, "kernel"),
    "contrastive": _contrastive,
    "xray": _xray,
}


@pytest.mark.card
@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_chunk_replay_takes_the_kernel_k_times(card, builder):
    """Two replays of each training builder's chunk graph against 2K eager
    single steps fed the folded words: losses and parameters bit for bit;
    each replay adds K kernel-route updates, none on the torch route, and
    2K launches of the kernel."""
    chunk, single, state, streams = BUILDERS[builder](card)
    K = streams[0].shape[0]
    graphed, eager = state(), state()
    for call in range(2):
        before = (optimizer_routes.kernel, optimizer_routes.torch,
                  adam_step.launches)
        graphed, losses, _ = chunk(graphed, *streams, RNG)
        torch.cuda.synchronize()
        if call:  # the first call also runs the capture's warm-up step
            assert (optimizer_routes.kernel - before[0],
                    optimizer_routes.torch - before[1],
                    adam_step.launches - before[2]) == (K, 0, 2 * K)
        want = []
        for i in range(K):
            eager, loss, _ = single(eager, *(s[i] for s in streams),
                                    fold_seed_words(RNG, eager.step))
            want.append(loss)
        assert torch.equal(losses, torch.stack(want))
        for p, q in zip(param_leaves(graphed.params),
                        param_leaves(eager.params)):
            assert torch.equal(p, q)
    assert len(chunk._graphs) == 1
    assert next(iter(chunk._graphs.values())).replays == 2
