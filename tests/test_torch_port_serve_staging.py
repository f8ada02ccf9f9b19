"""``FusionPredictor``'s staged route: on the card each bucket goes through
reused pinned slots, one bucket ahead of the answers read, and each bucket
shape's forward replays one CUDA graph.  Held bit for bit to the blocking
route (``_call_bucket`` on numpy-padded buckets) at every bucket edge and
modality subset; a short request after a long one in the same slots;
answers that outlive the next request; ``staged == calls``; the spans; a
failed request; concurrent callers; a frozen predictor.  The graphs: every
bucket call replayed after the warm-up, its kernel launch counted; weights
updated in place and replaced; an ``apply_fn`` that cannot be captured or
reaches no Module, answered eagerly.  On the CPU the blocking route stays,
``staged``, ``graphed`` and ``captures`` at 0; the Modules a predictor's
graphs read are found on the CPU too.

This file imports no JAX, so the ``card`` tests run on a machine without
it: ``python -m pytest --noconftest tests/test_torch_port_serve_staging.py
-m card``.
"""

import itertools
import sys
import threading

import numpy as np
import pytest
import torch

from aecf_tpu_torch.serve import (
    FusionPredictor,
    export_predictor,
    load_exported_predictor,
    pad_to_bucket,
)
from aecf_tpu_torch.utils import profiling

WIDTH = {"image": 2048, "text": 768}
CLASSES = 1000
BUCKETS = (32, 256, 1024)
ROWS = (1, 31, 32, 1000, 1024, 1030, 8192, 8193)
SUBSETS = {"both": ("image", "text"), "image": ("image",), "text": ("text",)}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the staged route is CUDA's")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _clean():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(0)
    return {m: rng.standard_normal((9000, w)).astype(np.float32)
            for m, w in WIDTH.items()}


def _predictor(apply_fn, device):
    return FusionPredictor(apply_fn, modality_names=("image", "text"),
                           buckets=BUCKETS, device=device)


def _model(device):
    from aecf_tpu_torch.models import VisionLanguageModel

    return VisionLanguageModel(device=device).eval()


def _warm(pred, rows):
    """The benchmark's warm-up: every bucket under every modality subset,
    twice (the first call of each eager, the second captures)."""
    for b in pred.buckets:
        for subset in SUBSETS:
            for _ in range(2):
                pred(**_request(rows, b, subset))


@pytest.fixture(scope="module")
def served(card, rows):
    """The benchmark's model at its widths behind a predictor warmed as the
    benchmark warms it: every key's graph captured."""
    model = _model(card)
    pred = _predictor(lambda image, text: model(image, text), card)
    _warm(pred, rows)
    assert pred.captures == len(BUCKETS) * len(SUBSETS)
    pred.model = model
    return pred


def _request(rows, n, subset, start=0):
    return {m: rows[m][start : start + n] for m in SUBSETS[subset]}


def _blocking(pred, request, n):
    """The blocking route's answer from the same predictor: each chunk of
    the largest bucket zero-padded in numpy, one ``_call_bucket`` each."""
    outs = []
    top = pred.buckets[-1]
    for start in range(0, n, top):
        chunk_n = min(n - start, top)
        bucket = pad_to_bucket(chunk_n, pred.buckets)
        mods = []
        for k in pred.modality_names:
            x = np.zeros((bucket, WIDTH[k]), np.float32)
            if k in request:
                x[:chunk_n] = request[k][start : start + chunk_n]
            mods.append(x)
        outs.append(pred._call_bucket(bucket, mods)[:chunk_n])
    return np.concatenate(outs)


def _mixing(image, text):
    """Every row's answer depends on every row of its bucket, padding
    included, so a stale padding row shows in the answer."""
    return (image[:, :5] + text[:, :5] + image.sum(0)[:5]
            + text.sum(0)[:5])


@pytest.mark.card
@pytest.mark.parametrize("subset", SUBSETS)
@pytest.mark.parametrize("n", ROWS)
def test_staged_answers_equal_the_blocking_route(served, rows, n, subset):
    req = _request(rows, n, subset, start=n % 7)
    calls, staged, graphed = served.calls, served.staged, served.graphed
    got = served(**req)
    assert (served.calls - calls == served.staged - staged
            == served.graphed - graphed == -(-n // 1024))
    want = _blocking(served, req, n)
    assert got.dtype == np.float32 and got.shape == want.shape == (n, CLASSES)
    np.testing.assert_array_equal(got, want)
    # the eager staged route: a default argument is no closure cell, so
    # this apply_fn reaches no Module
    model = served.model
    eager = _predictor(lambda image, text, m=model: m(image, text),
                       served.device)
    eager._dims = dict(served._dims)
    np.testing.assert_array_equal(got, eager(**req))
    assert eager.graphed == eager.captures == 0 and not eager._graphs


@pytest.mark.card
def test_a_short_request_after_a_long_one_sees_zero_padding(card, rows):
    pred = _predictor(_mixing, card)
    for n, subset, start in ((8193, "both", 0), (1000, "both", 3),
                             (5, "both", 11), (8193, "both", 17),
                             (31, "both", 2), (700, "image", 5),
                             (20, "text", 9)):
        req = _request(rows, n, subset, start)
        got = pred(**req)
        np.testing.assert_array_equal(got, _blocking(pred, req, n),
                                      err_msg=f"{n} {subset}")
    assert pred.staged == pred.calls == 9 + 1 + 1 + 9 + 1 + 1 + 1


@pytest.mark.card
@pytest.mark.parametrize("n", (31, 8192))
def test_an_answer_outlives_the_next_request(served, rows, n):
    first = served(**_request(rows, n, "both"))
    kept = first.copy()
    second = served(**_request(rows, n, "both", start=500))
    assert first.flags.owndata and second.flags.owndata
    assert not np.shares_memory(first, second)
    np.testing.assert_array_equal(first, kept)
    assert not np.array_equal(first, second)


@pytest.mark.card
def test_read_only_and_reversed_rows_are_staged(card, rows):
    """Rows ``torch.from_numpy`` refuses (negative strides) or warns of
    (read-only) take numpy's copy."""
    pred = _predictor(_mixing, card)
    image = rows["image"][1500:0:-1]
    text = rows["text"][:1500].copy()
    text.flags.writeable = False
    req = {"image": image, "text": text}
    np.testing.assert_array_equal(pred(**req), _blocking(pred, req, 1500))
    assert pred.staged == pred.calls == 2


@pytest.mark.card
def test_every_bucket_call_is_staged(card, rows):
    pred = _predictor(_mixing, card)
    for n in (1, 1030, 8193):
        pred(**_request(rows, n, "both"))
    pred(**_request(rows, 300, "image"))
    assert pred.staged == pred.calls == 1 + 2 + 9 + 1


@pytest.mark.card
def test_staged_spans_keep_their_names_and_counts(card, rows):
    pred = _predictor(_mixing, card)
    pred(**_request(rows, 1, "both"))
    with profiling.recording():
        pred(**_request(rows, 1030, "both"))
        pred(**_request(rows, 40, "image"))
    recs = profiling.spans()
    both, image = [r for r in recs if r.name == "predictor.request"]
    assert both.counts == {"rows": 1030} and image.counts == {"rows": 40}

    def named(name, req):
        return [r for r in recs if r.name == name and r.parent == req.id]

    assert [(r.counts["rows"], r.counts["padded"])
            for r in named("predictor.pad", both)] == [(1024, 1024), (6, 32)]
    assert [r.counts["bytes"] for r in named("predictor.h2d", both)] == [
        b * (WIDTH["image"] + WIDTH["text"]) * 4 for b in (1024, 32)]
    assert [r.counts["bytes"] for r in named("predictor.d2h", both)] == [
        b * 5 * 4 for b in (1024, 32)]
    assert len(named("predictor.apply", both)) == 2
    # a missing modality's zeros stay on the card: only the image is copied
    assert [r.counts["bytes"] for r in named("predictor.h2d", image)] == [
        256 * WIDTH["image"] * 4]
    for req in (both, image):
        kids = [r for r in recs if r.parent == req.id]
        assert {r.name for r in kids} == {"predictor.pad", "predictor.h2d",
                                          "predictor.apply", "predictor.d2h"}
    assert not [r for r in recs if r.name == "predictor.concat"]


@pytest.mark.card
def test_a_failed_request_leaves_the_slots_usable(card, rows):
    state = {"bucket": 0, "fail_at": 2}

    def flaky(image, text):
        state["bucket"] += 1
        if state["bucket"] == state["fail_at"]:
            raise RuntimeError("planted failure")
        return _mixing(image, text)

    pred = _predictor(flaky, card)
    with pytest.raises(RuntimeError, match="planted failure"):
        pred(**_request(rows, 4000, "both"))
    assert pred.calls == pred.staged <= 1
    assert "image" not in pred._dims  # nothing committed
    assert not pred._staging.lock.locked()
    state["fail_at"] = -1
    calls = pred.calls
    req = _request(rows, 4000, "both", start=21)
    got = pred(**req)
    assert pred.calls - calls == 4
    np.testing.assert_array_equal(got, _blocking(pred, req, 4000))


@pytest.mark.card
def test_concurrent_callers_never_share_a_slot(card, rows):
    pred = _predictor(_mixing, card)
    jobs = [(n, start) for n in (1030, 2048, 33) for start in (0, 7, 101)]
    got = {}

    def client(job):
        n, start = job
        for _ in range(3):
            out = pred(**_request(rows, n, "both", start))
            got.setdefault(job, []).append(out)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(job,))
                   for job in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    for (n, start), outs in got.items():
        want = _blocking(pred, _request(rows, n, "both", start), n)
        assert len(outs) == 3
        for out in outs:
            np.testing.assert_array_equal(out, want, err_msg=f"{n} {start}")
    assert pred.staged == pred.calls


@pytest.mark.card
def test_a_frozen_predictor_takes_the_staged_route(served, rows, tmp_path):
    path = tmp_path / "vlm.npz"
    export_predictor(served, str(path))
    frozen = load_exported_predictor(str(path))
    # the second pass replays every key's program as a graph
    for turn, (n, subset) in itertools.product(
            range(2), ((1030, "both"), (8193, "both"), (300, "image"),
                       (31, "text"))):
        req = _request(rows, n, subset, start=3)
        got = frozen(**req)
        np.testing.assert_array_equal(got, _blocking(frozen, req, n),
                                      err_msg=f"{turn} {n} {subset}")
        np.testing.assert_allclose(got, served(**req), rtol=0, atol=1e-6,
                                   err_msg=f"{turn} {n} {subset}")
    assert frozen.staged == frozen.calls == 2 * (2 + 9 + 1 + 1)
    # (1024, both) and (32, both) capture in the first pass's second
    # request, (1024, image) and (32, text) in the second pass
    assert frozen.captures == 4 and frozen.graphed == 9 + 13


@pytest.mark.card
def test_after_the_warm_up_every_bucket_call_replays(served, rows):
    from aecf_tpu_torch.kernels import shared_query_fwd

    captures = served.captures
    for n, subset in ((8192, "both"), (1030, "image"), (300, "text"),
                      (8193, "both")):
        calls, staged, graphed = served.calls, served.staged, served.graphed
        launches = shared_query_fwd.launches
        served(**_request(rows, n, subset, start=5))
        buckets = -(-n // 1024)
        assert (served.calls - calls == served.staged - staged
                == served.graphed - graphed == buckets)
        assert shared_query_fwd.launches - launches == buckets
    assert served.captures == captures


def _fresh_served(card, rows):
    model = _model(card)
    pred = _predictor(lambda image, text: model(image, text), card)
    pred(**_request(rows, 1, "both"))
    return model, pred


@pytest.mark.card
def test_a_replay_sees_weights_updated_in_place(card, rows):
    model, pred = _fresh_served(card, rows)
    req = _request(rows, 1030, "both", start=9)
    pred(**req)  # (1024, both) first and eager; (32, both) captures
    pred(**req)
    assert pred.captures == 2
    before = pred(**req)
    with torch.no_grad():
        model.classifier.weight.mul_(-2.0)
        model.pool.out_proj_bias.add_(0.5)
    graphed = pred.graphed
    got = pred(**req)
    assert pred.graphed - graphed == 2 and pred.captures == 2
    assert not np.array_equal(got, before)
    np.testing.assert_array_equal(got, _blocking(pred, req, 1030))


@pytest.mark.card
def test_a_replaced_parameter_recaptures(card, rows):
    model, pred = _fresh_served(card, rows)
    req = _request(rows, 40, "both", start=2)
    pred(**req)  # the (256, both) key's first call, eager
    pred(**req)
    assert pred.captures == 1
    before = pred(**req)
    old = model.classifier.weight
    model.classifier.weight = torch.nn.Parameter(old.detach() * 3.0)
    graphed = pred.graphed
    got = pred(**req)
    assert pred.captures == 2 and pred.graphed - graphed == 1
    assert not np.array_equal(got, before)
    np.testing.assert_array_equal(got, _blocking(pred, req, 40))
    model.eval()  # no change: the next call replays the new graph
    pred(**req)
    assert pred.captures == 2 and pred.graphed - graphed == 2


@pytest.mark.card
def test_an_apply_fn_that_syncs_the_host_stays_eager(card, rows):
    model = _model(card)
    seen = []

    def syncing(image, text):
        out = model(image, text)
        seen.append(out[0, 0].item())
        return out

    pred = _predictor(syncing, card)
    for n, start in ((300, 0), (300, 4), (1030, 8), (300, 1)):
        req = _request(rows, n, "both", start)
        np.testing.assert_array_equal(pred(**req), _blocking(pred, req, n))
    assert pred.graphed == pred.captures == 0
    assert pred._graphs[(1024, (True, 2048), (True, 768))].failed
    # a model graphed after the failed capture still captures and replays
    model2, pred2 = _fresh_served(card, rows)
    req = _request(rows, 5, "both", start=3)
    pred2(**req)
    np.testing.assert_array_equal(pred2(**req), _blocking(pred2, req, 5))
    assert pred2.captures == 1 and pred2.graphed == 2


@pytest.mark.card
def test_an_apply_fn_over_no_module_stays_eager(card, rows):
    pred = _predictor(_mixing, card)
    for _ in range(3):
        pred(**_request(rows, 1030, "both"))
    assert pred.staged == pred.calls == 6
    assert pred.graphed == pred.captures == 0 and not pred._graphs


@pytest.mark.card
def test_the_capture_span_opens_only_at_capture(card, rows):
    _, pred = _fresh_served(card, rows)
    with profiling.recording():
        for _ in range(3):  # the (256, both) key: eager, captured, replayed
            pred(**_request(rows, 40, "both"))
    recs = profiling.spans()
    requests = [r for r in recs if r.name == "predictor.request"]
    assert len(requests) == 3
    for req, captured in zip(requests, (False, True, False)):
        kids = [r for r in recs if r.parent == req.id]
        names = {"predictor.pad", "predictor.h2d", "predictor.apply",
                 "predictor.d2h"} | ({"predictor.capture"} if captured
                                     else set())
        assert {r.name for r in kids} == names
        for name in names:
            assert len([r for r in kids if r.name == name]) == 1, name
    # its parent is the request, and it sits between the copy and the apply
    capture = next(r for r in recs if r.name == "predictor.capture")
    assert capture.parent == requests[1].id
    order = [r.name for r in sorted(recs, key=lambda r: r.start_ns)
             if r.parent == requests[1].id]
    assert order[order.index("predictor.capture") - 1:][:3] == [
        "predictor.h2d", "predictor.capture", "predictor.apply"]
    assert pred.captures == 1 and pred.graphed == 2


def test_the_cpu_keeps_the_blocking_route():
    rng = np.random.default_rng(1)
    image = rng.standard_normal((1030, 6)).astype(np.float32)
    text = rng.standard_normal((1030, 5)).astype(np.float32)
    pred = FusionPredictor(_mixing, modality_names=("image", "text"),
                           buckets=BUCKETS, device="cpu")
    with profiling.recording():
        got = pred(image=image, text=text)
        pred(image=image[:9])
    assert pred.calls == 3 and pred.staged == 0
    assert pred.graphed == pred.captures == 0
    assert not pred._staging.slots and not pred._graphs
    recs = profiling.spans()
    requests = [r for r in recs if r.name == "predictor.request"]
    assert len(requests) == 2
    for req, buckets in zip(requests, (2, 1)):
        kids = [r for r in recs if r.parent == req.id]
        for name in ("predictor.pad", "predictor.h2d", "predictor.apply",
                     "predictor.d2h"):
            assert len([r for r in kids if r.name == name]) == buckets, name
        assert len([r for r in kids if r.name == "predictor.concat"]) == 1
    want = np.concatenate([
        _mixing(*(torch.from_numpy(np.pad(x[s:s + c], ((0, b - c), (0, 0))))
                  for x in (image, text))).sigmoid().numpy()[:c]
        for s, c, b in ((0, 1024, 1024), (1024, 6, 32))])
    np.testing.assert_array_equal(got, want)


class _Mix(torch.nn.Module):
    """A small two-modality model: a Linear of each, summed, and one of
    them again through a nested Module."""

    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(3)
        self.image = torch.nn.Linear(6, 4)
        self.text = torch.nn.Linear(5, 4)
        self.head = torch.nn.Sequential(torch.nn.Linear(4, 3))
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=gen))
        self.register_buffer("shift", torch.full((3,), 0.25))

    def forward(self, image, text):
        return self.head(self.image(image) + self.text(text)) + self.shift

    def call(self, image, text):
        return self(image, text)


def _cpu_rows(n):
    rng = np.random.default_rng(4)
    return (rng.standard_normal((n, 6)).astype(np.float32),
            rng.standard_normal((n, 5)).astype(np.float32))


def _closure_over(model):
    return lambda image, text: model(image, text)


def _reached(apply_fn):
    pred = FusionPredictor(apply_fn, modality_names=("image", "text"),
                           buckets=BUCKETS, device="cpu")
    return pred._reached(32)


def test_the_modules_a_predictor_reads_are_found():
    model = _Mix()
    other = _Mix()
    assert _reached(_closure_over(model)) == [model]
    assert _reached(model) == [model]
    assert _reached(model.call) == [model]
    # two Modules in the closure cells, and a default argument, no cell
    assert _reached(lambda image, text: model(image, text)
                    + other(image, text)) == [model, other]
    assert _reached(lambda image, text, m=model: m(image, text)) == []
    assert _reached(_mixing) == []
    state = {"n": 0}
    assert _reached(lambda image, text: _mixing(image, text)
                    + state["n"]) == []


def test_the_graph_state_follows_the_tensors_the_modules_hold():
    model = _Mix().eval()
    pred = FusionPredictor(_closure_over(model),
                           modality_names=("image", "text"),
                           buckets=BUCKETS, device="cpu")
    state = pred._graph_state(32)
    assert state is not None and state == pred._graph_state(256)
    # in place: the same addresses, so the same state (a replay sees it)
    with torch.no_grad():
        model.head[0].weight.mul_(2.0)
        model.shift.add_(1.0)
    model.load_state_dict(_Mix().state_dict())
    assert pred._graph_state(32) == state
    # a nested Module's parameter replaced, a buffer replaced, a mode flip,
    # another sigmoid setting: each changes it
    model.head[0].bias = torch.nn.Parameter(model.head[0].bias.detach() + 1)
    replaced = pred._graph_state(32)
    assert replaced != state
    model.shift = torch.zeros(3)
    assert pred._graph_state(32) not in (state, replaced)
    now = pred._graph_state(32)
    model.head.train()
    assert pred._graph_state(32) != now
    model.head.eval()
    assert pred._graph_state(32) == now
    pred.apply_sigmoid = False
    assert pred._graph_state(32) != now
    # an apply_fn over no Module has none: its calls stay eager
    assert FusionPredictor(_mixing, modality_names=("image", "text"),
                           device="cpu")._graph_state(32) is None


@pytest.mark.parametrize("how", ("closure", "module", "bound method"))
def test_a_module_apply_fn_keeps_the_blocking_route_on_the_cpu(how):
    model = _Mix().eval()
    apply_fn = {"closure": _closure_over(model), "module": model,
                "bound method": model.call}[how]
    pred = FusionPredictor(apply_fn, modality_names=("image", "text"),
                           buckets=BUCKETS, device="cpu")
    image, text = _cpu_rows(1030)
    for _ in range(3):
        got = pred(image=image, text=text)
        only = pred(image=image[:40])
    assert pred.calls == 3 * 3 and pred.staged == 0
    assert pred.graphed == pred.captures == 0 and not pred._graphs
    with torch.no_grad():
        want = model(torch.from_numpy(image),
                     torch.from_numpy(text)).sigmoid().numpy()
        want_only = model(torch.from_numpy(image[:40]),
                          torch.zeros((40, 5))).sigmoid().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(only, want_only, rtol=0, atol=1e-6)
