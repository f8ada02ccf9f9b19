"""``FusionPredictor``'s staged route: on the card each bucket goes through
reused pinned slots, one bucket ahead of the answers read.  Held bit for
bit to the blocking route (``_call_bucket`` on numpy-padded buckets) at
every bucket edge and modality subset; a short request after a long one in
the same slots; answers that outlive the next request; ``staged ==
calls``; the spans; a failed request; concurrent callers; a frozen
predictor.  On the CPU the blocking route stays, ``staged`` at 0.

This file imports no JAX, so the ``card`` tests run on a machine without
it: ``python -m pytest --noconftest tests/test_torch_port_serve_staging.py
-m card``.
"""

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


@pytest.fixture(scope="module")
def served(card, rows):
    """The benchmark's model at its widths behind a predictor that has seen
    both modalities (so either may be missing)."""
    from aecf_tpu_torch.models import VisionLanguageModel

    model = VisionLanguageModel(device=card).eval()
    pred = _predictor(lambda image, text: model(image, text), card)
    pred(**_request(rows, 1, "both"))
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
    calls, staged = served.calls, served.staged
    got = served(**req)
    assert served.calls - calls == served.staged - staged == -(-n // 1024)
    want = _blocking(served, req, n)
    assert got.dtype == np.float32 and got.shape == want.shape == (n, CLASSES)
    np.testing.assert_array_equal(got, want)


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
    for n, subset in ((1030, "both"), (8193, "both"), (300, "image"),
                      (31, "text")):
        req = _request(rows, n, subset, start=3)
        got = frozen(**req)
        np.testing.assert_array_equal(got, _blocking(frozen, req, n),
                                      err_msg=f"{n} {subset}")
        np.testing.assert_allclose(got, served(**req), rtol=0, atol=1e-6,
                                   err_msg=f"{n} {subset}")
    assert frozen.staged == frozen.calls == 2 + 9 + 1 + 1


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
    assert not pred._staging.slots
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
