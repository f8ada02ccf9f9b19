"""The port's span recorder (``aecf_tpu_torch.utils.profiling.span``) and
the spans the serving and training host paths record: off by default and
then one shared no-op, parents and self times inside ``recording()`` and
across threads, the profiler's clock, the predictor's per-bucket spans, the
batcher's queue spans, ``fit``'s gathers and stages, and (on the card) the
chunk graph's.  Beside them, ``ReplayCounts``: what a graph's replay adds
to the counters its capture read.

This file imports no JAX, so the ``card`` test runs on a machine without it:
``python -m pytest --noconftest tests/test_torch_port_spans.py -m card``.
"""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aecf_tpu_torch.serve import FusionPredictor, MicroBatcher
from aecf_tpu_torch.train import (
    TrainState,
    as_fit_chunk,
    as_fit_step,
    fit,
    init_pool_classifier_params,
    make_epoch_batch_fn,
    make_pool_scan_train_step,
    make_pool_train_step,
    param_leaves,
)
from aecf_tpu_torch.utils import profiling


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the chunk graph is CUDA's")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _clean():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _named(records, name):
    return [r for r in records if r.name == name]


def _self_ns(records, rec):
    """The span's duration less its children's (same-thread children do not
    overlap)."""
    kids = [r for r in records if r.parent == rec.id]
    return rec.end_ns - rec.start_ns - sum(k.end_ns - k.start_ns for k in kids)


def test_off_records_nothing_and_returns_one_object():
    a = profiling.span("a", bytes=1)
    b = profiling.span("b", 7)
    assert a is b
    with a as s:
        s.add(bytes=3)
    assert profiling.stamp() is None
    assert profiling.spans() == [] and profiling.spans().dropped == 0


def test_off_lets_an_exception_through():
    with pytest.raises(KeyError):
        with profiling.span("a"):
            raise KeyError("x")


def test_recording_parents_self_times_and_counts():
    with profiling.recording():
        with profiling.span("outer", 5, rows=3) as outer:
            time.sleep(0.02)
            with profiling.span("inner", bytes=8) as inner:
                inner.add(padded=32)
                time.sleep(0.03)
        with profiling.span("next"):
            pass
    with profiling.span("after"):
        pass
    recs = profiling.spans()
    assert [r.name for r in recs] == ["inner", "outer", "next"]
    inner, outer, nxt = recs
    assert outer.parent is None and nxt.parent is None
    assert inner.parent == outer.id
    assert outer.request == 5 and outer.counts == {"rows": 3}
    assert inner.counts == {"bytes": 8, "padded": 32}
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert 0.03e9 <= inner.end_ns - inner.start_ns < 0.1e9
    own = _self_ns(recs, outer)
    assert 0.02e9 <= own < 0.05e9
    assert own == (outer.end_ns - outer.start_ns) - (inner.end_ns
                                                     - inner.start_ns)
    assert all(r.thread == threading.get_ident() for r in recs)


def test_parents_stay_on_their_thread():
    """A span opened on another thread while one is open here is no child
    of it, and this thread's next child still is."""
    ready, done = threading.Event(), threading.Event()

    def worker():
        ready.wait(5)
        with profiling.span("worker.outer"):
            with profiling.span("worker.inner"):
                pass
        done.set()

    t = threading.Thread(target=worker)
    t.start()
    with profiling.recording():
        with profiling.span("main.outer"):
            ready.set()
            assert done.wait(5)
            with profiling.span("main.inner"):
                pass
    t.join(5)
    assert not t.is_alive()
    recs = {r.name: r for r in profiling.spans()}
    assert recs["worker.outer"].parent is None
    assert recs["worker.inner"].parent == recs["worker.outer"].id
    assert recs["main.inner"].parent == recs["main.outer"].id
    assert recs["worker.outer"].thread != recs["main.outer"].thread


def test_the_bound_keeps_the_newest_and_counts_the_rest(monkeypatch):
    monkeypatch.setattr(profiling, "_RECORDER", profiling._Recorder(4))
    with profiling.recording():
        for i in range(6):
            with profiling.span(f"s{i}"):
                pass
    recs = profiling.spans()
    assert [r.name for r in recs] == ["s2", "s3", "s4", "s5"]
    assert recs.dropped == 2
    profiling.clear_spans()
    assert profiling.spans() == [] and profiling.spans().dropped == 0


def test_a_span_ended_on_another_thread():
    with profiling.recording():
        t0 = profiling.stamp()
    assert t0 is not None
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "id", profiling.record("queued", t0, 3, rows=2)))
    t.start()
    t.join(5)
    (rec,) = profiling.spans()
    assert (rec.name, rec.request, rec.counts, rec.parent) == (
        "queued", 3, {"rows": 2}, None)
    assert rec.start_ns == t0 <= rec.end_ns and rec.thread != threading.get_ident()


def test_the_profiler_records_on_its_clock():
    """Inside a CPU profile spans record, and are the profile's named
    ranges too; a span around an op holds that op's profiler event to
    within 100 us; after the profile nothing records."""
    x = torch.ones(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("around.sum"):
            x.sum()
    with profiling.span("later"):
        pass
    (rec,) = profiling.spans()
    assert rec.name == "around.sum"
    events = prof.profiler.kineto_results.events()
    assert any(e.name() == "around.sum" for e in events)
    slack = 100_000
    (op,) = [e for e in events if e.name() == "aten::sum"][:1]
    start = op.start_ns()
    end = start + op.duration_ns()
    assert rec.start_ns - slack <= start <= end <= rec.end_ns + slack
    # the profiler's stamps are unix-epoch nanoseconds, as the span's
    assert abs(start - time.time_ns()) < 60e9


def _predictor(buckets=(32, 256, 1024)):
    return FusionPredictor(
        lambda image, text: image[:, :3] + text[:, :3],
        modality_names=("image", "text"), buckets=buckets, device="cpu")


def test_predictor_request_spans_a_bucket_set_each():
    rng = np.random.default_rng(0)
    image = rng.standard_normal((1030, 6)).astype(np.float32)
    text = rng.standard_normal((1030, 4)).astype(np.float32)
    pred = _predictor()
    with profiling.recording():
        out = pred(image=image, text=text)
    assert out.shape == (1030, 3)
    recs = profiling.spans()
    (req,) = _named(recs, "predictor.request")
    assert req.counts == {"rows": 1030} and req.request == 0
    for name in ("predictor.pad", "predictor.h2d", "predictor.apply",
                 "predictor.d2h"):
        got = _named(recs, name)
        assert len(got) == 2, name
        assert all(r.parent == req.id for r in got), name
    pads = _named(recs, "predictor.pad")
    assert [(r.counts["rows"], r.counts["padded"]) for r in pads] == [
        (1024, 1024), (6, 32)]
    assert [r.counts["bytes"] for r in _named(recs, "predictor.h2d")] == [
        np.zeros((b, 6), np.float32).nbytes
        + np.zeros((b, 4), np.float32).nbytes for b in (1024, 32)]
    assert [r.counts["bytes"] for r in _named(recs, "predictor.d2h")] == [
        np.zeros((b, 3), np.float32).nbytes for b in (1024, 32)]
    (cat,) = _named(recs, "predictor.concat")
    assert cat.parent == req.id
    # request ids count per predictor
    with profiling.recording():
        pred(image=image[:5], text=text[:5])
    assert [r.request for r in _named(profiling.spans(),
                                      "predictor.request")] == [0, 1]


def test_batcher_queues_each_request_once():
    pred = _predictor(buckets=(8, 64))
    batcher = MicroBatcher(pred, max_batch=64, max_wait_ms=50.0)
    rows = np.ones((2, 6), np.float32), np.ones((2, 4), np.float32)
    n = 6
    try:
        with profiling.recording():
            threads = [threading.Thread(
                target=lambda: batcher(image=rows[0], text=rows[1]))
                for _ in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(10)
            assert not any(t.is_alive() for t in threads)
    finally:
        batcher.stop()
    recs = profiling.spans()
    queued = _named(recs, "batcher.queued")
    assert sorted(r.request for r in queued) == list(range(n))
    assert all(r.start_ns <= r.end_ns for r in queued)
    forms = _named(recs, "batcher.form")
    assert sum(r.counts["requests"] for r in forms) == n
    assert sum(r.counts["rows"] for r in forms) == 2 * n
    calls = _named(recs, "batcher.call")
    by_id = {r.id: r for r in recs}
    requests = _named(recs, "predictor.request")
    assert len(requests) == len(calls) == len(_named(recs, "batcher.scatter"))
    assert all(by_id[r.parent].name == "batcher.call" for r in requests)


def _fit_run(num_steps, chunk):
    E, C, B = 8, 3, 4
    rng = np.random.default_rng(1)
    data = {"image": rng.standard_normal((40, E)).astype(np.float32),
            "text": rng.standard_normal((40, E)).astype(np.float32),
            "label": (rng.random((40, C)) < 0.3).astype(np.float32)}
    params = init_pool_classifier_params(torch.Generator().manual_seed(0), E,
                                         C, device="cpu")
    return fit(None, lambda ps: torch.optim.SGD(ps, lr=1e-2), params,
               make_epoch_batch_fn(data, B, seed=2), num_steps=num_steps,
               rng=5, log_every=1, scan_chunk=chunk,
               step_fn=as_fit_step(make_pool_train_step(impl="torch")),
               chunk_fn=as_fit_chunk(make_pool_scan_train_step(impl="torch")))


@pytest.mark.parametrize("num_steps,chunk", [(7, 3), (4, 1)])
def test_fit_gathers_once_a_step_and_stages_once_a_chunk(num_steps, chunk):
    with profiling.recording():
        state, _ = _fit_run(num_steps, chunk)
    assert state.step == num_steps
    recs = profiling.spans()
    by_id = {r.id: r for r in recs}
    calls = -(-num_steps // chunk)
    gathers = _named(recs, "fit.gather")
    assert len(gathers) == num_steps
    assert all(by_id[r.parent].name == "fit.stage" for r in gathers)
    assert len(_named(recs, "fit.stage")) == calls
    assert len(_named(recs, "fit.step")) == calls
    assert len(_named(recs, "fit.log")) == calls
    # the CPU runs the chunk's K steps eagerly, inside fit.step
    eager = _named(recs, "chunk.eager")
    assert len(eager) == (calls if chunk > 1 else 0)
    assert all(by_id[r.parent].name == "fit.step" for r in eager)


@pytest.mark.card
def test_chunk_graph_spans(card):
    K, B, M, E, C = 4, 64, 3, 32, 5
    params = init_pool_classifier_params(
        torch.Generator(card).manual_seed(0), E, C, device=card)
    state = TrainState(params, torch.optim.AdamW(
        param_leaves(params), lr=1e-3, weight_decay=0.01, capturable=True))
    g = torch.Generator(card).manual_seed(1)
    kv = torch.randn((K, B, M * E), generator=g, device=card)
    labels = (torch.rand((K, B, C), generator=g, device=card) < 0.3).float()
    chunk = make_pool_scan_train_step(impl="fused-step")
    with profiling.recording():
        for _ in range(3):
            state, losses, _ = chunk(state, kv, labels, 7)
        torch.cuda.synchronize(card)
    assert torch.isfinite(losses).all()
    recs = profiling.spans()
    assert len(_named(recs, "chunk.capture")) == 1
    for name in ("chunk.stage", "chunk.words", "chunk.launch"):
        assert len(_named(recs, name)) == 3, name
    assert len(_named(recs, "chunk.wait")) == 2  # none before the first
    assert [r.counts["bytes"] for r in _named(recs, "chunk.stage")] == [
        kv.nbytes + labels.nbytes] * 3
    assert not _named(recs, "chunk.eager")


def test_replay_counts_take_what_the_capture_counted():
    import types

    both = types.SimpleNamespace(launches=5, launches_q8=1)
    one = types.SimpleNamespace(launches=2)  # no launches_q8
    other = types.SimpleNamespace(calls=10)
    counts = profiling.ReplayCounts((both, one), [(other, "calls")])
    assert counts.cells == [(both, "launches"), (both, "launches_q8"),
                            (one, "launches"), (other, "calls")]
    with counts.capturing():
        both.launches += 3
        one.launches += 1
        other.calls += 2
    # capturing launched nothing: the counts are back, and each replay adds
    assert (both.launches, both.launches_q8, one.launches, other.calls) == (
        5, 1, 2, 10)
    assert counts.added == [3, 0, 1, 2]
    counts.replayed()
    counts.replayed()
    assert (both.launches, both.launches_q8, one.launches, other.calls) == (
        11, 1, 4, 14)
    # a capture that raises leaves the counts as they were, too
    with pytest.raises(RuntimeError, match="capture failed"):
        with counts.capturing():
            both.launches += 7
            raise RuntimeError("capture failed")
    assert both.launches == 11 and counts.added == [7, 0, 0, 0]
