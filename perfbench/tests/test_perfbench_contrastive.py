"""The four-card contrastive cell's plumbing on the CPU: its driver over two
gloo ranks at a small size end to end (no metric reported), the control
and the planted faults against the cell's limits, a checkout without the
contrastive step failing at once, and the modules a run loads."""

import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT
from perfbench import harness, spec
from perfbench.tracing import Tracer

CELL = "large-dp4-train"
SMALL = ({"global_batch": 32, "ranks": 2, "steps_per_call": 3,
          "warm_calls": 1}, {"embed_dim": 64, "proj_dim": 16})


def _cell():
    cell = spec.load(ROOT, CELL)
    cell.traffic.update(SMALL[0])
    cell.config.update(SMALL[1])
    return cell


@pytest.fixture(scope="module")
def run():
    """One small run over two gloo ranks, released, for its readings."""
    r = harness._driver(_cell(), 2**33 + 9, torch.device("cpu"))
    r.setup()
    r.window(0.3, Tracer(False, 0, 0, dict))
    r.release()
    return r


def test_dry_run_reports_no_device_metric():
    res = harness.run_cell(_cell(), 2**33 + 7, 0.5, False, time.monotonic(),
                           device="cpu")
    assert res["metrics"] == {}
    assert res["device"]["platform"] == "cpu"
    assert res["attempted"] > 0 and res["failed"] == 0
    read = {k: c for k, c in res["checks"].items() if c["value"] is not None}
    assert set(read) == {"loss_gap", "grad_gap", "update_gap"}
    for k, c in read.items():
        assert c["value"] <= c["limit"], (k, c)


@pytest.mark.parametrize("kind,number", [
    ("control", None), ("half_batch", "grad_gap"),
    ("local_negatives", "loss_gap")])
def test_control_and_faults_are_not_correct(run, kind, number):
    cell = _cell()
    correct, checks = harness.evaluate(run.reading(kind), cell.limits)
    assert correct is False, checks
    if number is not None:
        assert checks[number]["value"] > checks[number]["limit"], checks


def test_unfolded_masks_move_only_the_masks(run):
    """Masks from the step's unfolded words (the same on every rank): the
    masks move, the loss and the gradients do not (the pool's output
    never reads the mask)."""
    n = run.reading("mask_altered")
    assert n["loss_gap"] == 0 and n["grad_gap"] == 0 and n["update_gap"] == 0


def test_a_checkout_without_the_step_fails_at_once(monkeypatch):
    import aecf_tpu_torch.train as train

    monkeypatch.delattr(train, "make_contrastive_scan_train_step")
    r = harness._driver(_cell(), 1, torch.device("cpu"))
    t0 = time.monotonic()
    with pytest.raises(ImportError):
        r.setup()
    assert not r.procs and time.monotonic() - t0 < 30


def test_the_run_loads_no_jax_and_the_reference_no_port():
    code = (
        "import sys; sys.path.insert(0, '.');"
        "import perfbench.reference.contrastive;"
        "assert not [m for m in sys.modules if m.split('.')[0] == "
        "'aecf_tpu_torch'], 'the reference loaded the port';"
        "import perfbench.harness, perfbench.roofline_contrastive;"
        "from perfbench.drivers import train_contrastive_dp;"
        "import aecf_tpu_torch.train.contrastive;"
        "print(perfbench.harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_readers_are_silent_without_a_trace():
    import types

    ctx = types.SimpleNamespace(trace=None, work={}, config=_cell().config,
                                traffic=_cell().traffic, roofline=None)
    for m in _cell().per_layer:
        assert spec.reader(ROOT, m["name"])(ctx) is None, m["name"]
