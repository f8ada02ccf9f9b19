"""The run's plumbing on the CPU: the module check, the refusal to report
without a card, each cell's dry run at small sizes, the planted faults that
must come out not correct, the control, and a cell added by files alone."""

import json
import os
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

from conftest import ROOT, SMALL, small_cell
from perfbench import harness, spec

RUN = [sys.executable, "perfbench/run.py", "--workload", "ns-train-chunk",
       "--seed", "1", "--seconds", "1", "--trace", "0"]


def _dry(cell, seed=2**33 + 7, seconds=0.5):
    return harness.run_cell(cell, seed, seconds, False, time.monotonic(),
                            device="cpu")


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("aecf_tpu_torch", "aecf_tpu_torch.kernels", "jaxtyping",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "aecf_tpu.core", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["aecf_tpu", "jax"]


def test_the_run_loads_no_jax_and_the_reference_no_port():
    """In a fresh process: everything a run imports, then the reference
    alone."""
    code = (
        "import sys; sys.path.insert(0, '.');"
        "import perfbench.reference.pool_classifier, "
        "perfbench.reference.vision_language, perfbench.reference.epoch;"
        "assert not [m for m in sys.modules if m.split('.')[0] == "
        "'aecf_tpu_torch'], 'the reference loaded the port';"
        "import perfbench.harness, perfbench.models, perfbench.sweep, "
        "perfbench.readings;"
        "from perfbench.drivers import train_chunk, train_fit, serve_open, "
        "serve_bulk;"
        "import aecf_tpu_torch, aecf_tpu_torch.train, aecf_tpu_torch.serve, "
        "aecf_tpu_torch.models, aecf_tpu_torch.measure;"
        "print(perfbench.harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run(RUN, cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "card" in out.stderr


def test_run_refuses_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run(RUN, cwd=tmp_path, capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("name", sorted(SMALL))
def test_dry_run_reports_no_device_metric(name):
    """Each cell end to end on the CPU: its numbers read, within the
    cell's limits where the CPU path gives them, and no metric."""
    res = _dry(small_cell(name))
    assert res["metrics"] == {}
    assert res["device"]["platform"] == "cpu"
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    read = {k: c for k, c in res["checks"].items() if c["value"] is not None}
    assert read, res["checks"]
    for k, c in read.items():
        assert c["value"] <= c["limit"], (k, c)
    # the per-row mask and weights come from the card's graph route only
    for k, c in res["checks"].items():
        if c["value"] is None:
            assert k in ("weights_gap", "mask_share")


TRAINING = ["ns-train-chunk", "x3-fit"]


def _unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)


def _program_loss(monkeypatch, loss):
    """The program's step (and not the reference) computes its loss with
    ``loss(bce, logits, labels)``."""
    from aecf_tpu_torch.train import pool_step

    bce = torch.nn.functional.binary_cross_entropy_with_logits
    monkeypatch.setattr(pool_step, "F", types.SimpleNamespace(
        binary_cross_entropy_with_logits=lambda x, y: loss(bce, x, y)))


def _half_batch(monkeypatch):
    _program_loss(monkeypatch, lambda bce, x, y: bce(x[:len(x) // 2],
                                                     y[:len(y) // 2]))


def _loss_altered(monkeypatch):
    _program_loss(monkeypatch, lambda bce, x, y: bce(x, y) * (1 + 1e-3))


@pytest.mark.parametrize("fault,number", [
    (_unchanged, "update_gap"), (_half_batch, "loss_gap"),
    (_loss_altered, "loss_gap")])
@pytest.mark.parametrize("name", TRAINING)
def test_training_faults_are_not_correct(monkeypatch, name, fault, number):
    fault(monkeypatch)
    res = _dry(small_cell(name))
    assert res["correct"] is False
    c = res["checks"][number]
    assert c["value"] > c["limit"], res["checks"]


@pytest.mark.parametrize("name", ["vl-serve-open", "vl-serve-bulk"])
def test_an_altered_answer_is_not_correct(monkeypatch, name):
    from aecf_tpu_torch.serve import FusionPredictor

    call = FusionPredictor._call_bucket

    def altered(self, bucket, mods):
        out = call(self, bucket, mods)
        out[0, 0] += 1e-3
        return out

    monkeypatch.setattr(FusionPredictor, "_call_bucket", altered)
    res = _dry(small_cell(name))
    assert res["correct"] is False
    assert res["checks"]["prob_gap"]["value"] > res["checks"]["prob_gap"]["limit"]


@pytest.mark.parametrize("name", TRAINING)
def test_the_control_is_not_correct(name):
    """The reference one precision down (bf16 products) in the program's
    place fails the cell's limits, here at small sizes; every cell's
    control at its own sizes in the card's test below (the serving cells'
    control, TF32 products, exists on the card alone)."""
    cell = small_cell(name)
    run = harness._driver(cell, 11, torch.device("cpu"))
    run.setup()
    run.window(0.3, _off())
    run.release()
    correct, checks = harness.evaluate(run.reading("control"), cell.limits)
    assert correct is False, checks


def _off():
    from perfbench.tracing import Tracer

    return Tracer(False, 0, 0, dict)


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("seed", [6000000001, 6000000002, 6000000003])
def test_the_control_is_not_correct_at_the_cells_size(card, name, seed):
    cell = spec.any_cell(ROOT, name)
    run = harness._driver(cell, seed, card)
    run.setup()
    run.window(2.0, _off())
    run.release()
    assert harness.evaluate(run.check(), cell.limits)[0] is True
    assert harness.evaluate(run.reading("control"), cell.limits)[0] is False


def test_a_cell_added_by_files_alone(tmp_path):
    """A configuration, a traffic mix, limits and a per-layer metric in new
    files, and entries in BENCHMARK.json: the harness finds them all."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "perfbench"
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((pb / "configs" / "aecf-clipb32-c14.json").read_text())
    conf.update(name="tiny", embed_dim=32, num_classes=5)
    (pb / "configs" / "tiny.json").write_text(json.dumps(conf))
    mix = json.loads((pb / "traffic" / "chunk-b4096-m3-k16.json").read_text())
    mix.update(batch=32, modalities=4, steps_per_call=2, warm_calls=0)
    (pb / "traffic" / "tiny-mix.json").write_text(json.dumps(mix))
    (pb / "limits" / "tiny-cell.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1e-3}}))
    (pb / "metrics" / "updates_seen.tiny.py").write_text(
        "def read(ctx):\n    return ctx.work['updates']\n")
    bench["configs"].append({"name": "tiny", "source": "a test",
                             "file": "perfbench/configs/tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-cell", "config": "tiny",
                               "traffic": "tiny-mix", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("tiny-cell")
    bench["per_layer"].append({"name": "updates_seen.tiny", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": bench["end_to_end"][0]["name"],
                               "workloads": ["tiny-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load(tmp_path, "tiny-cell")
    assert cell.config["embed_dim"] == 32 and cell.traffic["modalities"] == 4
    assert [m["name"] for m in cell.per_layer] == ["updates_seen.tiny"]
    assert {m["name"] for m in cell.end_to_end} == {
        bench["end_to_end"][0]["name"], "setup_s"}
    res = _dry(cell)
    assert res["checks"]["loss_gap"]["value"] <= 1e-3
    assert spec.reader(tmp_path, "updates_seen.tiny")(
        type("ctx", (), {"work": {"updates": 7}})) == 7
