"""The X-ray cell's plumbing on the CPU at small sizes: its dry run, the
planted faults that must come out not correct, the reference's
independence from the port, and its per-layer readers."""

import subprocess
import sys
import time
import types

import torch

from conftest import ROOT
from perfbench import harness, roofline, roofline_xray, spec

SMALL = ({"batch": 64, "steps_per_call": 4, "warm_calls": 1},
         {"image_dim": 48, "text_dim": 40, "hidden_dim": 32,
          "num_classes": 5})


def _cell():
    cell = spec.load(ROOT, "xray-aecf-train")
    cell.traffic.update(SMALL[0])
    cell.config.update(SMALL[1])
    return cell


def _dry():
    return harness.run_cell(_cell(), 2**33 + 7, 0.5, False, time.monotonic(),
                            device="cpu")


def test_dry_run_reads_every_number_but_the_graphs():
    res = _dry()
    assert res["metrics"] == {} and res["failed"] == 0
    for k, c in res["checks"].items():
        if k in ("weights_gap", "first_weights_gap", "mask_share"):
            # the card's graph route only
            assert c["value"] is None
        else:
            assert c["value"] <= c["limit"], (k, c)
    assert res["checks"]["drop_share"]["value"] == 0.0
    assert res["checks"]["route_calls_off"]["value"] == 0.0


def test_unchanged_state_half_batch_and_other_draws_are_not_correct(
        monkeypatch):
    from aecf_tpu_torch.kernels import draws
    from aecf_tpu_torch.train import trainer

    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    res = _dry()
    assert res["checks"]["update_gap"]["value"] > 0.5
    monkeypatch.undo()

    bce = trainer.bce_with_logits_loss
    monkeypatch.setattr(trainer, "bce_with_logits_loss",
                        lambda x, y: bce(x[:len(x) // 2], y[:len(y) // 2]))
    res = _dry()
    c = res["checks"]["loss_gap"]
    assert res["correct"] is False and c["value"] > c["limit"]
    monkeypatch.undo()

    original = draws.uniforms
    monkeypatch.setattr(draws, "uniforms", lambda key, rows, cols, tag=0,
                        device=None: original(key, rows, cols, tag=tag + 7,
                                              device=device))
    res = _dry()
    c = res["checks"]["drop_share"]
    assert res["correct"] is False and c["value"] > 0.1


def test_the_reference_loads_no_port():
    code = ("import sys; sys.path.insert(0, '.');"
            "import perfbench.reference.xray, perfbench.roofline_xray;"
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('aecf_tpu_torch', 'aecf_tpu', 'jax')]")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_readers():
    cell = _cell()
    trace = types.SimpleNamespace(
        window_s=1.0, busy_s=0.75, counted={"updates": 10},
        device_s=lambda match: 1e-4 if match("philox_draws_uniforms") else 0)
    work = {"updates": 10, "elapsed_s": 0.02}
    ctx = types.SimpleNamespace(trace=trace, work=work, config=cell.config,
                                traffic=cell.traffic, roofline=roofline)
    got = {m: spec.reader(ROOT, m)(ctx) for m in
           ("step_mfu.xray", "draws_roofline.xray", "device_idle.xray")}
    assert got["device_idle.xray"] == spec.reader(
        ROOT, "device_idle.train")(ctx) == 25.0
    B, c = cell.traffic["batch"], cell.config
    flops = B * roofline_xray.row_flops(48, 40, 32, 2, 5)
    assert abs(got["step_mfu.xray"]
               - 100 * flops / roofline.TF32_FLOPS / 2e-3) < 1e-9
    least = roofline_xray.draws_bytes(B, 32, 2) / roofline.HBM_BYTES_PER_S
    assert abs(got["draws_roofline.xray"] - 100 * least / 1e-5) < 1e-9
    # at the cell's own widths an update is about 6.19 MFLOP a row: the
    # frozen features' encoders take no input gradient
    assert round(roofline_xray.row_flops(512, 512, 256, 2, 14) / 1e6, 2) \
        == 6.19
    empty = types.SimpleNamespace(trace=None, work={}, config=c,
                                  traffic=cell.traffic, roofline=roofline)
    assert all(spec.reader(ROOT, m)(empty) is None for m in got)
