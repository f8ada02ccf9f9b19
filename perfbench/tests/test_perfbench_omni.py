"""The omni late-fusion cell's plumbing on the CPU at small sizes: its
files through ``spec.py``, its dry run, the counts of
``roofline_omni.py`` against a hand count, and its per-layer readers."""

import time
import types

from conftest import ROOT
from perfbench import harness, roofline, roofline_omni, spec

SMALL = ({"batch": 64, "steps_per_call": 4, "warm_calls": 1},
         {"embed_dim": 32, "num_classes": 5})
READERS = ("step_mfu.omni", "stream_roofline.omni", "device_idle.omni")


def _cell():
    cell = spec.load(ROOT, "omni-e3584-train")
    cell.traffic.update(SMALL[0])
    cell.config.update(SMALL[1])
    return cell


def test_config_and_traffic_load():
    cell = spec.load(ROOT, "omni-e3584-train")
    c, t = cell.config, cell.traffic
    assert c["embed_dim"] == c["hidden_size"] == 3584
    assert (c["mm_hidden_size"], c["whisper_hidden_size"]) == (1152, 1280)
    assert c["visual_aligner_type"] == c["whisper_projector_type"] == "linear"
    assert (c["num_heads"], c["num_classes"], c["reduced"]) == (1, 527, [])
    assert t["driver"] == "train_omni"
    assert (t["batch"], t["modalities"], t["steps_per_call"]) == (4096, 3, 16)
    assert cell.chips == 1
    assert [m["name"] for m in cell.end_to_end] == ["train_samples_per_s",
                                                    "setup_s"]
    assert [m["name"] for m in cell.per_layer] == list(READERS)
    assert set(cell.limits) >= {"loss_gap", "weights_gap", "mask_share"}


def test_dry_run_reads_every_number_but_the_graphs():
    res = harness.run_cell(_cell(), 2**33 + 9, 0.5, False, time.monotonic(),
                           device="cpu")
    assert res["metrics"] == {} and res["failed"] == 0
    for k, c in res["checks"].items():
        if k in ("weights_gap", "first_weights_gap", "mask_share"):
            assert c["value"] is None  # the card's graph route only
        else:
            assert c["value"] <= c["limit"], (k, c)


def test_counts_by_hand():
    # B=2, M=3, E=4, C=5: the value and output projections 2·(2·2·4·4) =
    # 128 and the head 2·2·4·5 = 80, three times: 624; the scores and the
    # mix 2·(2·2·3·4) = 96 forward and as much backward: 192
    assert roofline_omni.update_work(2, 3, 4, 5) == 624 + 192
    # kv 2·4·(2·3·4) = 192; mix and d_mix in bf16 2·2·(2·4) = 32; w, mw,
    # ent, rate 4·(2·6 + 2·2) = 64; d_w 4·6 = 24
    assert roofline_omni.stream_bytes(2, 3, 4) == 192 + 32 + 64 + 24
    assert roofline_omni.stream_bytes(2, 3, 4, 4) == 192 + 64 + 64 + 24
    # at the cell's shapes: about 678 GFLOP and 0.41 GB an update
    assert round(roofline_omni.update_work(4096, 3, 3584, 527) / 1e9) == 678
    assert round(roofline_omni.stream_bytes(4096, 3, 3584) / 1e8) == 4


def test_readers():
    cell = _cell()
    trace = types.SimpleNamespace(
        window_s=1.0, busy_s=0.75, counted={"updates": 10},
        device_s=lambda match: 1e-4 if match("stream_bwd_kernel") else 0)
    work = {"updates": 10, "elapsed_s": 0.02}
    ctx = types.SimpleNamespace(trace=trace, work=work, config=cell.config,
                                traffic=cell.traffic, roofline=roofline)
    got = {m: spec.reader(ROOT, m)(ctx) for m in READERS}
    assert got["device_idle.omni"] == 25.0
    B, M = cell.traffic["batch"], cell.traffic["modalities"]
    flops = roofline_omni.update_work(B, M, 32, 5)
    assert abs(got["step_mfu.omni"]
               - 100 * flops / roofline.TF32_FLOPS / 2e-3) < 1e-9
    least = roofline_omni.stream_bytes(B, M, 32) / roofline.HBM_BYTES_PER_S
    assert abs(got["stream_roofline.omni"] - 100 * least / 1e-5) < 1e-9
    empty = types.SimpleNamespace(trace=None, work={}, config=cell.config,
                                  traffic=cell.traffic, roofline=roofline)
    assert all(spec.reader(ROOT, m)(empty) is None for m in READERS)
    silent = types.SimpleNamespace(
        trace=types.SimpleNamespace(counted={"updates": 10},
                                    device_s=lambda match: 0.0),
        work={}, config=cell.config, traffic=cell.traffic, roofline=roofline)
    assert spec.reader(ROOT, "stream_roofline.omni")(silent) is None
