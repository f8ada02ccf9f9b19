"""The port's plan tuner (``aecf_tpu_torch.tune``) against the JAX
package's ``aecf_tpu.tune``.

The framework-free pieces are the JAX package's copied: ``pick_winner``
and ``_sites_for`` are held to JAX's on the same inputs.  The tool itself
runs on the CPU (``--device cpu``: the kernels' plain versions, which take
no plan — the flow, not a card) at B=64, M=3, E=32: its JSON has JAX's
keys, ``--dry-run`` writes nothing, and ``--out`` writes a table that
``load_table`` reads back.
"""

import json
import os
import subprocess
import sys

import pytest

from aecf_tpu import tune as jax_tune
from aecf_tpu_torch import tune
from aecf_tpu_torch.kernels import tiles

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
KEYS = {"config", "tunnel_rtt_ms", "sites", "sweeps", "new_entries",
        "table_path"}
SMALL = ["--device", "cpu", "--batch", "64", "--modalities", "3",
         "--embed", "32", "--steps", "2", "--max-steps", "4", "--rounds",
         "3"]


@pytest.fixture(autouse=True)
def _clean_table_state(monkeypatch, tmp_path):
    monkeypatch.setenv(tiles.ENV_TABLE, str(tmp_path / "tiles.json"))
    for name in ("AECF_TORCH_FWD_PLAN", "AECF_TORCH_BWD_PLAN",
                 "AECF_TORCH_STEP_PLAN"):
        monkeypatch.delenv(name, raising=False)
    tiles.set_table(None)
    yield
    tiles.set_table(None)
    tiles.stop_recording()


PICKS = [
    ({256: 100.0, 512: 102.0}, 256, 0.03, None),  # within noise
    ({256: 100.0, 512: 110.0}, 256, 0.03, None),  # beats the margin
    ({256: 100.0, 512: 110.0}, 256, 0.03,
     {256: [99, 101, 100, 100, 98], 512: [111, 100, 112, 109, 110]}),
    ({256: 100.0, 512: 110.0}, 256, 0.03,  # one outlier round
     {256: [100, 100, 100, 100, 100], 512: [200, 99, 110, 98, 97]}),
    ({256: 100.0, 512: 110.0}, 256, 0.03,  # a tie is no majority
     {256: [100, 100, 100, 100], 512: [111, 99, 112, 98]}),
    ({(64, 8): 100.0, (128, 16): 104.0, (64, 16): 99.0}, (64, 8), 0.03,
     {(64, 8): [100, 100, 100], (128, 16): [104, 104, 99],
      (64, 16): [99, 99, 99]}),  # plan labels
]


@pytest.mark.parametrize("medians, default, margin, rounds", PICKS,
                         ids=["noise", "margin", "majority", "outlier",
                              "tie", "plans"])
def test_pick_winner_matches_jax(medians, default, margin, rounds):
    assert (tune.pick_winner(medians, default, margin, rounds)
            == jax_tune.pick_winner(medians, default, margin, rounds))


def test_pick_winner_failed_default_and_empty():
    for mod in (tune, jax_tune):
        with pytest.warns(UserWarning, match="failed to measure"):
            assert mod.pick_winner({512: 90.0}, 256, 0.03) == 256
        with pytest.raises(ValueError):
            mod.pick_winner({}, 256, 0.03)


def test_sites_partition_matches_jax():
    log = [
        ("fwd_resident:M=3:E=512:H=1:kv=float32", {"out": (64, 1)},
         "default"),
        ("bwd_resident:M=3:E=512:H=1:kv=float32:dkv=0",
         {"d_mix": (64, 1), "g": (64, 8)}, "table"),
        ("step_resident:M=3:E=512:H=1:kv=float32:dkv=0", {"g": (64, 8)},
         "env"),
        ("fwd_resident:M=3:E=512:H=1:kv=float32", {"out": (64, 2)},
         "default"),
    ]
    for prefix in ("fwd_", "bwd_", "step_"):
        assert tune._sites_for(log, prefix) == jax_tune._sites_for(log,
                                                                   prefix)
    assert tune._sites_for(log, "fwd_") == {
        "fwd_resident:M=3:E=512:H=1:kv=float32": {"out": (64, 2)}}


def test_public_names_match_jax():
    from aecf_tpu.kernels import tiles as jax_tiles

    assert set(tune.__all__) == set(jax_tune.__all__)
    assert set(jax_tiles.__all__) <= set(tiles.__all__)
    from aecf_tpu_torch.kernels import _plan

    q = _plan.step_products(4096, 512, 0)[2]
    assert tune.candidate_tiles(q, 64, 8) == _plan.candidates(q, 64, 8)


def _run(args):
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "aecf_tpu_torch.tune",
                           *args], capture_output=True, text=True,
                          timeout=300, cwd=ROOT, env=env)


def test_module_entrypoint_help():
    proc = _run(["--help"])
    assert proc.returncode == 0, proc.stderr
    for flag in ("--margin", "--dry-run", "--device", "fused-step",
                 "kernel"):
        assert flag in proc.stdout


def test_dry_run_on_cpu_writes_nothing():
    proc = _run([*SMALL, "--dry-run"])
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    assert set(out) == KEYS
    assert out["table_path"] is None
    assert not os.path.exists(os.environ[tiles.ENV_TABLE])
    assert "card=none (cpu)" in out["config"]
    assert set(out["sites"]) == {
        "fwd_resident:M=3:E=32:H=1:kv=float32",
        "bwd_resident:M=3:E=32:H=1:kv=float32:dkv=0"}
    # G = d_out^T mix over the batch is the one product with a choice here
    rec = out["sweeps"]["bwd_resident:M=3:E=32:H=1:kv=float32:dkv=0/g"]
    assert rec["candidates"] == [[64, 1], [64, 2]]
    assert rec["failed"] == []
    assert len(rec["median_sps"]) == 2


@pytest.mark.parametrize("impl", ["kernel", "fused-step"])
def test_out_writes_a_table_load_table_reads(impl, tmp_path, monkeypatch,
                                             capsys):
    """With a winner forced (the CPU's timings decide nothing), ``--out``
    writes it under the recorded key, and the table reads back."""
    monkeypatch.setattr(tune, "pick_winner",
                        lambda medians, default, *a: max(medians))
    path = str(tmp_path / "tuned.json")
    tune.main([*SMALL, "--impl", impl, "--out", path])
    out = json.loads(capsys.readouterr().out)
    assert set(out) == KEYS and out["table_path"] == path
    assert out["new_entries"]
    table = tiles.load_table(path)
    assert table == {k: tiles.check_value(v)
                     for k, v in out["new_entries"].items()}
    site = ("step_resident" if impl == "fused-step" else "bwd_resident")
    assert list(table) == [f"{site}:M=3:E=32:H=1:kv=float32:dkv=0"]
    assert table[list(table)[0]]["g"] == (64, 2)
    # a run that installs the table takes the tuned plan from it
    tiles.start_recording()
    assert tune._build(_Args(impl), table) is not None
    log = tiles.stop_recording()
    assert {(k, src) for k, _, src in log if k.startswith(site)} == {
        (list(table)[0], "table")}


class _Args:
    """``tune``'s arguments for one chunk at the small config."""

    def __init__(self, impl):
        self.batch, self.modalities, self.embed, self.heads = 64, 3, 32, 1
        self.impl, self.steps, self.kv_grad = impl, 1, False
        self.features_dtype, self.device = "float32", "cpu"
