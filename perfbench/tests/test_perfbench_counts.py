"""The work counts and bounds against hand-worked values, and each traffic
generator's determinism per seed."""

import math

import numpy as np
import pytest
import torch

from perfbench import models, roofline
from perfbench.drivers import serve_open


def test_north_star_step_bound():
    """B=4096, M=3, E=512, C=14 at 'default': 6.50 GFLOP on the TF32
    tensor cores and 0.168 GFLOP on the f32 pipes, 0.01564 ms."""
    work = roofline.step_work(4096, 3, 512, 14, "default")
    assert work[1] == 4 * 4096 * 512 * 14 + 8 * 4096 * 3 * 512
    assert work[2] == 6 * 4096 * 512 ** 2 + 2 * 4096 * 512 * 14
    seconds, by = roofline.bound_s(work)
    assert by == "operations"
    assert math.isclose(seconds * 1e3, 0.01564, rel_tol=1e-3)
    assert roofline.ops_s(work) == seconds


def test_highest_puts_the_products_on_the_f32_pipes():
    d = roofline.step_work(4096, 3, 512, 14, "default")
    h = roofline.step_work(4096, 3, 512, 14, "highest")
    assert h[0] == d[0] and h[2] == 0.0 and h[1] == d[1] + d[2]


def test_forward_chain_bound_at_bucket_1024():
    work = roofline.fwd_chain_work(1024, 2, 512, "highest")
    assert work[1] == 4 * 1024 * 2 * 512 + 2 * 1024 * 512 ** 2
    seconds, by = roofline.bound_s(work)
    assert by == "operations"
    assert math.isclose(seconds * 1e3, work[1] / 67e12 * 1e3)


def test_bytes_bound_when_operations_are_few():
    seconds, by = roofline.bound_s((3.35e9, 1.0, 0.0))
    assert by == "bytes" and math.isclose(seconds, 1e-3)


def test_vision_language_row_flops():
    """ResNet-50 2048 and BERT-base 768 to 512, pool, 1000 classes: 4.43
    MFLOP a row."""
    flops = roofline.vl_row_flops(2048, 768, 512, 1000)
    assert flops == 2 * (2048 + 768) * 512 + 8 * 512 + 2 * 512 ** 2 \
        + 2 * 512 * 1000
    assert math.isclose(flops / 1e6, 4.43, rel_tol=1e-2)


MIX = {"rate_per_s": 500, "rows": {"1": 64, "2": 16, "16": 1},
       "subsets": {"both": 80, "image": 10, "text": 10}, "pool_rows": 64}


def test_open_schedule_is_a_function_of_the_seed():
    a = serve_open.schedule(MIX, 2.0, 2**33 + 1)
    b = serve_open.schedule(MIX, 2.0, 2**33 + 1)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_open_schedule_seeds_share_sizes_and_gaps():
    """Every seed gets the same gaps, sizes and subsets in its own order,
    and the gaps add up to the window at the mix's rate."""
    a = serve_open.schedule(MIX, 2.0, 1)
    b = serve_open.schedule(MIX, 2.0, 2)
    assert len(a["due"]) == 1000
    np.testing.assert_allclose(np.sort(np.diff(a["due"], prepend=0)),
                               np.sort(np.diff(b["due"], prepend=0)),
                               rtol=1e-9, atol=1e-12)
    assert math.isclose(a["due"][-1], 2.0, rel_tol=0.02)
    np.testing.assert_array_equal(np.sort(a["rows"]), np.sort(b["rows"]))
    np.testing.assert_array_equal(np.sort(a["subset"]), np.sort(b["subset"]))
    assert not np.array_equal(a["rows"], b["rows"])
    assert np.all(a["start"] + a["rows"] <= MIX["pool_rows"])


def test_apportion_keeps_the_weights():
    got = serve_open.apportion({"a": 80, "b": 10, "c": 10}, 1001)
    assert len(got) == 1001
    assert abs(got.count("a") - 800.8) < 1 and abs(got.count("b") - 100.1) < 1


@pytest.mark.parametrize("make,cfg", [
    (models.pool_classifier_weights, {"embed_dim": 16, "num_classes": 3}),
    (models.vision_language_weights, {"img_dim": 12, "txt_dim": 8,
                                      "hidden_dim": 16, "num_classes": 5}),
])
def test_weights_are_a_function_of_the_seed(make, cfg):
    cpu = torch.device("cpu")
    a, b, c = make(cfg, 2**34, cpu), make(cfg, 2**34, cpu), make(cfg, 1, cpu)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fusion_query" if "fusion_query" in a
                             else "query"],
                           c["fusion_query" if "fusion_query" in c
                             else "query"])


def test_sub_seeds_differ_by_use_and_seed():
    assert models.sub_seed(5, "weights") != models.sub_seed(5, "inputs")
    assert models.sub_seed(5, "weights") != models.sub_seed(6, "weights")
    assert 0 <= models.sub_seed(2**40, "x") < 2**63
