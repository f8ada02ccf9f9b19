"""The port's utilities (``aecf_tpu_torch.utils``): trace and step timing
as ``tests/test_profiling.py`` checks JAX's, the NaN dispatch mode, and
the finiteness reports against JAX's ``aecf_tpu.utils`` on the same trees
(keys, order and maxima exactly; the finite fraction to f32 rounding, as
JAX takes an f32 mean where the port divides two counts).
"""

import glob
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from aecf_tpu import utils as jax_utils
from aecf_tpu_torch import utils
from aecf_tpu_torch.utils import (
    StepTimer,
    assert_finite,
    debug_nans,
    named_scope,
    trace,
    tree_finite_report,
)


def test_trace_writes_a_chrome_trace_with_the_scope(tmp_path):
    log_dir = str(tmp_path / "trace")
    x = torch.ones((32, 32))
    with trace(log_dir):
        with named_scope("fusion_block"):
            (x @ x.T).sum()
    files = [p for p in glob.glob(os.path.join(log_dir, "**", "*"),
                                  recursive=True) if os.path.isfile(p)]
    assert len(files) == 1 and os.path.getsize(files[0]) > 0
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "fusion_block" for e in events)


def test_step_timer():
    t = StepTimer(warmup=2)
    r = torch.ones((8,))
    for _ in range(6):
        with t.step() as s:
            r = r * 2
            s.result = r  # sync on the BODY's output, not a stale input
    assert len(t.times) == 4  # 6 - warmup 2
    assert t.mean_s > 0 and t.p50_s > 0
    assert math.isnan(StepTimer().mean_s) and math.isnan(StepTimer().p50_s)


@pytest.mark.parametrize("sync", ["fetch", "block"])
def test_step_timer_record_and_sync_modes(sync):
    t = StepTimer(warmup=0, sync=sync)
    # the first non-empty tensor leaf is the one synchronised on
    out = t.record(lambda x: {"a": torch.zeros(0), "b": [None, x + 1]},
                   torch.zeros((4,)))
    assert float(out["b"][1][0]) == 1.0
    assert len(t.times) == 1 and t.times[0] > 0


def test_step_timer_rejects_an_unknown_sync():
    with pytest.raises(ValueError, match="sync"):
        StepTimer(sync="nope")


def test_debug_nans_raises_forward_and_backward_and_passes_clean():
    x = torch.tensor([0.0, 4.0], requires_grad=True)
    with debug_nans():
        (x * 2).sum().backward()  # clean: no raise
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(torch.tensor([-1.0]))
        # sqrt'(0) = inf, times a zero gradient: NaN only in the backward
        y = (torch.sqrt(x) * torch.tensor([0.0, 1.0])).sum()
        with pytest.raises(FloatingPointError, match="NaN"):
            y.backward()
    with debug_nans(enable=False):
        assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()


class _Tally(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def test_debug_nans_restores_the_previous_mode():
    """On exit — also after a raise — the mode that was active before is
    the active one again, and NaNs pass unchecked."""
    with _Tally() as tally:
        with pytest.raises(FloatingPointError):
            with debug_nans():
                torch.log(torch.tensor([-1.0]))
        before = tally.ops
        assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()
        assert tally.ops > before  # the outer mode sees ops again
    assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()


def test_debug_nans_catches_a_nan_fed_to_a_pool_step():
    """A 'torch' pool step raises on NaN features and passes clean ones."""
    from aecf_tpu_torch.train import (
        TrainState,
        init_pool_classifier_params,
        make_pool_train_step,
        param_leaves,
    )

    params = init_pool_classifier_params(torch.Generator().manual_seed(0),
                                         16, 3, device="cpu")
    state = TrainState(params, torch.optim.SGD(param_leaves(params), lr=0.1))
    step = make_pool_train_step(impl="torch")
    kv = torch.randn((8, 2, 16), generator=torch.Generator().manual_seed(1))
    labels = (torch.rand((8, 3)) < 0.5).float()
    with debug_nans():
        state, loss, _ = step(state, kv, labels, (1, 2))
    assert math.isfinite(float(loss))
    kv[3, 1, 5] = float("nan")
    with pytest.raises(FloatingPointError, match="NaN"), debug_nans():
        step(state, kv, labels, (1, 3))


def _trees():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(4, 5)).astype(np.float32)
    b = a.copy()
    b[0, 1], b[2, 2], b[3, 0] = np.nan, np.inf, -np.inf
    c = (rng.normal(size=(3,)) * 1e3).astype(np.float32)
    return {
        "clean": {"pool": {"wq": a, "bq": c}, "query": a[:1]},
        "nested": {"pool": {"wq": b, "wk": a}, "ids": np.arange(3),
                   "seq": [c, (b[1], None)], "head": {"w": b[:2]}},
        "list": [a, b, {"z": c, "a": b}],
    }


def _to(tree, conv):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to(v, conv) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, conv) for v in tree)
    return conv(tree)


@pytest.mark.parametrize("name", ["clean", "nested", "list"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_finite_reports_equal_jax(name, dtype):
    tree = _trees()[name]

    def port(x):
        t = torch.from_numpy(np.array(x))
        return t.to(getattr(torch, dtype)) if t.is_floating_point() else t

    def theirs(x):
        a = jnp.asarray(x)
        return a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a

    ours_t, jax_t = _to(tree, port), _to(tree, theirs)
    got = tree_finite_report(ours_t)
    want = jax_utils.tree_finite_report(jax_t)
    assert list(got) == list(want)
    for k, (frac, max_abs) in want.items():
        # JAX's fraction is an f32 mean, the port's the exact count ratio
        assert got[k][0] == pytest.approx(frac, rel=2 ** -23), k
        assert got[k][1] == max_abs, k
    try:
        jax_utils.assert_finite(jax_t, name="params")
        want = None
    except FloatingPointError as e:
        want = str(e)
    if want is None:
        assert_finite(ours_t, name="params")
    else:
        with pytest.raises(FloatingPointError) as got:
            assert_finite(ours_t, name="params")
        assert str(got.value) == want


def test_utils_exports_equal_jax():
    assert sorted(utils.__all__) == sorted(jax_utils.__all__)
