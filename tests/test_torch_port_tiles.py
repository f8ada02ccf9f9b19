"""The port's plan table (``aecf_tpu_torch.kernels.tiles``) and launch
plans (``kernels._plan``) against the JAX package's tile table.

The site keys are held to ``aecf_tpu.kernels.tiles.site_key`` on the same
inputs; every case of ``tests/test_tiles.py`` has its counterpart for the
port's table (plan values in place of batch tiles); the precedence env >
table > default is observed through the real wrappers on CPU tensors with
recording on, one case a site and source (the plain versions ignore the
plan, so the CPU sees the resolution and not its effect).  Everything is
hermetic: each test has its own table file and no plan env.
"""

import json
import os

import jax
import pytest
import torch

from aecf_tpu.kernels import fused_fusion_pool_shared as jax_shared
from aecf_tpu.kernels import tiles as jax_tiles
from aecf_tpu.core.init import init_attention_pool_params as jax_pool_init
from aecf_tpu.core.init import init_fusion_query as jax_query_init
from aecf_tpu_torch.core.init import init_attention_pool_params
from aecf_tpu_torch.kernels import (
    fused_fusion_pool,
    quantize_features,
    shared_query_bwd,
    shared_query_fwd,
    stream_bwd,
    stream_mix,
    tiles,
    train_step,
)
from aecf_tpu_torch.kernels import _plan

B, M, E = 64, 3, 64
_ENVS = (*_plan.ENV.values(), "AECF_FWD_TB", "AECF_BWD_TB", "AECF_STEP_TB")


@pytest.fixture(autouse=True)
def _clean_table_state(monkeypatch, tmp_path):
    """Every test sees an isolated, initially-empty table file, no plan or
    tile env, and no leftover in-process table or recording."""
    monkeypatch.setenv(tiles.ENV_TABLE, str(tmp_path / "tiles.json"))
    monkeypatch.setenv("AECF_TILE_TABLE", str(tmp_path / "jax_tiles.json"))
    for name in _ENVS:
        monkeypatch.delenv(name, raising=False)
    tiles.set_table(None)
    jax_tiles.set_table(None)
    yield
    tiles.set_table(None)
    tiles.stop_recording()
    jax_tiles.set_table(None)
    jax_tiles.stop_recording()


SITES = [
    ("fwd_resident", dict(M=3, E=512, H=1, kv_dtype="float32")),
    ("fwd_resident", dict(M=4, E=512, H=8, kv_dtype="int8")),
    ("fwd_generic", dict(M=3, E=256, H=4, kv_dtype="bfloat16")),
    ("fwd_streamed", dict(M=4, E=2048, H=2, kv_dtype="float32")),
    ("bwd_resident", dict(M=3, E=512, H=1, kv_dtype="float32",
                          want_dkv=False)),
    ("bwd_streamed", dict(M=4, E=2048, H=1, kv_dtype="bfloat16",
                          want_dkv=True)),
    ("step_resident", dict(M=3, E=512, H=1, kv_dtype="int8",
                           want_dkv=False)),
]


class TestSiteKey:
    @pytest.mark.parametrize("site, kw", SITES,
                             ids=[f"{s}-{i}" for i, (s, _) in
                                  enumerate(SITES)])
    def test_matches_jax(self, site, kw):
        assert tiles.site_key(site, **kw) == jax_tiles.site_key(site, **kw)

    def test_dkv_distinguishes_backward_variants(self):
        k = dict(M=3, E=512, H=1, kv_dtype="float32")
        assert (tiles.site_key("bwd_resident", want_dkv=False, **k)
                != tiles.site_key("bwd_resident", want_dkv=True, **k))


class TestTableIO:
    def test_missing_file_is_empty_table(self):
        assert tiles.load_table() == {}
        assert tiles.lookup("anything") is None

    def test_update_then_lookup_roundtrip(self):
        key = "step_resident:M=3:E=512:H=1:kv=float32:dkv=0"
        path = tiles.update_table({key: {"g": [64, 16]}})
        assert path == os.environ[tiles.ENV_TABLE]
        assert tiles.lookup(key) == {"g": (64, 16)}
        # merge keeps existing keys; None or {} deletes
        tiles.update_table({"b": {"blocks_per_sm": 2}})
        assert tiles.lookup(key) == {"g": (64, 16)}
        tiles.update_table({key: None})
        assert tiles.lookup(key) is None
        assert tiles.lookup("b") == {"blocks_per_sm": 2}
        tiles.update_table({"b": {}})
        assert tiles.lookup("b") is None

    @pytest.mark.parametrize("value", [
        128, "128", {"g": [96, 1]}, {"g": [64, 0]}, {"g": [64]},
        {"g": [64, True]}, {"blocks_per_sm": 0}, {"blocks_per_sm": 2, "g":
                                                  [64, 1]},
    ], ids=["jax-int", "string", "bn", "splits", "pair", "bool", "grid",
            "mixed"])
    def test_update_rejects_invalid_values(self, value):
        with pytest.raises(ValueError):
            tiles.update_table({"k": value})

    def test_malformed_file_warns_and_is_ignored(self):
        with open(os.environ[tiles.ENV_TABLE], "w") as f:
            f.write("{not json")
        with pytest.warns(UserWarning, match="unreadable"):
            assert tiles.load_table() == {}

    def test_invalid_entries_dropped_with_warning(self):
        with open(os.environ[tiles.ENV_TABLE], "w") as f:
            json.dump({"good": {"out": [64, 2]},
                       "grid": {"blocks_per_sm": 3},
                       "jax_tile": 128, "tiny": {"out": [32, 1]},
                       "stringy": {"out": "64"}, "empty": {}}, f)
        with pytest.warns(UserWarning, match="dropping invalid"):
            table = tiles.load_table()
        assert table == {"good": {"out": (64, 2)},
                         "grid": {"blocks_per_sm": 3}}

    def test_non_object_file_warns(self):
        with open(os.environ[tiles.ENV_TABLE], "w") as f:
            json.dump([1, 2, 3], f)
        with pytest.warns(UserWarning, match="not a JSON object"):
            assert tiles.load_table() == {}

    def test_default_path_is_per_card(self, monkeypatch, tmp_path):
        monkeypatch.delenv(tiles.ENV_TABLE)
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
        p = tiles.table_path()
        assert p.startswith(os.path.join(str(tmp_path), "aecf_tpu_torch"))
        base = os.path.basename(p)
        assert base.startswith("tiles_") and base.endswith(".json")
        kind = base[len("tiles_"):-len(".json")]
        assert kind and all(c.isalnum() or c == "-" for c in kind)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda *a: "NVIDIA H100 80GB HBM3")
        assert os.path.basename(tiles.table_path()) == (
            "tiles_nvidia-h100-80gb-hbm3.json")

    def test_set_table_invalidates_file_cache(self):
        assert tiles.lookup("k") is None  # caches the (empty) file table
        tiles.update_table({"k": {"g": [64, 4]}})  # also invalidates
        assert tiles.lookup("k") == {"g": (64, 4)}
        tiles.set_table({"k": {"g": [128, 2]}})
        assert tiles.lookup("k") == {"g": (128, 2)}
        tiles.set_table(None)
        assert tiles.lookup("k") == {"g": (64, 4)}


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen)


def _call(site, dtype=torch.float32, precision="highest"):
    """One call of the wrapper behind ``site`` on CPU tensors (the resident
    GEMM chains at ``precision``); returns the key it must record under."""
    g = torch.Generator().manual_seed(0)
    kv = _randn(g, B, M, E)
    scales = None
    if dtype == torch.int8:
        kv, scales = quantize_features(kv)
    u, c = _randn(g, 1, E), _randn(g, 1)
    w = _randn(g, E, E) / E ** 0.5
    name = _plan.dtype_name(dtype)
    if site == "fwd_resident":
        shared_query_fwd(kv, u, c, None, w, _randn(g, E), kv_scales=scales,
                         precision=precision)
        return tiles.site_key(site, M=M, E=E, H=1, kv_dtype=name)
    if site == "fwd_generic":
        params = init_attention_pool_params(g, E)
        fused_fusion_pool(params, _randn(g, B, 1, E), kv, num_heads=2)
        return tiles.site_key(site, M=M, E=E, H=2, kv_dtype=name)
    if site == "fwd_streamed":
        stream_mix(kv, u, c, None, kv_scales=scales)
        return tiles.site_key(site, M=M, E=E, H=1, kv_dtype=name)
    if site == "bwd_resident":
        shared_query_bwd(kv, u[0], c, None, _randn(g, B, E), None, w,
                         want_dkv=False, kv_scales=scales,
                         precision=precision)
        return tiles.site_key(site, M=M, E=E, H=1, kv_dtype=name,
                              want_dkv=False)
    if site == "bwd_streamed":
        stream_bwd(kv, _randn(g, B, E), None, None, u, c, want_dkv=False,
                   kv_scales=scales)
        # every dtype resolves from the f32 call's key
        return tiles.site_key(site, M=M, E=E, H=1, kv_dtype="float32",
                              want_dkv=False)
    assert site == "step_resident"
    train_step(kv, u[0], c, None, w, _randn(g, E), inv=1.0 / (B * E),
               want_dkv=False, training=False, kv_scales=scales,
               precision=precision)
    return tiles.site_key(site, M=M, E=E, H=1, kv_dtype=name, want_dkv=False)


def _defaults(site):
    """The default plan of the site at (B, M, E) on a CPU tensor."""
    chain = {
        "fwd_resident": _plan.sq_fwd_products(B, E, 1),
        "fwd_generic": _plan.fused_fwd_products(B, E, 2, B),
        "bwd_resident": _plan.sq_bwd_products(B, E),
        "step_resident": _plan.step_products(B, E, 0),
    }.get(site)
    if chain is None:
        return {tiles.GRID: 0}
    return {q.name: _plan.gemm_plan(q, _plan.H100_SXM_SMS) for q in chain}


# site: (a table entry, an env value) each site's products can take
PLANS = {
    "fwd_resident": ({"out": [64, 2]}, {"out": [64, 1]}),
    "fwd_generic": ({"u": [128, 1]}, {"ctx": [64, 2], "qp": [64, 2]}),
    "fwd_streamed": ({"blocks_per_sm": 2}, {"blocks_per_sm": 1}),
    "bwd_resident": ({"d_mix": [128, 1]}, {"g": [64, 2]}),
    "bwd_streamed": ({"blocks_per_sm": 3}, {"blocks_per_sm": 1}),
    "step_resident": ({"g": [128, 2]}, {"d_mix": [128, 2]}),
}


class TestPickPlanPrecedence:
    """env > table > default, observed through each real launch site via
    the recording hook."""

    def _trace(self, site, dtype=torch.float32):
        tiles.start_recording()
        key = _call(site, dtype)
        log = tiles.stop_recording()
        assert {k for k, _, _ in log} == {key}, log
        return key, log[-1][1:]

    @pytest.mark.parametrize("site", sorted(PLANS))
    def test_default_recorded(self, site):
        _, (plan, source) = self._trace(site)
        assert (plan, source) == (_defaults(site), "default")

    @pytest.mark.parametrize("site", sorted(PLANS))
    def test_table_overrides_default(self, site):
        key = _call(site)
        entry = PLANS[site][0]
        tiles.update_table({key: entry})
        _, (plan, source) = self._trace(site)
        assert source == "table"
        assert plan == {**_defaults(site), **tiles.check_value(entry)}

    @pytest.mark.parametrize("site", sorted(PLANS))
    def test_env_overrides_table(self, site, monkeypatch):
        key = _call(site)
        entry, env = PLANS[site]
        tiles.set_table({key: entry})
        monkeypatch.setenv(_plan.ENV[site.split("_")[0]], json.dumps(env))
        _, (plan, source) = self._trace(site)
        assert source == "env"
        assert plan == {**_defaults(site), **tiles.check_value(entry),
                        **tiles.check_value(env)}

    @pytest.mark.parametrize("site", ["fwd_resident", "bwd_resident",
                                      "step_resident"])
    def test_same_plan_at_both_precisions(self, site):
        """The TF32 instance runs the SIMT instance's plan set: a GEMM
        chain resolves and records the same key and plan (a table entry
        over the defaults) at 'default' as at 'highest'."""
        key = _call(site)
        tiles.set_table({key: PLANS[site][0]})
        seen = {}
        for precision in ("highest", "default"):
            tiles.start_recording()
            got = _call(site, precision=precision)
            seen[precision] = (got, tiles.stop_recording())
        assert seen["highest"] == seen["default"]
        (k, plan, source), = seen["default"][1]
        assert (k, source) == (key, "table")
        assert plan == {**_defaults(site), **tiles.check_value(PLANS[site][0])}

    @pytest.mark.parametrize("site", ["fwd_resident", "bwd_streamed",
                                      "step_resident"])
    def test_int8_key(self, site):
        """int8 resident sites key by their dtype; the streamed backward
        resolves from the f32 key (its grid orders the batch sums)."""
        key, _ = self._trace(site, torch.int8)
        assert key.split(":")[4] == ("kv=float32" if site == "bwd_streamed"
                                     else "kv=int8")

    def test_plan_a_product_cannot_take_raises(self):
        key = _call("fwd_resident")
        tiles.set_table({key: {"out": [128, 1]}})  # n-major W: 64 only
        with pytest.raises(ValueError, match="cannot take bn=128"):
            _call("fwd_resident")
        key = _call("step_resident")
        tiles.set_table({key: {"out": [64, 2]}})  # the quadratic loss
        with pytest.raises(ValueError, match="splits=2"):
            _call("step_resident")

    @pytest.mark.parametrize("raw, match", [
        ("{not json", "AECF_TORCH_FWD_PLAN"),
        ("128", "not a non-empty JSON object"),
        ('{"d_mix": [64, 1]}', "no fwd site has products"),
    ], ids=["json", "jax-int", "product"])
    def test_malformed_env_raises(self, raw, match, monkeypatch):
        monkeypatch.setenv("AECF_TORCH_FWD_PLAN", raw)
        with pytest.raises(ValueError, match=match):
            _call("fwd_resident")

    def test_recording_off_is_noop(self):
        _call("step_resident")
        assert tiles.stop_recording() == []


class TestEnvNamesDoNotCross:
    def test_jax_knobs_do_not_reach_the_port(self, monkeypatch, tmp_path):
        monkeypatch.setenv("AECF_FWD_TB", "16")
        monkeypatch.setenv("AECF_STEP_TB", "16")
        monkeypatch.setenv("AECF_TILE_TABLE", str(tmp_path / "elsewhere"))
        assert tiles.table_path() == os.environ[tiles.ENV_TABLE]
        for site in ("fwd_resident", "step_resident"):
            tiles.start_recording()
            _call(site)
            assert tiles.stop_recording()[0][2] == "default"

    def test_port_knobs_do_not_reach_jax(self, monkeypatch, tmp_path):
        monkeypatch.setenv("AECF_TORCH_FWD_PLAN", '{"out": [64, 2]}')
        monkeypatch.setenv(tiles.ENV_TABLE, str(tmp_path / "elsewhere"))
        assert jax_tiles.table_path() == os.environ["AECF_TILE_TABLE"]
        params = jax_pool_init(jax.random.key(0), 64)
        query = jax_query_init(jax.random.key(1), 64)
        kv = jax.random.normal(jax.random.key(2), (16, 3, 64))
        jax_tiles.start_recording()
        jax_shared(params, query, kv, training=False, interpret=True)
        assert jax_tiles.stop_recording() == [
            ("fwd_resident:M=3:E=64:H=1:kv=float32", 16, "default")]


class TestPlans:
    def test_north_star_defaults(self):
        """The step's default plan at B=4096, M=3, E=512 on the H100 SXM:
        out and d_mix 64-column tiles unsplit, G split 8 ways; 114 SMs
        (the H100 PCIe) split G 7 ways."""
        q = _plan.step_products(4096, 512, 0)
        assert [_plan.gemm_plan(p, 132) for p in q] == [(64, 1), (64, 1),
                                                        (64, 8)]
        assert _plan.gemm_plan(q[2], 114) == (64, 7)

    def test_candidates(self):
        out, d_mix, g = _plan.step_products(4096, 512, 0)
        assert _plan.candidates(out, 64, 1) == [(64, 1)]
        assert _plan.candidates(d_mix, 64, 1) == [
            (64, 1), (64, 2), (64, 4), (128, 1), (128, 2), (128, 4)]
        cands = _plan.candidates(g, 64, 8)
        assert {s for _, s in cands} == {1, 4, 8, 16, 32}
        assert {b for b, _ in cands} == {64, 128}
        for p in (out, d_mix, g):
            for bn, s in _plan.candidates(p, *_plan.gemm_plan(p, 132)):
                assert _plan.plan_of(p, bn, s)[:2] == (bn, s)

    @pytest.mark.parametrize("splits, runs", [(3, 3), (5, 4), (16, 16)])
    def test_splits_round_to_k_stages(self, splits, runs):
        """k_per_split rounds up to the 32-deep stage, as the C plan does:
        K = 512 in 5 asked splits runs 4 of 128."""
        q = _plan.sq_bwd_products(4096, 512)[0]
        assert _plan.plan_of(q, 64, splits)[1] == runs
