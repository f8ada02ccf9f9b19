"""The port's data layer against the JAX package's on the same numpy
inputs: ``BatchLoader`` (numpy and native backends), ``quantize_rows``
and the pathology report miner.

Tolerances: none — every comparison is exact.  The loader gathers the
same rows in the same order from the same seed (the native backends run
the same C++ source, the port's own copy); ``quantize_rows`` and the miner
are the same numpy and ``re`` code.  The native cases skip where ``g++``
cannot build the batcher.
"""

import numpy as np
import pytest

from aecf_tpu.data import loader as jax_loader
from aecf_tpu.data import pathology as jax_path
from aecf_tpu_torch import data as port_data
from aecf_tpu_torch.data import loader as port_loader
from aecf_tpu_torch.data import pathology as port_path


def _native_or_skip():
    if not (port_loader.native_available()
            and jax_loader.native_available()):
        pytest.skip("g++ cannot build the native batcher here")


def _x3(n=100, d=8, c=3, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "image": rng.normal(size=(n, d)).astype(np.float32),
        "text": rng.normal(size=(n, d)).astype(np.float32),
        "label": (rng.random((n, c)) < 0.3).astype(np.float32),
    }


def _mixed(n=56):
    """Mixed dtypes: int8 store, f32 scales, bf16 table (where ml_dtypes
    is installed), f64 labels (downcast), an int32 row index."""
    rng = np.random.default_rng(1)
    q = rng.integers(-127, 128, size=(n, 6)).astype(np.int8)
    data = {"q": q, "scale": rng.random((n, 1)).astype(np.float32) + 0.5}
    try:
        import ml_dtypes

        data["bf"] = rng.normal(size=(n, 3)).astype(ml_dtypes.bfloat16)
    except ImportError:
        pass
    data["label"] = rng.random((n, 2))
    data["row"] = np.arange(n, dtype=np.int32)[:, None]
    return data


def _scrambled():
    """The canonical key set in another insertion order."""
    d = _x3(n=40, seed=2)
    return {"label": d["label"], "text": d["text"], "image": d["image"]}


CASES = {
    "x3-2-epochs": (_x3, dict(batch_size=32, epochs=2, seed=7)),
    "keep-last": (_x3, dict(batch_size=24, drop_last=False, seed=3)),
    "no-shuffle": (_x3, dict(batch_size=16, shuffle=False)),
    "mixed-dtypes": (_mixed, dict(batch_size=16, epochs=3, seed=5)),
    "canonical-order": (_scrambled, dict(batch_size=8, seed=1)),
}


@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_loader_batches_equal_jax(case, backend):
    """Batch for batch, the port's loader yields JAX's tuples: the same
    stream order, dtypes, shapes and rows, and the same length."""
    if backend == "native":
        _native_or_skip()
    make, kw = CASES[case]
    data = make()
    ours = port_loader.BatchLoader(data, backend=backend, **kw)
    theirs = jax_loader.BatchLoader(data, backend=backend, **kw)
    assert ours.stream_names == theirs.stream_names
    assert len(ours) == len(theirs)
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) == len(ours)
    for a, b in zip(got, want):
        assert len(a) == len(b) == len(ours.stream_names)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_loader_streams_track_one_row_and_cover_each_epoch(backend):
    """Every stream of a batch comes from the same source rows, and each
    epoch yields every row once."""
    if backend == "native":
        _native_or_skip()
    data = _mixed(n=64)
    names = list(data)
    loader = port_loader.BatchLoader(data, batch_size=16, epochs=2,
                                     backend=backend, seed=4)
    rows = []
    for batch in loader:
        idx = batch[names.index("row")][:, 0]
        for name, arr in zip(names, batch):
            want = data[name][idx]
            if want.dtype == np.float64:
                want = want.astype(np.float32)
            np.testing.assert_array_equal(arr.view(np.uint8),
                                          want.view(np.uint8))
        rows.append(idx)
    for epoch in (rows[:4], rows[4:]):
        assert sorted(np.concatenate(epoch).tolist()) == list(range(64))


@pytest.mark.parametrize("bad, match", [
    ({}, "at least one stream"),
    ({"image": np.zeros((8, 2)), "text": np.zeros((6, 2))}, "row mismatch"),
    ({"image": np.zeros((8, 2)), "label": np.zeros(8)}, "must be 2-D"),
], ids=["empty", "rows", "1-d"])
def test_loader_validation_equals_jax(bad, match):
    for module in (port_loader, jax_loader):
        with pytest.raises(ValueError, match=match):
            module.BatchLoader(bad, batch_size=4)


def test_loader_rejects_an_unknown_backend():
    for module in (port_loader, jax_loader):
        with pytest.raises(ValueError, match="backend"):
            module.BatchLoader(_x3(), batch_size=4, backend="natve")


def test_native_library_builds_under_the_build_root():
    """The port builds its own copy of the batcher into the git-ignored
    ``build/aecf_tpu_torch/<hash>/``, never beside its source, and the
    copy speaks ABI v2."""
    _native_or_skip()
    from aecf_tpu_torch.kernels import _build

    path = port_loader.build_native()
    assert path is not None
    assert str(_build._BUILD_ROOT) in path and path.endswith(
        "libaecf_batcher.so")
    assert port_loader._SRC.parent.name == "native"
    assert not list(port_loader._SRC.parent.glob("*.so"))
    assert port_loader._load_lib().aecf_batcher_abi() == 2


def test_native_copy_out_false_yields_views_into_the_ring():
    _native_or_skip()
    data = _x3(n=64)
    it = iter(port_loader.BatchLoader(data, batch_size=16, copy_out=False,
                                      backend="native"))
    img, txt, _ = next(it)
    assert img.base is not None and not img.flags.owndata
    it.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_rows_equals_jax(seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(33, 17)) * (seed + 1) * 3.0
    table[5] = 0.0  # an all-zero row keeps scale 1
    q, s = port_loader.quantize_rows(table)
    qj, sj = jax_loader.quantize_rows(table)
    assert q.dtype == qj.dtype == np.int8 and s.shape == sj.shape == (33, 1)
    np.testing.assert_array_equal(q, qj)
    np.testing.assert_array_equal(s, sj)


REPORTS = [
    "there is a large pleural effusion on the left",
    "no effusion is seen",
    "Large EFFUSION noted",
    "cardiomegalyish silhouette",
    "effusion is present; no pneumothorax",
    "no " + "x" * 60 + " effusion present",
    "no effusion on the right. there is a left effusion.",
    "no effusion on the right side was identified previously. "
    "however today there is a moderate left-sided effusion.",
    "effusion. " + "y" * 120 + " no effusion. then effusion again",
    "mild cardiomegaly, not edema; pneumonia unlikely. atelectasis",
    "",
] + [
    f"the lungs are {cue} pneumothorax today; effusion {cue} edema"
    for cue in ("no", "not", "absence of", "without", "rule out",
                "ruled out", "denies", "negative for", "free of",
                "clear of", "unlikely", "exclude", "excluded", "normal")
]
PATHOLOGIES = ["effusion", "pneumothorax", "edema", "cardiomegaly",
               "pneumonia", "atelectasis"]


@pytest.mark.parametrize("text", REPORTS)
def test_pathology_presence_equals_jax(text):
    for p in PATHOLOGIES:
        assert (port_path.check_pathology_presence(text, p)
                == jax_path.check_pathology_presence(text, p)), p


def test_every_negation_cue_negates():
    assert port_path.NEGATION_PATTERNS == jax_path.NEGATION_PATTERNS
    assert len(port_path.NEGATION_PATTERNS) == 14
    for text in REPORTS[-14:]:
        assert not port_path.check_pathology_presence(text, "pneumothorax")


def test_find_single_pathology_cases_equals_jax(tmp_path):
    """Records as dicts and as a DataFrame (the parquet loader's)."""
    records = [
        {"findings": f, "impression": i, "image": bytes([n])}
        for n, (f, i) in enumerate(zip(REPORTS, reversed(REPORTS)))
    ]
    want = jax_path.find_single_pathology_cases(records, PATHOLOGIES)
    assert port_path.find_single_pathology_cases(records, PATHOLOGIES) == want
    assert sum(len(v) for v in want.values()) > 0
    pd = pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    path = str(tmp_path / "xray.parquet")
    pd.DataFrame(records).to_parquet(path)
    frame = port_path.load_xray_parquet(path)
    assert frame.equals(jax_path.load_xray_parquet(path))
    assert (port_path.find_single_pathology_cases(frame, PATHOLOGIES)
            == jax_path.find_single_pathology_cases(frame, PATHOLOGIES))


def test_data_exports_equal_jax():
    import aecf_tpu.data as jax_data

    assert sorted(port_data.__all__) == sorted(jax_data.__all__)
    assert len(port_data.__all__) == 10
