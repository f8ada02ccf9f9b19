"""The port's model families against the JAX package's.

Each model is built at small widths on both sides; the JAX parameters are
flattened with ``keystr`` and loaded into the port's module through
``convert.params_from_numpy`` (``strict=True``), and the same numpy inputs
go through both.  The fusion pool runs JAX's XLA path and the port's torch
path (``'auto'`` on the CPU) or, forced (each model module's
``fusion_pool`` swapped for ``ops.fusion_pool(implementation='kernel')``),
the port's kernels' plain versions.  Draws follow ``docs/prng.md``: dropout and the missing-modality
draws are injected (the same masks on both sides), and the simulation's
missing rate and coin-flip rescue are held to their distribution.

Tolerances: logits and pooled outputs 2e-5 of their largest entry plus
1e-6, weights and entropy 1e-5 (f32 sums in other orders); an absent
medical slot's weight 1e-6 (``tests/test_models.py``'s); gradients with
and without ``use_checkpoint`` equal exactly (the same computation run
twice).
"""

import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aecf_tpu.models.layers as jax_layers
import aecf_tpu.models.xray as jax_xray
from aecf_tpu.models import MedicalDiagnosisModel as JaxMedical
from aecf_tpu.models import MultiScaleFusion as JaxMultiScale
from aecf_tpu.models import VisionLanguageModel as JaxVLM
from aecf_tpu.models import XrayAECFModel as JaxXray
from aecf_tpu.models import XrayBaselineModel as JaxBaseline
import aecf_tpu_torch.models.layers as port_layers
import aecf_tpu_torch.models.medical as port_medical
import aecf_tpu_torch.models.multiscale as port_multiscale
import aecf_tpu_torch.models.vision_language as port_vl
import aecf_tpu_torch.models.xray as port_xray
import aecf_tpu_torch.ops as ops
from aecf_tpu_torch import CurriculumMasking, MultimodalAttentionPool
from aecf_tpu_torch.convert import _dotted, params_from_numpy
from aecf_tpu_torch.models import (
    MedicalDiagnosisModel,
    MultiScaleFusion,
    VisionLanguageModel,
    XrayAECFModel,
    XrayBaselineModel,
    fork_generator,
)

W_TOL = 1e-5
OUT_REL = 2e-5
MED = dict(image_dim=32, lab_dim=8, clinical_dim=16, hidden_dim=64,
           num_classes=5)
XRAY = dict(image_dim=24, text_dim=16, hidden_dim=32, num_classes=6)


def _flat(params):
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _pair(jax_cls, port_cls, seed=0, **cfg):
    jm = jax_cls(**cfg)
    jp = jm.init(jax.random.key(seed))
    tm = port_cls(**cfg, device="cpu")
    return jm, jp, params_from_numpy(tm, _flat(jp))


def _force_pool(monkeypatch, impl):
    """Every model's pool as ``ops.fusion_pool(..., implementation=impl)``
    (``'kernel'``: the kernels' plain versions on the CPU); ``'auto'``
    leaves the models as they are."""
    if impl == "auto":
        return

    def forced(*args, **kwargs):
        return ops.fusion_pool(*args, implementation=impl, **kwargs)

    for module in (port_medical, port_multiscale, port_vl, port_xray):
        monkeypatch.setattr(module, "fusion_pool", forced)


def _close(got, want, atol=W_TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=atol)


def _close_out(got, want):
    want = np.asarray(want)
    _close(got, want, OUT_REL * float(np.abs(want).max()) + 1e-6)


def _feats(rng, B, *dims):
    return [rng.standard_normal((B, d)).astype(np.float32) for d in dims]


# ---- convert ----------------------------------------------------------------


def test_convert_maps_list_indices():
    assert _dotted(".queries[0]") == "queries.0"
    assert _dotted(".pools[1].in_proj_weight") == "pools.1.in_proj_weight"
    assert _dotted("['pool'].in_proj_weight") == "pool.in_proj_weight"
    assert _dotted("pools.1.in_proj_weight") == "pools.1.in_proj_weight"
    jm, jp, tm = _pair(JaxMultiScale, MultiScaleFusion, dims=(16, 32))
    assert set(tm.state_dict()) == {_dotted(k) for k in _flat(jp)}
    np.testing.assert_array_equal(tm.pools[1].in_proj_weight.detach().numpy(),
                                  np.asarray(jp.pools[1].in_proj_weight))
    bad = dict(_flat(jp))
    bad.pop(".queries[1]")
    with pytest.raises(RuntimeError, match="queries.1"):
        params_from_numpy(MultiScaleFusion(dims=(16, 32), device="cpu"), bad)


@pytest.mark.parametrize("cls", [MedicalDiagnosisModel, MultiScaleFusion,
                                 XrayAECFModel, XrayBaselineModel,
                                 VisionLanguageModel])
def test_models_default_to_the_card(cls):
    assert inspect.signature(cls).parameters["device"].default == "cuda"


# ---- the medical model ------------------------------------------------------


@pytest.mark.parametrize("impl", ["auto", "kernel"])
@pytest.mark.parametrize("absent", [(), ("lab",), ("lab", "clinical")])
def test_medical_eval_matches_jax(monkeypatch, absent, impl):
    """Logits and info with none, one and two modalities absent; an absent
    slot gets zero weight.  ``'kernel'`` runs the resident forward's plain
    version at H=8 (``'auto'`` the torch path)."""
    _force_pool(monkeypatch, impl)
    jm, jp, tm = _pair(JaxMedical, MedicalDiagnosisModel, **MED)
    feats = dict(zip(("image", "lab", "clinical"),
                     _feats(np.random.default_rng(len(absent)), 7, 32, 8, 16)))
    for k in absent:
        feats[k] = None
    j_logits, j_info = jm.apply(jp, **{k: _j(v) for k, v in feats.items()},
                                return_info=True)
    with torch.no_grad():
        logits, info = tm.eval()(**{k: _t(v) for k, v in feats.items()},
                                 return_info=True)
    _close_out(logits, j_logits)
    assert set(info) == set(j_info)
    for k in ("attention_weights", "entropy", "mask_rate"):
        _close(info[k], j_info[k])
    for slot in absent:
        idx = ("image", "lab", "clinical").index(slot)
        _close(info["attention_weights"][:, :, idx], 0.0, atol=1e-6)
    _close(info["attention_weights"].sum(-1), 1.0)


def test_medical_needs_a_modality_and_masks_whenever_training():
    _, _, tm = _pair(JaxMedical, MedicalDiagnosisModel, **MED)
    with pytest.raises(ValueError, match="At least one"):
        tm()
    x = torch.zeros(2, 32)
    with pytest.raises(ValueError, match="Generator"):
        tm.train()(image=x)  # the curriculum mask needs a generator
    _, info = tm.train()(image=torch.randn(4, 32), lab=torch.randn(4, 8),
                         generator=torch.Generator().manual_seed(0),
                         return_info=True)
    assert "target_entropy" in info


class _Injected:
    """The same dropout masks on both sides, in call order (``docs/prng.md``
    injection): the JAX and the port ``dropout`` replaced by one that
    draws its keep-mask from a numpy stream."""

    def __init__(self, seed):
        self.seed = seed

    def jax(self):
        rng = np.random.default_rng(self.seed)

        def drop(x, rate, key, training):
            if not training or rate <= 0.0 or key is None:
                return x
            keep = rng.random(x.shape) >= rate
            return jnp.where(keep, x / (1.0 - rate), 0.0)
        return drop

    def port(self):
        rng = np.random.default_rng(self.seed)

        def drop(x, rate, generator, training):
            if not training or rate <= 0.0 or generator is None:
                return x
            keep = torch.from_numpy(rng.random(tuple(x.shape)) >= rate)
            return torch.where(keep, x / (1.0 - rate), 0.0)
        return drop


@pytest.mark.parametrize("impl", ["auto", "kernel"])
def test_medical_training_with_injected_dropout_matches_jax(monkeypatch, impl):
    """Training with the encoders' dropout injected: logits, weights and
    entropy equal JAX's (the curriculum mask does not enter them, quirk
    Q1); the mask rate is live."""
    _force_pool(monkeypatch, impl)
    jm, jp, tm = _pair(JaxMedical, MedicalDiagnosisModel, **MED)
    inj = _Injected(3)
    monkeypatch.setattr(jax_layers, "dropout", inj.jax())
    monkeypatch.setattr(port_layers, "dropout", inj.port())
    feats = _feats(np.random.default_rng(4), 9, 32, 8, 16)
    j_logits, j_info = jm.apply(jp, *map(_j, feats), training=True,
                                rng=jax.random.key(5), return_info=True)
    logits, info = tm.train()(*map(_t, feats),
                              generator=torch.Generator().manual_seed(5),
                              return_info=True)
    _close_out(logits, j_logits)
    _close(info["attention_weights"], j_info["attention_weights"])
    _close(info["entropy"], j_info["entropy"])
    assert set(info) == set(j_info)
    assert float(info["mask_rate"].max()) > 0.0


# ---- the X-ray models -------------------------------------------------------


def _xray_feats(seed, B=12):
    img, txt = _feats(np.random.default_rng(seed), B, 24, 16)
    img[1::4] = 0.0  # rows without an image, rows without text, and one
    txt[2::5] = 0.0  # without either
    img[7], txt[7] = 0.0, 0.0
    return img, txt


@pytest.mark.parametrize("impl", ["auto", "kernel"])
@pytest.mark.parametrize("curriculum", [False, True])
def test_xray_aecf_eval_matches_jax(monkeypatch, curriculum, impl):
    """Logits and info, rows with one, both or no modality present
    (dense ``torch.where`` routing), the curriculum flag on and off."""
    _force_pool(monkeypatch, impl)
    jm, jp, tm = _pair(JaxXray, XrayAECFModel, **XRAY)
    img, txt = _xray_feats(6)
    j_logits, j_info = jm.apply(jp, _j(img), _j(txt),
                                curriculum_enabled=curriculum,
                                return_info=True)
    with torch.no_grad():
        logits, info = tm.eval()(_t(img), _t(txt),
                                 curriculum_enabled=curriculum,
                                 return_info=True)
    _close_out(logits, j_logits)
    assert set(info) == set(j_info)
    np.testing.assert_array_equal(info["fusion_row_mask"].numpy(),
                                  np.asarray(j_info["fusion_row_mask"]))
    _close(info["attention_weights"], j_info["attention_weights"])
    if curriculum:
        _close(info["entropy"], j_info["entropy"])


def test_xray_baseline_eval_matches_jax():
    jm, jp, tm = _pair(JaxBaseline, XrayBaselineModel, **XRAY)
    img, txt = _xray_feats(7)
    with torch.no_grad():
        logits = tm.eval()(_t(img), _t(txt))
    _close_out(logits, jm.apply(jp, _j(img), _j(txt)))


def test_xray_training_with_injected_draws_matches_jax(monkeypatch):
    """Training with ``missing_modality_training`` and the curriculum on:
    the missing-modality draws and every dropout injected (the same masks
    on both sides) give JAX's logits, weights and entropy."""
    jm, jp, tm = _pair(JaxXray, XrayAECFModel, **XRAY)
    inj = _Injected(8)
    monkeypatch.setattr(jax_layers, "dropout", inj.jax())
    monkeypatch.setattr(jax_xray, "dropout", inj.jax())
    monkeypatch.setattr(port_layers, "dropout", inj.port())
    monkeypatch.setattr(port_xray, "dropout", inj.port())
    img, txt = _xray_feats(9, B=16)
    drop = np.random.default_rng(10).random((2, 16)) < 0.3
    drop[1] &= ~drop[0]  # never both, as the simulation's rescue

    def jax_sim(self, key, image, text):
        return (jnp.where(drop[0][:, None], 0.0, image),
                jnp.where(drop[1][:, None], 0.0, text))

    def port_sim(self, generator, image, text):
        return (torch.where(_t(drop[0])[:, None], 0.0, image),
                torch.where(_t(drop[1])[:, None], 0.0, text))

    monkeypatch.setattr(JaxXray, "simulate_missing_modalities", jax_sim)
    monkeypatch.setattr(XrayAECFModel, "simulate_missing_modalities", port_sim)
    kw = dict(curriculum_enabled=True, missing_modality_training=True,
              return_info=True)
    j_logits, j_info = jm.apply(jp, _j(img), _j(txt), training=True,
                                rng=jax.random.key(11), **kw)
    logits, info = tm.train()(_t(img), _t(txt),
                              generator=torch.Generator().manual_seed(11), **kw)
    _close_out(logits, j_logits)
    _close(info["attention_weights"], j_info["attention_weights"])
    _close(info["entropy"], j_info["entropy"])
    np.testing.assert_array_equal(info["fusion_row_mask"].numpy(),
                                  np.asarray(j_info["fusion_row_mask"]))
    with pytest.raises(ValueError, match="missing_modality_training"):
        tm.train()(_t(img), _t(txt), missing_modality_training=True)


def test_simulate_missing_modalities_distribution():
    """Each modality drops at ``p - p²/2`` (independent drops at p, the
    rows where both would drop keep one of them by a coin flip), never
    both; JAX's simulation gives the same rates."""
    B, p = 40000, 0.3
    tm = XrayAECFModel(**XRAY, device="cpu")
    img, txt = torch.ones(B, 24), torch.ones(B, 16)
    out_img, out_txt = tm.simulate_missing_modalities(
        torch.Generator().manual_seed(12), img, txt)
    gone_img = out_img.abs().sum(1) == 0
    gone_txt = out_txt.abs().sum(1) == 0
    assert not bool((gone_img & gone_txt).any())
    want = p - p * p / 2
    sigma = math.sqrt(want * (1 - want) / B)
    for gone in (gone_img, gone_txt):
        assert abs(float(gone.float().mean()) - want) < 5 * sigma
    j_img, j_txt = JaxXray(**XRAY).simulate_missing_modalities(
        jax.random.key(12), jnp.ones((B, 24)), jnp.ones((B, 16)))
    for j in (j_img, j_txt):
        rate = float((jnp.abs(j).sum(1) == 0).mean())
        assert abs(rate - want) < 5 * sigma


# ---- the multi-scale model --------------------------------------------------


@pytest.mark.parametrize("impl", ["auto", "kernel"])
def test_multiscale_eval_matches_jax(monkeypatch, impl):
    _force_pool(monkeypatch, impl)
    jm, jp, tm = _pair(JaxMultiScale, MultiScaleFusion, dims=(16, 32))
    rng = np.random.default_rng(13)
    mods = [rng.standard_normal((5, 3, d)).astype(np.float32) for d in (16, 32)]
    j_outs, j_infos = jm.apply(jp, [_j(m) for m in mods], return_info=True)
    with torch.no_grad():
        outs, infos = tm.eval()([_t(m) for m in mods], return_info=True)
    for o, jo, i, ji in zip(outs, j_outs, infos, j_infos):
        _close_out(o, jo)
        assert set(i) == set(ji)
        for k in ("attention_weights", "entropy"):
            _close(i[k], ji[k])


def test_multiscale_training_needs_a_generator_and_counts_scales():
    _, _, tm = _pair(JaxMultiScale, MultiScaleFusion, dims=(16, 32))
    mods = [torch.randn(4, 3, 16), torch.randn(4, 3, 32)]
    with pytest.raises(ValueError, match="generator"):
        tm.train()(mods)
    with pytest.raises(ValueError, match="expected 2 scales"):
        tm.eval()(mods[:1])
    outs, infos = tm.train()(mods, generator=torch.Generator().manual_seed(0),
                             return_info=True)
    assert [tuple(o.shape) for o in outs] == [(4, 16), (4, 32)]
    assert all("target_entropy" in i for i in infos)


# ---- the vision-language model: use_checkpoint -------------------------------


@pytest.mark.parametrize("impl", ["auto", "kernel"])
def test_vision_language_checkpoint_gives_the_same_gradients(monkeypatch,
                                                             impl):
    """``use_checkpoint=True`` (``torch.utils.checkpoint`` around the pool)
    gives the same loss, masked weights, gradients and generator state as
    ``False``: the recompute draws what the forward drew."""
    _force_pool(monkeypatch, impl)
    cfg = dict(img_dim=12, txt_dim=10, hidden_dim=16, num_classes=3)
    jm = JaxVLM(**cfg)
    flat = _flat(jm.init(jax.random.key(14)))
    rng = np.random.default_rng(15)
    img, txt = map(_t, _feats(rng, 6, 12, 10))
    got = {}
    for ckpt in (False, True):
        tm = params_from_numpy(
            VisionLanguageModel(**cfg, device="cpu"), flat).train()
        g = torch.Generator().manual_seed(16)
        logits, info = tm(img, txt, generator=g, return_info=True,
                          use_checkpoint=ckpt)
        ((logits ** 2).mean() + info["attention_weights"].sum()).backward()
        got[ckpt] = ({n: p.grad.clone() for n, p in tm.named_parameters()},
                     info["masked_attention_weights"], g.get_state())
    for n, grad in got[False][0].items():
        torch.testing.assert_close(got[True][0][n], grad, rtol=0, atol=0)
    torch.testing.assert_close(got[True][1], got[False][1], rtol=0, atol=0)
    assert torch.equal(got[True][2], got[False][2])


def test_fork_generator_advances_the_stream_by_two_words():
    g, h = torch.Generator().manual_seed(17), torch.Generator().manual_seed(17)
    forked = fork_generator(g)
    torch.randint(0, 2 ** 32, (2,), generator=h)
    assert torch.equal(g.get_state(), h.get_state())
    assert forked.device.type == "cpu" and fork_generator(None) is None


# ---- precision on the torch path --------------------------------------------


@pytest.fixture
def process_at_high():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    yield
    torch.set_float32_matmul_precision(before)


def _spy(monkeypatch, module, seen, fail=False):
    real = module.attention_pool_core

    def spy(*args, **kwargs):
        seen.append(torch.get_float32_matmul_precision())
        if fail:
            raise RuntimeError("spied call fails")
        return real(*args, **kwargs)

    monkeypatch.setattr(module, "attention_pool_core", spy)


@pytest.mark.parametrize("entry", ["ops.fusion_pool", "MultimodalAttentionPool"])
@pytest.mark.parametrize("fail", [False, True])
def test_highest_runs_ieee_f32_and_restores_the_process_mode(
        monkeypatch, process_at_high, entry, fail):
    """With the process at ``'high'`` (TF32 allowed), a ``'highest'``
    torch-path call runs under ``'highest'`` and leaves ``'high'`` behind,
    also when the call raises; ``'default'`` and ``'high'`` keep the
    process's mode."""
    import aecf_tpu_torch.nn.modules as modules

    seen = []
    _spy(monkeypatch, ops if entry == "ops.fusion_pool" else modules, seen,
         fail)
    q, kv = torch.randn(1, 1, 8), torch.randn(3, 2, 8)
    params = MultimodalAttentionPool(8, device="cpu").params

    def call(precision):
        if entry == "ops.fusion_pool":
            return ops.fusion_pool(params, q, kv, implementation="torch",
                                   precision=precision)
        pool = MultimodalAttentionPool(
            8, curriculum_masking=CurriculumMasking(), implementation="torch",
            precision=precision, device="cpu")
        return pool.eval()(q, kv)

    for precision, want in (("highest", "highest"), ("default", "high"),
                            ("high", "high")):
        if fail:
            with pytest.raises(RuntimeError, match="spied call fails"):
                call(precision)
        else:
            call(precision)
        assert seen[-1] == want
        assert torch.get_float32_matmul_precision() == "high"


def test_highest_calls_overlapping_in_two_threads_restore_the_mode_once(
        monkeypatch, process_at_high):
    """Two threads' ``'highest'`` calls overlap (a enters, b enters, a
    leaves, b leaves): each runs under ``'highest'``, the mode stays so
    while b is still inside after a has left, and the process's ``'high'``
    comes back once both have left."""
    import threading

    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
    seen, errors = {}, []
    real = ops.attention_pool_core

    def spy(*args, **kwargs):
        name = threading.current_thread().name
        seen[name] = torch.get_float32_matmul_precision()
        if name == "a":
            a_in.set()
            assert b_in.wait(10)
        else:
            b_in.set()
            assert a_out.wait(10)
        return real(*args, **kwargs)

    monkeypatch.setattr(ops, "attention_pool_core", spy)
    params = MultimodalAttentionPool(8, device="cpu").params
    q, kv = torch.randn(1, 1, 8), torch.randn(3, 2, 8)

    def run():
        name = threading.current_thread().name
        try:
            ops.fusion_pool(params, q, kv, implementation="torch",
                            precision="highest")
            if name == "a":
                seen["after a"] = torch.get_float32_matmul_precision()
        except BaseException as e:  # reported below, in the test's thread
            errors.append(e)
            b_in.set()  # the other thread need not wait
        finally:
            if name == "a":
                a_out.set()

    a, b = (threading.Thread(target=run, name=n) for n in "ab")
    a.start()
    assert a_in.wait(10)
    b.start()
    a.join(30)
    b.join(30)
    assert not errors, errors
    assert seen == {"a": "highest", "b": "highest", "after a": "highest"}
    assert torch.get_float32_matmul_precision() == "high"


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)
