"""The port's metrics, sweeps, synthetic data, BCE train steps, evaluation
and the baseline-vs-AECF experiment against the JAX package's.

* Metrics, sweeps and synthetic features are numpy on both sides (the port
  keeps its own copies): equal to the JAX originals on the same inputs,
  atol 1e-12.
* ``make_train_step`` (and its microbatched and chunked forms) and
  ``evaluate_model`` over ``VisionLanguageModel`` loaded from JAX
  parameters through ``convert``, eval mode (no draw): loss rtol 2e-5 and
  parameters atol 2e-5 after SGD steps, as ``test_torch_port_pool_step.py``
  holds the pool step; mAP and macro-F1 atol 1e-5 (logits agree to f32
  sums in other orders).
* ``train_parallel_experiment`` for 2 epochs at a tiny width: the results
  dict has the JAX function's schema (keys, lengths, types).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import aecf_tpu.train.metrics as jax_metrics
from aecf_tpu.data import XRAY_PATHOLOGY_NAMES as JAX_NAMES
from aecf_tpu.data import make_synthetic_clip_features as jax_synthetic
from aecf_tpu.models import VisionLanguageModel as JaxVLM
from aecf_tpu.models import XrayAECFModel as JaxXray
from aecf_tpu.models import XrayBaselineModel as JaxBaseline
from aecf_tpu.train import ExperimentConfig as JaxConfig
from aecf_tpu.train import TrainState as JaxState
from aecf_tpu.train import evaluate_model as jax_evaluate
from aecf_tpu.train import make_train_step as jax_make_train_step
from aecf_tpu.train import missing_modality_sweep as jax_sweep
from aecf_tpu.train import modality_subsets as jax_subsets
from aecf_tpu.train import train_parallel_experiment as jax_experiment
import aecf_tpu_torch.train.metrics as port_metrics
from aecf_tpu_torch.convert import params_from_numpy
from aecf_tpu_torch.data import XRAY_PATHOLOGY_NAMES, make_synthetic_clip_features
from aecf_tpu_torch.models import (
    VisionLanguageModel,
    XrayAECFModel,
    XrayBaselineModel,
)
from aecf_tpu_torch.train import (
    ExperimentConfig,
    TrainState,
    accumulate_grads,
    bce_with_logits_loss,
    evaluate_model,
    make_scan_train_step,
    make_train_step,
    mask_modality,
    missing_modality_sweep,
    modality_subsets,
    train_parallel_experiment,
)

VLM = dict(img_dim=12, txt_dim=10, hidden_dim=16, num_classes=4)


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _scores(seed, n=60, c=5):
    rng = np.random.default_rng(seed)
    labels = (rng.random((n, c)) < 0.3).astype(np.float32)
    labels[:, -1] = 0.0  # a class with no positive
    logits = rng.standard_normal((n, c)) + 2.0 * labels
    logits[:5, 0] = logits[5:10, 0]  # tied scores
    return logits, labels


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_equal_jax(seed):
    logits, labels = _scores(seed)
    probs = port_metrics._sigmoid(logits)
    np.testing.assert_allclose(probs, jax_metrics._sigmoid(logits), atol=1e-12)
    for name in ("macro_map", "brier_score", "expected_calibration_error"):
        a = getattr(port_metrics, name)(probs if name != "macro_map" else logits,
                                        labels)
        b = getattr(jax_metrics, name)(probs if name != "macro_map" else logits,
                                       labels)
        np.testing.assert_allclose(a, b, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(
        port_metrics.average_precision(logits[:, 0], labels[:, 0]),
        jax_metrics.average_precision(logits[:, 0], labels[:, 0]), atol=1e-12)
    q, t = logits, logits + np.random.default_rng(seed).normal(
        size=logits.shape)
    ours, theirs = (m.recall_at_k(q, t, (1, 3)) for m in (port_metrics,
                                                          jax_metrics))
    assert ours.keys() == theirs.keys()
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], atol=1e-12)
    for a, b in zip(port_metrics.calculate_metrics(logits, labels, 0.4),
                    jax_metrics.calculate_metrics(logits, labels, 0.4)):
        np.testing.assert_allclose(a, b, atol=1e-12)


def test_sweeps_and_synthetic_data_equal_jax():
    assert modality_subsets(["a", "b", "c"]) == jax_subsets(["a", "b", "c"])
    train, val = make_synthetic_clip_features(
        n_train=40, n_val=20, image_dim=8, text_dim=6, num_classes=5, seed=3)
    jtrain, jval = jax_synthetic(
        n_train=40, n_val=20, image_dim=8, text_dim=6, num_classes=5, seed=3)
    for ours, theirs in ((train, jtrain), (val, jval)):
        for k in theirs:
            np.testing.assert_array_equal(ours[k], theirs[k])
    assert XRAY_PATHOLOGY_NAMES == JAX_NAMES
    w = np.random.default_rng(4).standard_normal((8 + 6, 5))

    def predict(image, text):
        return np.concatenate([image, text], axis=1) @ w

    mods = {"image": val["image"], "text": val["text"]}
    ours = missing_modality_sweep(predict, mods, val["label"], batch_size=7)
    theirs = jax_sweep(predict, mods, val["label"], batch_size=7)
    assert list(ours) == list(theirs)
    for subset in theirs:
        for k, v in theirs[subset].items():
            np.testing.assert_allclose(ours[subset][k], v, atol=1e-12,
                                       err_msg=f"{subset} {k}")
    img, txt = mask_modality(val["image"], val["text"], "images")
    assert not img.any() and txt is val["text"]


def _vlm(seed=0):
    jm = JaxVLM(**VLM)
    jp = jm.init(jax.random.key(seed))
    tm = params_from_numpy(VisionLanguageModel(**VLM, device="cpu"), _flat(jp))
    return jm, jp, tm


def _batches(seed, steps=3, B=8):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, VLM["img_dim"])).astype(np.float32),
             rng.standard_normal((B, VLM["txt_dim"])).astype(np.float32),
             (rng.random((B, VLM["num_classes"])) < 0.4).astype(np.float32))
            for _ in range(steps)]


def _port_apply(model, images, texts, generator):
    model.eval()  # no draw: the JAX side runs training=False
    return model(images, texts, return_info=True)


@pytest.mark.parametrize("accum", [1, 2])
def test_make_train_step_equals_jax(accum):
    jm, jp, tm = _vlm(1)
    opt = optax.sgd(1e-1)
    js = JaxState(jp, opt.init(jp), jnp.zeros((), jnp.int32))
    jstep = jax_make_train_step(
        lambda p, i, t, rng: jm.apply(p, i, t, training=False,
                                      return_info=True),
        opt, donate=False, accum_steps=accum, entropy_coeff=0.1)
    state = TrainState(tm, torch.optim.SGD(tm.parameters(), lr=1e-1))
    step = make_train_step(_port_apply, accum_steps=accum, entropy_coeff=0.1)
    for img, txt, lab in _batches(2):
        js, jl, jinfo = jstep(js, jnp.asarray(img), jnp.asarray(txt),
                              jnp.asarray(lab), jax.random.key(0))
        state, loss, info = step(state, *map(torch.from_numpy, (img, txt, lab)),
                                 3)
        np.testing.assert_allclose(float(loss), float(jl), rtol=2e-5)
        np.testing.assert_allclose(info["entropy"].numpy(),
                                   np.asarray(jinfo["entropy"]), atol=1e-5)
    assert state.step == 3
    final = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    for k, v in _flat(js.params).items():
        np.testing.assert_allclose(final[k.lstrip(".")], v, atol=2e-5,
                                   err_msg=k)


def test_scan_chunk_equals_steps_and_accumulation():
    """The K-step chunk equals K steps fed the folded seed words, exactly;
    ``accumulate_grads`` means equal microbatches' gradients."""
    batches = _batches(5, steps=4)
    stacked = [torch.from_numpy(np.stack([b[j] for b in batches]))
               for j in range(3)]
    _, _, a = _vlm(2)
    _, _, b = _vlm(2)
    sa = TrainState(a, torch.optim.SGD(a.parameters(), lr=1e-1))
    sb = TrainState(b, torch.optim.SGD(b.parameters(), lr=1e-1))
    sa, losses, infos = make_scan_train_step(_port_apply)(sa, *stacked, 9)
    assert losses.shape == (4,) and infos["entropy"].shape == (4,)
    from aecf_tpu_torch.kernels.draws import fold_seed_words

    step = make_train_step(_port_apply)
    for i in range(4):
        sb, loss, _ = step(sb, *(s[i] for s in stacked),
                           fold_seed_words(9, sb.step))
        assert torch.equal(loss, losses[i])
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)

    def loss_fn(model, img, txt, lab, generator):
        logits, info = _port_apply(model, img, txt, generator)
        return bce_with_logits_loss(logits, lab), info

    micro = tuple(torch.chunk(s[0], 2) for s in stacked)
    loss, info, grads = accumulate_grads(loss_fn, a, micro, 0, 2)
    full, _ = loss_fn(a, *(s[0] for s in stacked), None)
    want = torch.autograd.grad(full, list(a.parameters()))
    torch.testing.assert_close(loss, full.detach())
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w)
    assert info["entropy"].shape[0] == stacked[0].shape[1]


def _train_apply(model, images, texts, generator):
    model.train()  # the pool draws its curriculum mask from generator
    return model(images, texts, generator=generator, return_info=True)


@pytest.mark.parametrize("rng", ["generator", "words"])
def test_accumulated_step_draws_fresh_words_a_microbatch(rng):
    """``make_train_step(accum_steps=2)`` in training: microbatch ``i``
    draws from a CPU generator seeded with fresh seed words of ``rng`` (two
    words drawn from a CPU generator, or the words given) folded with
    ``i``; loss, gradients and masks equal the means of single steps on
    the microbatches fed those words."""
    from aecf_tpu_torch.kernels.draws import fold_seed_words

    img, txt, lab = map(torch.from_numpy, _batches(6, steps=1, B=16)[0])

    def draws():
        return (torch.Generator().manual_seed(5) if rng == "generator"
                else (7, 11))

    def fresh(ref):
        if rng == "words":
            return ref
        words = torch.randint(0, 2**32, (2,), generator=ref)
        return int(words[0]), int(words[1])

    _, _, model = _vlm(3)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=1e-1))
    state, loss, info = make_train_step(_train_apply, accum_steps=2)(
        state, img, txt, lab, draws())
    single = make_train_step(_train_apply)
    ref, half = draws(), img.shape[0] // 2
    losses, grads, masked = [], [], []
    for i in range(2):
        _, _, m = _vlm(3)
        s = TrainState(m, torch.optim.SGD(m.parameters(), lr=0.0))
        rows = slice(i * half, (i + 1) * half)
        s, loss_i, info_i = single(s, img[rows], txt[rows], lab[rows],
                                   fold_seed_words(fresh(ref), i))
        losses.append(loss_i)
        grads.append([p.grad for p in m.parameters()])
        masked.append(info_i["masked_attention_weights"])
    torch.testing.assert_close(loss, torch.stack(losses).mean())
    for got, a, b in zip(model.parameters(), *grads):
        torch.testing.assert_close(got.grad, (a + b) / 2)
    assert (masked[0] == 0).any() and (masked[1] == 0).any()
    assert torch.equal(info["masked_attention_weights"], torch.cat(masked))


@pytest.mark.parametrize("mask_type", ["none", "images", "texts"])
def test_evaluate_model_equals_jax(mask_type):
    jm, jp, tm = _vlm(3)
    rng = np.random.default_rng(6)
    n = 45  # a ragged last batch of 13
    img = rng.standard_normal((n, VLM["img_dim"])).astype(np.float32)
    txt = rng.standard_normal((n, VLM["txt_dim"])).astype(np.float32)
    lab = (rng.random((n, VLM["num_classes"])) < 0.4).astype(np.float32)
    ours = evaluate_model(lambda m, i, t: m.eval()(i, t), tm, img, txt, lab,
                          mask_type, 16)
    theirs = jax_evaluate(
        jax.jit(lambda p, i, t: jm.apply(p, i, t, training=False)), jp, img,
        txt, lab, mask_type, 16)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, b, atol=1e-5)


def _schema(results):
    out = {}
    for name, track in results.items():
        if name == "_states":
            out[name] = sorted(track)
            continue
        out[name] = {k: (len(v), type(v[0]).__name__ if v else None)
                     for k, v in track.items()}
    return out


def test_train_parallel_experiment_schema_equals_jax():
    cfg = dict(image_dim=8, text_dim=6, num_classes=5, hidden_dim=8)
    train, val = make_synthetic_clip_features(
        n_train=40, n_val=24, image_dim=8, text_dim=6, num_classes=5, seed=1)
    ours = train_parallel_experiment(
        XrayBaselineModel(**cfg, device="cpu"),
        XrayAECFModel(**cfg, num_heads=2, device="cpu"), train, val,
        ExperimentConfig(epochs=2, batch_size=16, curriculum_epoch=1,
                         eval_batch_size=16), verbose=False)
    theirs = jax_experiment(
        JaxBaseline(**cfg), JaxXray(**cfg, num_heads=2), train, val,
        JaxConfig(epochs=2, batch_size=16, curriculum_epoch=1,
                  eval_batch_size=16), verbose=False)
    assert _schema(ours) == _schema(theirs)
    assert ours["_states"]["aecf"].step == 4  # 2 epochs x 2 full batches
    for name in ("baseline", "aecf"):
        assert all(np.isfinite(ours[name]["train_loss"]))
    assert ours["aecf"]["gate_entropy"][1] > 0.0  # the curriculum epoch
