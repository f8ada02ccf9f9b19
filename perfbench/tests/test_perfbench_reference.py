"""The plain reference against the port's plain CPU path at small sizes:
the X3 step (forward, mask draw, BCE, gradients, AdamW), the
vision-language forward, the frozen Philox and epoch shuffle."""

import math

import numpy as np
import pytest
import torch

from perfbench import models
from perfbench.reference import epoch, philox
from perfbench.reference import pool_classifier as ref
from perfbench.reference import vision_language as vl
from perfbench.reference.common import mm

CPU = torch.device("cpu")
CFG = {"embed_dim": 32, "num_classes": 5}


@pytest.mark.parametrize("rng", [0, 7, 2**31 + 5, 2**40 + 3])
@pytest.mark.parametrize("step", [0, 1, 15, 2**33])
def test_philox_fold_is_the_ports(rng, step):
    from aecf_tpu_torch.kernels.draws import fold_seed_words

    assert philox.fold(rng, step) == fold_seed_words(rng, step)


@pytest.mark.parametrize("M", [2, 3, 5, 8])
def test_mask_uniforms_are_the_ports(M):
    from aecf_tpu_torch.kernels.draws import mask_uniforms

    seed = philox.fold(12345, 3)
    assert torch.equal(philox.uniforms(seed, 37, M),
                       mask_uniforms(seed, 37, M))


def _step_inputs(seed, B=96, M=3):
    w = models.pool_classifier_weights(CFG, seed, CPU)
    g = torch.Generator().manual_seed(seed)
    kv = torch.randn((B, M, CFG["embed_dim"]), generator=g)
    labels = (torch.rand((B, CFG["num_classes"]), generator=g) < 0.3).float()
    return w, kv, labels


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_step_matches_the_ports_plain_one_pass_step(seed):
    """Loss, every gradient, the attention weights and the mask of one
    step against ``fused_pool_head_train_step`` on CPU tensors (its plain
    version, Philox draws)."""
    from aecf_tpu_torch.kernels import fused_pool_head_train_step

    w, kv, labels = _step_inputs(seed)
    params = models.pool_classifier_params(CFG, w)
    words = philox.fold(99, seed)
    loss, grads, _, info = fused_pool_head_train_step(
        params["pool"], params["query"], params["head"], kv, labels,
        generator=words, precision="highest")
    out = ref.train(w, [(kv, labels)], rng=99, precision="f32",
                    optimizer={"lr": 1e-4, "weight_decay": 0.01,
                               "betas": (0.9, 0.999), "eps": 1e-8},
                    mask_prob=0.15, min_active=1)
    # the reference draws step i with fold(rng, i): step 0 here
    mask = ref.mask(out["weights"][0], words, 0.15, 1)
    assert math.isclose(float(loss), float(out["losses"][0]), rel_tol=1e-5)
    port = {"in_proj_weight": grads["pool"]["in_proj_weight"],
            "out_proj_weight": grads["pool"]["out_proj_weight"],
            "in_proj_bias": grads["pool"]["in_proj_bias"],
            "out_proj_bias": grads["pool"]["out_proj_bias"],
            "query": grads["query"], "head_w": grads["head"]["w"],
            "head_b": grads["head"]["b"]}
    for k in ref.LEAVES:
        torch.testing.assert_close(port[k].reshape(-1),
                                   out["grads_first"][k].reshape(-1),
                                   rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(info["attention_weights"][:, 0, :],
                               out["weights"][0], rtol=1e-5, atol=1e-6)
    assert torch.equal(info["masked_attention_weights"][:, 0, :] > 0,
                       mask > 0.5)


def test_three_adamw_steps_match_the_ports_torch_path():
    from aecf_tpu_torch.train import (
        TrainState,
        make_pool_train_step,
        param_leaves,
    )

    w, _, _ = _step_inputs(4)
    g = torch.Generator().manual_seed(5)
    batches = [(torch.randn((64, 3, 32), generator=g),
                (torch.rand((64, 5), generator=g) < 0.3).float())
               for _ in range(3)]
    params = models.pool_classifier_params(CFG, w)
    opt = torch.optim.AdamW(param_leaves(params), lr=1e-2,
                            weight_decay=0.01)
    state = TrainState(params, opt)
    step = make_pool_train_step(impl="torch")
    losses = []
    for kv, labels in batches:
        state, loss, _ = step(state, kv, labels, torch.Generator())
        losses.append(float(loss))
    out = ref.train(w, batches, rng=1, precision="f32",
                    optimizer={"lr": 1e-2, "weight_decay": 0.01,
                               "betas": (0.9, 0.999), "eps": 1e-8},
                    mask_prob=0.15, min_active=1)
    np.testing.assert_allclose(losses, out["losses"].numpy(), rtol=1e-5)
    for k, p in zip(ref.LEAVES, param_leaves(params)):
        got, want = p.detach().reshape(-1), out["params"][k].reshape(-1)
        if k == "in_proj_bias":
            # the key bias shifts every score of a row alike: its gradient
            # is round-off, which Adam scales up to steps of any sign
            keep = torch.ones_like(got, dtype=torch.bool)
            keep[32:64] = False
            got, want = got[keep], want[keep]
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


def test_half_batch_fault_changes_the_loss():
    w, kv, labels = _step_inputs(6)
    opt = {"lr": 1e-4, "weight_decay": 0.01, "betas": (0.9, 0.999),
           "eps": 1e-8}
    full = ref.train(w, [(kv, labels)], rng=1, precision="f32",
                     optimizer=opt, mask_prob=0.15, min_active=1)
    half = ref.train(w, [(kv, labels)], rng=1, precision="f32",
                     optimizer=opt, mask_prob=0.15, min_active=1,
                     loss_rows=kv.shape[0] // 2)
    assert float(full["losses"][0]) != float(half["losses"][0])
    torch.testing.assert_close(full["weights"], half["weights"])


@pytest.mark.parametrize("subset", ["both", "image", "text"])
def test_vision_language_matches_the_ports_model(subset):
    cfg = {"img_dim": 48, "txt_dim": 24, "hidden_dim": 16,
           "num_classes": 10, "base_mask_prob": 0.15, "num_heads": 1,
           "entropy_target": 0.7, "min_active": 1}
    w = models.vision_language_weights(cfg, 3, CPU)
    model = models.vision_language_model(cfg, w)
    g = torch.Generator().manual_seed(2)
    image = torch.randn((20, 48), generator=g)
    text = torch.randn((20, 24), generator=g)
    if subset == "image":
        text = torch.zeros_like(text)
    elif subset == "text":
        image = torch.zeros_like(image)
    with torch.no_grad():
        want = torch.sigmoid(model(image, text))
    got = vl.probabilities(w, image, text, "f32", block=7)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("step", [0, 3, 15, 16, 40])
def test_epoch_rows_are_make_epoch_batch_fns(step):
    from aecf_tpu_torch.train import make_epoch_batch_fn

    n, B = 256, 16
    store = {"image": np.arange(n, dtype=np.float32)[:, None],
             "text": np.zeros((n, 1), np.float32),
             "label": np.zeros((n, 1), np.float32)}
    batch = make_epoch_batch_fn(store, B, seed=11)(step)
    np.testing.assert_array_equal(batch[0][:, 0],
                                  epoch.batch_rows(n, B, 11, step))


def test_bf16_product_rounds_both_operands_in_both_passes():
    a = torch.randn(8, 16, requires_grad=True)
    b = torch.randn(16, 4, requires_grad=True)
    out = mm(a, b, "bf16")
    torch.testing.assert_close(out, a.bfloat16().float() @ b.bfloat16().float())
    out.sum().backward()
    ones = torch.ones(8, 4)
    torch.testing.assert_close(a.grad, ones @ b.detach().bfloat16().float().T)
    assert not torch.equal(mm(a, b, "bf16"), mm(a, b, "f32"))
