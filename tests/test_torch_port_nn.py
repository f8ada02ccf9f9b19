"""The port's module API (``aecf_tpu_torch.nn``) against the JAX package's.

The cases of ``tests/test_modules.py`` run on both packages with the same
weights: JAX parameters flattened to numpy go into the port's pool through
``convert.attention_pool_from_numpy``.  Then the reference's own state
dicts: the 24 randomised goldens of ``tests/golden/pool_random_golden.npz``
and ``torch_ckpt_golden.npz``, loaded with ``load_state_dict(strict=True)``
and run under mask injection, as ``test_golden_parity.py`` and
``test_torch_compat.py`` run them through JAX.

Tolerances: 1e-5 throughout (f32 sums in other orders; the goldens' own
gate).  Training calls without ``mask_override`` draw different masks in
the two packages, so there only what the mask cannot touch is compared
(quirk Q1: the output; the weights and the entropy come before the mask).
On the CPU ``implementation='kernel'`` runs each kernel's plain version.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aecf_tpu
import aecf_tpu_torch
from aecf_tpu_torch import (
    CurriculumMasking,
    MultimodalAttentionPool,
    create_fusion_pool,
    multimodal_attention_pool,
)
from aecf_tpu_torch.convert import attention_pool_from_numpy
from aecf_tpu_torch.core import scaled_dot_product_attention

ATOL = 1e-5
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
KEYS_TRAIN = {"entropy", "mask_rate", "target_entropy", "attention_weights",
              "masked_attention_weights"}
KEYS_EVAL = KEYS_TRAIN - {"target_entropy"}


def _flat(params):
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def _pair(E=16, H=1, *, bias=True, cm=None, impl="auto", seed=0, **kw):
    """A JAX pool (XLA path) and a port pool on the same weights."""
    jcm = aecf_tpu.CurriculumMasking(**cm) if cm is not None else None
    tcm = CurriculumMasking(**cm) if cm is not None else None
    jp = aecf_tpu.MultimodalAttentionPool(
        E, num_heads=H, bias=bias, curriculum_masking=jcm,
        key=jax.random.key(seed), implementation="xla", **kw,
    )
    tp = MultimodalAttentionPool(
        E, num_heads=H, bias=bias, curriculum_masking=tcm,
        implementation=impl, device="cpu", **kw,
    )
    return jp, attention_pool_from_numpy(tp, _flat(jp.params))


def _data(seed, B=6, M=3, E=16, T=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, E)).astype(np.float32)
    kv = rng.standard_normal((B, M, E)).astype(np.float32)
    return q, kv


def _close(got, want, atol=ATOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, err_msg=msg)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ---- constructors and validation -------------------------------------------


@pytest.mark.parametrize(
    "make,match",
    [
        (lambda: MultimodalAttentionPool(embed_dim=0, device="cpu"), "embed_dim"),
        (lambda: MultimodalAttentionPool(8, num_heads=0, device="cpu"), "num_heads"),
        (lambda: MultimodalAttentionPool(10, num_heads=3, device="cpu"), "divisible"),
        (lambda: MultimodalAttentionPool(8, dropout=1.5, device="cpu"), "dropout"),
        (lambda: MultimodalAttentionPool(8, precision="fast",
                                         device="cpu"), "precision"),
        (lambda: MultimodalAttentionPool(8, implementation="xla",
                                         device="cpu"),
         "implementation"),
        (lambda: CurriculumMasking(base_mask_prob=0.0), "base_mask_prob"),
        (lambda: CurriculumMasking(entropy_target=1.5), "entropy_target"),
        (lambda: CurriculumMasking(min_active=0), "min_active"),
        (lambda: create_fusion_pool(0, 2, device="cpu"), "embed_dim"),
        (lambda: create_fusion_pool(5.0, 2, device="cpu"), "embed_dim"),
        (lambda: create_fusion_pool(8, 0, device="cpu"), "num_modalities"),
        (lambda: create_fusion_pool(8, 2, mask_prob=0.0, device="cpu"), "mask_prob"),
    ],
)
def test_constructor_checks(make, match):
    with pytest.raises(ValueError, match=match):
        make()


@pytest.mark.parametrize(
    "q_shape,k_shape,v_shape,exc,match",
    [
        ((2, 8), (2, 3, 8), None, ValueError, "3D"),
        ((2, 1, 8), (2, 0, 8), None, ValueError, "zero"),
        ((2, 1, 8), (3, 2, 8), None, ValueError, "incompatible|mismatch"),
        ((2, 1, 8), (2, 3, 8), (2, 4, 8), ValueError, "Value"),
        (None, (2, 3, 8), None, TypeError, "tensor"),
    ],
)
def test_forward_validation(q_shape, k_shape, v_shape, exc, match):
    pool = MultimodalAttentionPool(8, generator=_gen(), device="cpu").eval()
    q = "not a tensor" if q_shape is None else torch.zeros(q_shape)
    v = None if v_shape is None else torch.zeros(v_shape)
    with pytest.raises(exc, match=match):
        pool(q, torch.zeros(k_shape), v)


def test_state_dict_is_the_reference_layout():
    _, pool = create_fusion_pool(8, 2, generator=_gen(), device="cpu")
    assert set(pool.state_dict()) == {
        "curriculum_masking._eps", "attention.in_proj_weight",
        "attention.in_proj_bias", "attention.out_proj.weight",
        "attention.out_proj.bias",
    }
    assert float(pool.state_dict()["curriculum_masking._eps"]) == pytest.approx(1e-8)
    bare = MultimodalAttentionPool(8, bias=False, generator=_gen(),
                                   device="cpu")
    assert set(bare.state_dict()) == {"attention.in_proj_weight",
                                      "attention.out_proj.weight"}
    jp, _ = _pair(8)
    flat = _flat(jp.params)
    with pytest.raises(KeyError, match="unknown"):
        attention_pool_from_numpy(bare, dict(flat, **{".extra": np.zeros(1)}))
    with pytest.raises(RuntimeError, match="in_proj_bias"):
        attention_pool_from_numpy(bare, flat)  # bias=False has no biases


# ---- the pool against the JAX module ----------------------------------------


@pytest.mark.parametrize("impl", ["torch", "kernel"])
@pytest.mark.parametrize(
    "H,bias,batch_first,padded,sep_value,shared_query",
    [
        (1, True, True, False, False, False),
        (2, True, True, True, False, False),
        (1, False, False, True, False, False),
        (2, True, True, False, False, True),
        (2, True, False, False, False, False),
        (4, True, True, False, True, False),
        (1, True, True, True, False, True),
    ],
)
def test_eval_matches_jax_module(impl, H, bias, batch_first, padded,
                                 sep_value, shared_query):
    """Per-row and batch-1 queries, padding, seq-first layout and a value
    distinct from the key (which takes the torch path); output and info."""
    E, B, M = 16, 7, 3
    jp, tp = _pair(E, H, bias=bias, batch_first=batch_first,
                   cm=dict(base_mask_prob=0.5), impl=impl, seed=H)
    jp.eval()
    tp.eval()
    q, kv = _data(H + 10 * padded, B, M, E)
    if shared_query:
        q = q[:1]
    args = [q, kv] + ([kv[::-1].copy()] if sep_value else [])
    # the JAX XLA path does not broadcast a batch-1 query: hand it B rows
    j_args = [np.broadcast_to(q, (B, 1, E))] + args[1:]
    if not batch_first:
        args, j_args = ([np.swapaxes(a, 0, 1).copy() for a in x]
                        for x in (args, j_args))
    kpm = None
    if padded:
        kpm = np.random.default_rng(1).random((B, M)) < 0.3
        kpm[:, 0] = False
    j_out, j_info = jp(*map(jnp.asarray, j_args), return_info=True,
                       key_padding_mask=None if kpm is None else jnp.asarray(kpm))
    with torch.no_grad():
        t_out, t_info = tp(*map(torch.from_numpy, args), return_info=True,
                           key_padding_mask=None if kpm is None
                           else torch.from_numpy(kpm))
    _close(t_out, j_out)
    assert set(t_info) == set(j_info) == KEYS_EVAL
    for k in j_info:
        _close(t_info[k], j_info[k], msg=k)
    assert float(t_info["mask_rate"].abs().max()) == 0.0


@pytest.mark.parametrize("impl", ["torch", "kernel"])
@pytest.mark.parametrize("H", [1, 2])
def test_training_matches_jax_module(impl, H):
    """A training call with the Quick start's per-row query: key set,
    output (quirk Q1), weights and the detached entropy equal JAX's; the
    draws are each package's own."""
    E, B, M = 16, 8, 3
    jp, tp = _pair(E, H, cm=dict(base_mask_prob=0.9), impl=impl, seed=3)
    q, kv = _data(4, B, M, E)
    q = np.broadcast_to(q[:1], (B, 1, E))
    j_out, j_info = jp.train()(jnp.asarray(q), jnp.asarray(kv),
                               rng=jax.random.key(1), return_info=True)
    t_out, t_info = tp.train()(torch.from_numpy(q.copy()), torch.from_numpy(kv),
                               generator=_gen(1), return_info=True)
    assert set(t_info) == set(j_info) == KEYS_TRAIN
    _close(t_out, j_out)
    for k in ("attention_weights", "entropy", "target_entropy"):
        _close(t_info[k], j_info[k], msg=k)
    assert not t_info["entropy"].requires_grad
    assert not t_info["masked_attention_weights"].requires_grad
    assert t_info["attention_weights"].requires_grad
    assert float(t_info["mask_rate"].mean()) > 0
    assert tp.curriculum_masking._last_seq_len == M


@pytest.mark.parametrize("apply_masking", [False, True])
@pytest.mark.parametrize("H", [1, 2])
def test_mask_injection_matches_jax(H, apply_masking):
    """mask_override (the torch path in both packages) with and without
    apply_masking_to_output: every output and info entry."""
    E, B, M = 16, 9, 4
    jp, tp = _pair(E, H, cm=dict(base_mask_prob=0.7, min_active=2),
                   apply_masking_to_output=apply_masking, seed=5)
    q, kv = _data(6, B, M, E)
    mask = (np.random.default_rng(2).random((B, 1, M)) < 0.5).astype(np.float32)
    j_out, j_info = jp.train()(jnp.asarray(q), jnp.asarray(kv),
                               mask_override=jnp.asarray(mask),
                               return_info=True)
    t_out, t_info = tp.train()(torch.from_numpy(q), torch.from_numpy(kv),
                               mask_override=torch.from_numpy(mask),
                               return_info=True)
    _close(t_out, j_out)
    assert set(t_info) == set(j_info)
    for k in j_info:
        _close(t_info[k], j_info[k], msg=k)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_q1_masking_does_not_change_output(impl):
    E = 16
    q, kv = _data(7, 4, 3, E)
    _, plain = _pair(E, impl=impl, seed=2)
    _, masked = _pair(E, cm=dict(base_mask_prob=0.9), impl=impl, seed=2)
    out_plain = plain.train()(torch.from_numpy(q), torch.from_numpy(kv))
    out_masked, info = masked.train()(torch.from_numpy(q), torch.from_numpy(kv),
                                      generator=_gen(9), return_info=True)
    torch.testing.assert_close(out_plain, out_masked, rtol=0, atol=1e-6)
    assert float(info["mask_rate"].mean()) > 0


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_training_masking_needs_a_generator(impl):
    _, tp = _pair(8, cm={}, impl=impl)
    with pytest.raises(ValueError, match="generator"):
        tp.train()(torch.ones(2, 1, 8), torch.ones(2, 3, 8))
    dropout = MultimodalAttentionPool(8, dropout=0.5, generator=_gen(),
                                      device="cpu").train()
    with pytest.raises(ValueError, match="generator"):
        dropout(torch.ones(2, 1, 8), torch.ones(2, 3, 8))
    tp.eval()(torch.ones(2, 1, 8), torch.ones(2, 3, 8))  # eval draws nothing


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_schedule_sets_the_mask_prob(impl):
    """``schedule=`` (step -> prob): the module reads it at ``step=``; a
    scheduled training call without ``step`` raises, eval needs none."""
    cm = CurriculumMasking(schedule=lambda s: 1e-3 if s < 5 else 1.0)
    pool = MultimodalAttentionPool(16, curriculum_masking=cm,
                                   implementation=impl, generator=_gen(),
                                   device="cpu")
    assert cm.mask_prob_at(0) == 1e-3 and cm.mask_prob_at(9) == 1.0
    q, kv = map(torch.from_numpy, _data(8, 64, 3, 16))
    rates = {}
    for step in (0, 9):
        _, info = pool.train()(q, kv, generator=_gen(step), step=step,
                               return_info=True)
        rates[step] = float(info["mask_rate"].mean())
    assert rates[0] < 0.01 < 0.2 < rates[9]
    with pytest.raises(ValueError, match="step"):
        pool.train()(q, kv, generator=_gen())
    pool.eval()(q, kv)


def test_detach_info_false_gradient_matches_jax():
    """detach_info=False (the torch path): the entropy regularizer trains,
    and its gradient is finite with a padded slot (analytic xlogy)."""
    E, B, M = 16, 4, 3
    jp, tp = _pair(E, 2, cm=dict(detach_info=False), seed=7)
    q, kv = _data(9, B, M, E)
    mask = np.zeros((B, M), bool)
    mask[:, 2] = True

    def jax_loss(params):
        out, info = jp(jnp.asarray(q), jnp.asarray(kv),
                       key_padding_mask=jnp.asarray(mask), params=params,
                       rng=jax.random.key(1), return_info=True)
        return jnp.mean(out ** 2) + jnp.mean(info["entropy"])

    g_j = jax.grad(jax_loss)(jp.params)
    out, info = tp.train()(torch.from_numpy(q), torch.from_numpy(kv),
                           key_padding_mask=torch.from_numpy(mask),
                           generator=_gen(1), return_info=True)
    assert info["entropy"].requires_grad
    ((out ** 2).mean() + info["entropy"].mean()).backward()
    att = tp.attention
    for name, got in (("in_proj_weight", att.in_proj_weight.grad),
                      ("in_proj_bias", att.in_proj_bias.grad),
                      ("out_proj_weight", att.out_proj.weight.grad),
                      ("out_proj_bias", att.out_proj.bias.grad)):
        assert torch.isfinite(got).all()
        _close(got, getattr(g_j, name), msg=name)


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_use_checkpoint_same_values_and_grads(dropout):
    """torch.utils.checkpoint recomputes the attention in the backward;
    the dropout mask is redrawn from the same seed words, so values and
    gradients equal the uncheckpointed call's."""
    q, kv = map(torch.from_numpy, _data(10, 4, 3, 16))
    grads = []
    for ckpt in (False, True):
        pool = MultimodalAttentionPool(16, dropout=dropout, generator=_gen(3),
                                       device="cpu")
        out = pool.train()(q, kv, use_checkpoint=ckpt, generator=_gen(4))
        (out ** 2).sum().backward()
        grads.append((out.detach(), pool.attention.in_proj_weight.grad))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=0, atol=0)
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=0, atol=1e-6)


def test_functional_params_override():
    """``params=`` runs the call on other parameters (the JAX functional
    override); any object with the four pool tensors will do."""
    _, a = _pair(16, seed=1)
    _, b = _pair(16, seed=2)
    q, kv = map(torch.from_numpy, _data(11, 3, 2, 16))
    with torch.no_grad():
        torch.testing.assert_close(a.eval()(q, kv, params=b.params),
                                   b.eval()(q, kv))


def test_curriculum_masking_module_matches_jax():
    """The masking module alone: mask injection, the entropy loss through
    ``_last_seq_len``, the fused alias, the repr."""
    w = np.random.default_rng(3).dirichlet(np.ones(5), size=(6,)).astype(np.float32)
    mask = (np.random.default_rng(4).random((6, 5)) < 0.4).astype(np.float32)
    kw = dict(base_mask_prob=0.6, entropy_target=0.5, min_active=2)
    jm, tm = aecf_tpu.CurriculumMasking(**kw), CurriculumMasking(**kw)
    j_out, j_info = jm(jnp.asarray(w), mask_override=jnp.asarray(mask))
    t_out, t_info = tm(torch.from_numpy(w), mask_override=torch.from_numpy(mask))
    _close(t_out, j_out)
    for k in j_info:
        _close(t_info[k], j_info[k], msg=k)
    assert tm._last_seq_len == jm._last_seq_len == 5
    _close(tm.entropy_loss(t_info["entropy"]), jm.entropy_loss(j_info["entropy"]))
    assert CurriculumMasking.compute_entropy_fused is CurriculumMasking.compute_entropy
    _close(tm.compute_entropy(torch.from_numpy(w)), jm.compute_entropy(jnp.asarray(w)))
    assert "base_mask_prob=0.6" in repr(tm)
    assert "embed_dim=8" in repr(MultimodalAttentionPool(8, generator=_gen(),
                                                           device="cpu"))


# ---- the reference's own checkpoints ---------------------------------------


@pytest.fixture(scope="module")
def random_golden():
    data = np.load(os.path.join(GOLDEN, "pool_random_golden.npz"))
    return data, json.loads(bytes(data["cases"]).decode())


@pytest.mark.parametrize("idx", range(24))
def test_random_pool_golden(random_golden, idx):
    """The reference's randomised configurations (H up to 8, bias on/off,
    both layouts, T up to 3, padding, value != key, train/eval) through
    its state dicts, loaded strict, under mask injection."""
    data, cases = random_golden
    c = cases[idx]
    name = c["name"]
    pool = MultimodalAttentionPool(
        embed_dim=c["E"], num_heads=c["H"], bias=c["bias"],
        batch_first=c["batch_first"],
        curriculum_masking=CurriculumMasking(
            base_mask_prob=c["base_mask_prob"],
            entropy_target=c["entropy_target"], min_active=c["min_active"],
        ),
        generator=_gen(), device="cpu",
    ).train(c["training"])
    prefix = f"{name}_sd."
    pool.load_state_dict(
        {k[len(prefix):]: torch.from_numpy(np.array(data[k]))
         for k in data.files if k.startswith(prefix)},
        strict=True,
    )

    def arr(key):
        t = torch.from_numpy(np.array(data[f"{name}_{key}"]))
        return t if c["batch_first"] else t.transpose(0, 1)

    args = [arr("q"), arr("kv")]
    kw = {"return_info": True}
    if f"{name}_value" in data.files:
        args.append(arr("value"))
    if f"{name}_pad" in data.files:
        kw["key_padding_mask"] = torch.from_numpy(data[f"{name}_pad"])
    if f"{name}_mask" in data.files:
        kw["mask_override"] = torch.from_numpy(data[f"{name}_mask"])
    with torch.no_grad():
        out, info = pool(*args, **kw)
    _close(out, data[f"{name}_out"], msg=f"{name} ({c}): output")
    want = {k[len(f"{name}_info_"):] for k in data.files
            if k.startswith(f"{name}_info_")}
    assert set(info) == want
    for k in want:
        _close(info[k], data[f"{name}_info_{k}"], msg=f"{name}: info[{k}]")


@pytest.fixture(scope="module")
def ckpt_golden():
    g = np.load(os.path.join(GOLDEN, "torch_ckpt_golden.npz"))
    sd = {k[len("sd."):]: torch.from_numpy(np.array(g[k]))
          for k in g.files if k.startswith("sd.")}
    pool = MultimodalAttentionPool(
        sd["attention.out_proj.weight"].shape[0],
        num_heads=int(g["num_heads"]),
        curriculum_masking=CurriculumMasking(base_mask_prob=0.5,
                                             entropy_target=0.7),
        generator=_gen(), device="cpu",
    )
    pool.load_state_dict(sd, strict=True)
    return g, pool


@pytest.mark.parametrize("training", [False, True])
def test_reference_checkpoint_reproduces_its_outputs(ckpt_golden, training):
    g, pool = ckpt_golden
    q, kv = torch.from_numpy(g["q"]), torch.from_numpy(g["kv"])
    with torch.no_grad():
        if not training:
            _close(pool.eval()(q, kv), g["out_eval"])
            return
        out, info = pool.train()(q, kv, mask_override=torch.from_numpy(g["mask"]),
                                 return_info=True)
    _close(out, g["out_train"])
    _close(info["masked_attention_weights"], g["info_train_masked"])
    _close(info["entropy"], g["info_train_entropy"])


# ---- functional entry points -------------------------------------------------


def test_fast_path_is_projection_free_sdpa():
    q, kv = _data(12, 4, 3, 16)
    out = multimodal_attention_pool(torch.from_numpy(q), torch.from_numpy(kv))
    _close(out, scaled_dot_product_attention(torch.from_numpy(q),
                                             torch.from_numpy(kv),
                                             torch.from_numpy(kv)))
    _close(out, aecf_tpu.multimodal_attention_pool(jnp.asarray(q), jnp.asarray(kv)))


def test_slow_path_builds_a_fresh_module():
    """Q3: a fresh random init per call; the same init generator seed
    gives the same output, another seed another; training routes there."""
    q, kv = map(torch.from_numpy, _data(13, 4, 3, 16))
    a, b, c = (multimodal_attention_pool(q, kv, num_heads=2,
                                         init_generator=_gen(s))
               for s in (10, 11, 10))
    assert not torch.allclose(a, b)
    torch.testing.assert_close(a, c, rtol=0, atol=0)
    fast = multimodal_attention_pool(q, kv)
    slow = multimodal_attention_pool(q, kv, training=True,
                                     init_generator=_gen(0), generator=_gen(1))
    assert not torch.allclose(fast, slow)


def test_create_fusion_pool_wiring_and_init():
    query, pool = create_fusion_pool(32, 3, mask_prob=0.25, generator=_gen(),
                                     device="cpu")
    assert isinstance(query, torch.nn.Parameter) and query.shape == (1, 1, 32)
    assert pool.curriculum_masking.base_mask_prob == 0.25
    assert pool.num_heads == 1
    _, heads8 = create_fusion_pool(32, 2, num_heads=8, generator=_gen(),
                                   device="cpu")
    assert heads8.num_heads == 8
    big, _ = create_fusion_pool(4096, 2, generator=_gen(), device="cpu")
    std = float(big.detach().std())
    assert abs(std - math.sqrt(2.0 / 4096)) < 0.1 * math.sqrt(2.0 / 4096)
    a, _ = create_fusion_pool(8, 2, device="cpu")
    b, _ = create_fusion_pool(8, 2, device="cpu")
    assert not torch.equal(a, b)  # default seeds advance per call


def test_pool_and_query_default_to_the_card(monkeypatch):
    """With no ``device=`` the pool's parameters and the fusion query go
    to ``'cuda'``: the pool's move is recorded and made to the meta device
    here, so no CUDA call is made, and the query follows the pool."""
    moved = []

    def to(self, device):
        moved.append(str(device))
        return torch.nn.Module.to(self, "meta")

    monkeypatch.setattr(MultimodalAttentionPool, "to", to)
    pool = MultimodalAttentionPool(8, generator=_gen())
    query, fused = create_fusion_pool(8, 2, generator=_gen())
    assert moved == ["cuda", "cuda"]
    assert {p.device.type for p in [*pool.parameters(), *fused.parameters(),
                                    query]} == {"meta"}
    MultimodalAttentionPool(8, generator=_gen(), device="cpu")
    assert moved[2:] == ["cpu"]


def test_params_on_the_cpu_keep_the_pool_there(monkeypatch):
    """``params=`` on the CPU with no ``device=`` is the caller's choice:
    the pool makes no move, and its parameters and the fusion query stay
    on the CPU."""
    from aecf_tpu_torch.core import init_attention_pool_params

    moved = []
    monkeypatch.setattr(MultimodalAttentionPool, "to",
                        lambda self, device: moved.append(device) or self)
    params = init_attention_pool_params(_gen(), 8)
    pool = MultimodalAttentionPool(8, params=params)
    query, fused = create_fusion_pool(8, 2, params=params, generator=_gen())
    assert moved == []
    assert {p.device.type for p in [*pool.parameters(), *fused.parameters(),
                                    query]} == {"cpu"}


@pytest.mark.parametrize("impl", ["auto", "kernel"])
def test_quick_start_trains(impl):
    """The README Quick start in torch: the query expanded per row, a
    training call, the entropy regularizer, AdamW; the loss falls."""
    g = _gen(0)
    query, pool = create_fusion_pool(16, 3, implementation=impl, generator=g,
                                      device="cpu")
    pool.train()
    modalities = torch.randn(8, 3, 16, generator=g)
    target = torch.randn(8, 1, 16, generator=g)
    opt = torch.optim.AdamW([query, *pool.parameters()], lr=1e-2)
    losses = []
    for _ in range(15):
        q = query.expand(8, 1, 16)
        fused, info = pool(q, modalities, return_info=True, generator=g)
        assert set(info) == KEYS_TRAIN and fused.shape == (8, 1, 16)
        loss = ((fused - target) ** 2).mean() + 0.01 * (
            pool.curriculum_masking.entropy_loss(info["entropy"])
        )
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]
    assert query.grad is not None and query.grad.shape == (1, 1, 16)


def test_package_exports():
    assert aecf_tpu_torch.__version__ == "0.1.0"
    assert set(aecf_tpu_torch.__all__) == set(aecf_tpu.__all__) == {
        "CurriculumMasking",
        "MultimodalAttentionPool",
        "multimodal_attention_pool",
        "create_fusion_pool",
    }
