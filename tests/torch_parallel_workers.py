"""The port's side of the parallel tests, one rank a process.

Imports torch and the port, never JAX: the ``test_torch_port_parallel*``
files start ``world`` copies of this script on the CPU over gloo (a
``FileStore`` in the test's directory), each running one case of
``CASES`` on the numpy inputs the test wrote (``inputs.npz``) and writing
its results to ``out<rank>.npz``.  :func:`run_ranks` starts them, bounds
their time and gathers the results.

    python torch_parallel_workers.py CASE RANK WORLD DIR
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time
from typing import Dict, List

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# A case's ranks run well inside this; a hung collective is killed after it.
RANKS_TIMEOUT_S = 240


def run_ranks(case: str, world: int, workdir, inputs: Dict[str, np.ndarray],
              env=None) -> List[Dict[str, np.ndarray]]:
    """Run ``case`` on ``world`` ranks; every rank's results, by rank.
    Raises with the failing ranks' output when one fails or outlives
    :data:`RANKS_TIMEOUT_S`."""
    workdir = str(workdir)
    np.savez(os.path.join(workdir, "inputs.npz"), **inputs)
    full_env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = []
    for rank in range(world):
        rank_env = dict(full_env, **(env(rank) if env else {}))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), case, str(rank),
             str(world), workdir],
            cwd=workdir, env=rank_env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        outs.append(out)
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, f"{case}: ranks {bad} failed:\n" + "\n".join(
        outs[r][-4000:] for r in bad)
    return [dict(np.load(os.path.join(workdir, f"out{r}.npz")))
            for r in range(world)]


class MatmulModeSpy(TorchDispatchMode):
    """Records torch's float32 matmul mode (``seen``) at every ``aten.mm``,
    ``bmm`` and ``addmm`` dispatched while it is on; with ``fail=True`` it
    raises at the first instead, to stand for a backward that raises."""

    PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                torch.ops.aten.addmm.default)

    def __init__(self, fail: bool = False):
        super().__init__()
        self.fail = fail
        self.seen: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.PRODUCTS:
            self.seen.append(torch.get_float32_matmul_precision())
            if self.fail:
                raise RuntimeError("spied product fails")
        return func(*args, **(kwargs or {}))


def backward_under_spy(loss, kind: str, wrt=()) -> MatmulModeSpy:
    """``loss``'s backward under a :class:`MatmulModeSpy`: ``'full'``
    (``loss.backward()``), ``'partial'`` (``torch.autograd.grad`` with
    respect to ``wrt`` only) or ``'raise'`` (a full backward whose first
    product raises; the error is swallowed here)."""
    spy = MatmulModeSpy(fail=kind == "raise")
    try:
        with spy:
            if kind == "partial":
                torch.autograd.grad(loss, list(wrt))
            else:
                loss.backward()
    except RuntimeError as e:
        if kind != "raise" or "spied product fails" not in str(e):
            raise
    else:
        assert kind != "raise", "the spied backward did not raise"
    return spy


# ---- the ranks' side --------------------------------------------------------


def _sub(inputs, prefix):
    return {k[len(prefix):]: v for k, v in inputs.items()
            if k.startswith(prefix)}


def _t(x):
    import torch

    return torch.from_numpy(np.ascontiguousarray(x))


def _sgd(lr):
    import torch

    return lambda ps: torch.optim.SGD(ps, lr=lr)


def _pool_state(inputs, opt):
    from aecf_tpu_torch.convert import pool_classifier_params_from_numpy
    from aecf_tpu_torch.train import TrainState, param_leaves

    params = pool_classifier_params_from_numpy(_sub(inputs, "pool:"),
                                               device="cpu")
    return TrainState(params, opt(param_leaves(params)))


def _xray(inputs, prefix="xray:", **config):
    from aecf_tpu_torch.convert import params_from_numpy
    from aecf_tpu_torch.models import XrayAECFModel

    return params_from_numpy(
        XrayAECFModel(**config, device="cpu"), _sub(inputs, prefix))


def _xray_state(inputs, opt, prefix="xray:", **config):
    from aecf_tpu_torch.train import TrainState, param_leaves

    model = _xray(inputs, prefix, **config)
    return TrainState(model, opt(param_leaves(model)))


def eval_apply(model, images, texts, generator):
    model.eval()
    return model(images, texts), {}


def train_apply(model, images, texts, generator):
    model.train()
    return model(images, texts, generator=generator,
                 curriculum_enabled=True, return_info=True)


def _pool_flat(state, tag):
    from aecf_tpu_torch.convert import pool_classifier_params_to_numpy

    return {f"{tag}:p:{k}": v
            for k, v in pool_classifier_params_to_numpy(state.params).items()}


def _full_params(model) -> Dict[str, np.ndarray]:
    """A module's state dict with its head-sharded pools gathered whole."""
    from aecf_tpu_torch.parallel.tensor_parallel import sharded_pools

    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for (_, prefix), pool in sharded_pools(model):
        for name, p in pool.named_parameters(recurse=False):
            sd[prefix + name] = pool.gathered(name, p)
    return {k: v.numpy() for k, v in sd.items()}


def _module_flat(model, tag):
    return {f"{tag}:p:{k}": v for k, v in _full_params(model).items()}


def _replicated_grads(model, tag):
    from aecf_tpu_torch.parallel.tensor_parallel import sharded_pools

    pools = {id(p) for _, pool in sharded_pools(model)
             for n, p in pool.named_parameters() if n != "out_proj_bias"}
    return {f"{tag}:g:{n}": p.grad.numpy()
            for n, p in model.named_parameters()
            if id(p) not in pools and p.grad is not None}


def case_dp(rank, world, inputs, workdir):
    """The data-parallel steps, chunks and eval step over ('data',)."""
    import torch

    from aecf_tpu_torch import parallel
    from aecf_tpu_torch.kernels.draws import (
        device_generator,
        fold_seed_words,
        seed_words_of,
    )
    from aecf_tpu_torch.train import (
        make_pool_scan_train_step,
        make_pool_train_step,
        pool_step as ps,
    )

    mesh = parallel.data_mesh(device_type="cpu")
    out = {}
    kv, labels = parallel.shard_batch(
        mesh, (inputs["kv"], inputs["labels"]), device="cpu")
    steps = int(inputs["steps"])
    for impl in ("fused-step", "torch"):
        state = _pool_state(inputs, _sgd(0.1))
        step = make_pool_train_step(impl=impl, training=False, mesh=mesh)
        losses = []
        for i in range(steps):
            state, loss, _ = step(state, kv, labels, (3, i))
            losses.append(float(loss))
        out[f"step-{impl}:loss"] = np.asarray(losses)
        out.update(_pool_flat(state, f"step-{impl}"))
    K = int(inputs["chunk_k"])
    for impl, packed in (("fused-step", False), ("fused-step", True),
                         ("torch", False)):
        tag = f"chunk-{impl}{'-packed' if packed else ''}"
        state = _pool_state(inputs, _sgd(0.1))
        chunk = make_pool_scan_train_step(impl=impl, training=False,
                                          mesh=mesh)
        kv_k = kv.expand(K, *kv.shape)
        if packed:
            kv_k = kv_k.reshape(K, kv.shape[0], -1)
        state, losses, _ = chunk(state, kv_k, labels.expand(K, *labels.shape),
                                 13)
        out[f"{tag}:loss"] = losses.numpy()
        out.update(_pool_flat(state, tag))
    # per-shard masks: what the DP step's one-pass kernel drew on this
    # rank's rows, and the non-mesh step on them fed fold(seed, rank)
    drawn = []
    original = ps.fused_pool_head_train_step

    def recorder(*args, **kwargs):
        result = original(*args, **kwargs)
        drawn.append(result[3]["masked_attention_weights"].clone())
        return result

    ps.fused_pool_head_train_step = recorder
    try:
        seed = (5, 6)
        for mesh_, words in ((mesh, seed), (None, fold_seed_words(seed, rank)),
                             (None, seed)):
            make_pool_train_step(impl="fused-step", mesh=mesh_)(
                _pool_state(inputs, _sgd(0.1)), kv, labels, words)
    finally:
        ps.fused_pool_head_train_step = original
    out["masks:dp"], out["masks:single"], out["masks:unfolded"] = (
        d.numpy() for d in drawn)

    img, txt, lab = parallel.shard_batch(
        mesh, (inputs["img"], inputs["txt"], inputs["lab"]), device="cpu")
    for accum in (1, 2):
        state = _xray_state(inputs, _sgd(0.1), **_XRAY)
        step = parallel.make_dp_train_step(eval_apply, mesh,
                                           accum_steps=accum)
        state, loss, _ = step(state, img, txt, lab, 9)
        out[f"accum{accum}:loss"] = np.asarray(float(loss))
        out.update(_module_flat(state.params, f"accum{accum}"))
    model = _xray(inputs, **_XRAY).eval()
    e_img, e_txt = parallel.shard_batch(
        mesh, (inputs["img"][:32], inputs["txt"][:32]), device="cpu")
    eval_step = parallel.make_dp_eval_step(
        lambda m, b: m(b["image"], b["text"]), mesh)
    out["eval:out"] = eval_step(model, {"image": e_img, "text": e_txt}).numpy()

    # info as a global mean: the local means of this rank's draws, before
    # the step, against the step's info
    state = _xray_state(inputs, lambda ps_: torch.optim.AdamW(ps_, lr=1e-3),
                        **_XRAY)
    words = fold_seed_words(seed_words_of(0), rank)
    with torch.no_grad():
        _, local = train_apply(state.params, img, txt,
                               device_generator(words, "cpu"))
    step = parallel.make_dp_train_step(train_apply, mesh)
    state, loss, info = step(state, img, txt, lab, 0)
    out["info:local_entropy"] = local["entropy"].float().mean().numpy()
    out["info:entropy"] = info["entropy"].numpy()
    out["info:entropy_ndim"] = np.asarray(info["entropy"].ndim)

    # the DP chunk against K sequential DP steps fed fold(rng, i)
    chunk_state = _xray_state(inputs, _sgd(0.1), **_XRAY)
    seq_state = _xray_state(inputs, _sgd(0.1), **_XRAY)
    staged = [torch.stack([x] * K) for x in (img, txt, lab)]
    chunk = parallel.make_dp_scan_train_step(train_apply, mesh)
    chunk_state, losses, infos = chunk(chunk_state, *staged, 9)
    step = parallel.make_dp_train_step(train_apply, mesh)
    seq = []
    for i in range(K):
        seq_state, loss, _ = step(seq_state, img, txt, lab,
                                  fold_seed_words(9, i))
        seq.append(float(loss))
    out["scan:chunk_loss"], out["scan:seq_loss"] = losses.numpy(), np.asarray(seq)
    out["scan:entropy_shape"] = np.asarray(infos["entropy"].shape)
    out.update(_module_flat(chunk_state.params, "scan-chunk"))
    out.update(_module_flat(seq_state.params, "scan-seq"))
    return out


_XRAY = dict(image_dim=32, text_dim=32, hidden_dim=16, num_classes=5)


def case_tp(rank, world, inputs, workdir):
    """Tensor parallelism: pure TP over ('model',) at H=4, data × TP on a
    (2, 2) mesh at H=2, the TP chunk, fit with resume, and checkpoints."""
    import torch

    from aecf_tpu_torch import parallel
    from aecf_tpu_torch.kernels.draws import fold_seed_words
    from aecf_tpu_torch.train import (
        CheckpointManager,
        TrainState,
        make_train_step,
        param_leaves,
    )

    out = {}
    glob = tuple(inputs[k] for k in ("img", "txt", "lab"))
    meshes = {
        "tp": (parallel.make_mesh((world,), ("model",), device_type="cpu"),
               dict(_XRAY, num_heads=4), "xray4:"),
        "dptp": (parallel.data_model_mesh(model_parallelism=2,
                                          device_type="cpu"),
                 dict(_XRAY, num_heads=2), "xray2:"),
    }
    for tag, (mesh, config, prefix) in meshes.items():
        model = parallel.shard_params_tp(mesh, _xray(inputs, prefix, **config))
        state = TrainState(model, torch.optim.SGD(param_leaves(model), lr=0.1))
        batch = parallel.shard_batch(mesh, glob, device="cpu")
        step = parallel.make_tp_train_step(eval_apply, mesh)
        state, loss, _ = step(state, *batch, 9)
        out[f"{tag}:loss"] = np.asarray(float(loss))
        out.update(_module_flat(state.params, tag))
        out.update(_replicated_grads(state.params, tag))
        # the unsharded port step on the same (global) batch
        whole = _xray_state(inputs, _sgd(0.1), prefix, **config)
        whole, loss, _ = make_train_step(eval_apply)(
            whole, *(_t(x) for x in glob), 9)
        out[f"{tag}-whole:loss"] = np.asarray(float(loss))
        out.update(_replicated_grads(whole.params, f"{tag}-whole"))

    mesh, config, prefix = meshes["dptp"]
    K = 3
    batch = parallel.shard_batch(mesh, glob, device="cpu")
    staged = [torch.stack([x] * K) for x in batch]
    states = []
    for _ in range(2):
        model = parallel.shard_params_tp(mesh, _xray(inputs, prefix, **config))
        states.append(TrainState(model, torch.optim.SGD(param_leaves(model),
                                                        lr=0.1)))
    chunk = parallel.make_tp_scan_train_step(train_apply, mesh)
    chunked, losses, infos = chunk(states[0], *staged, 9)
    step = parallel.make_tp_train_step(train_apply, mesh)
    seq, seq_losses = states[1], []
    for i in range(K):
        seq, loss, _ = step(seq, *batch, fold_seed_words(9, i))
        seq_losses.append(float(loss))
    out["scan:chunk_loss"], out["scan:seq_loss"] = (losses.numpy(),
                                                    np.asarray(seq_losses))
    out["scan:entropy_shape"] = np.asarray(infos["entropy"].shape)
    out.update(_module_flat(chunked.params, "scan-chunk"))
    out.update(_module_flat(seq.params, "scan-seq"))

    out.update(_fit_runs(inputs, mesh, config, prefix, workdir, "fit"))
    if rank == 0:
        # the TP checkpoint (gathered pools) restores into an unsharded model
        whole = _xray_state(
            inputs, lambda ps_: torch.optim.AdamW(ps_, lr=1e-3), prefix,
            **config)
        CheckpointManager(os.path.join(workdir, "fit-ckpt")).restore(whole)
        out["restored:step"] = np.asarray(whole.step)
        out.update(_module_flat(whole.params, "restored"))
    return out


def _fit_runs(inputs, mesh, config, prefix, workdir, tag):
    """``fit(mesh=)``: 8 steps uninterrupted, 4 then resumed to 8 from the
    checkpoints, and 6 steps with scan_chunk 1 and 3."""
    import torch

    from aecf_tpu_torch.train import fit

    data = {k: inputs[f"fit_{k}"] for k in ("image", "text", "label")}
    rows = data["image"].shape[0]

    def batch_fn(step):
        sel = np.random.default_rng(step).integers(0, rows, size=16)
        return data["image"][sel], data["text"][sel], data["label"][sel]

    def run(num_steps, ckpt=None, chunk=1):
        model = _xray(inputs, prefix, **config)
        state, _ = fit(
            train_apply,
            lambda ps_: torch.optim.AdamW(ps_, lr=1e-3, weight_decay=1e-4),
            model, batch_fn, num_steps=num_steps, rng=1,
            checkpoint_dir=ckpt, save_every=1, mesh=mesh, scan_chunk=chunk)
        return state

    out = {}
    full = run(8)
    ckpt = os.path.join(workdir, f"{tag}-ckpt")
    first = run(4, ckpt)
    resumed = run(8, ckpt)
    out[f"{tag}:steps"] = np.asarray([full.step, first.step, resumed.step])
    out.update(_module_flat(full.params, f"{tag}-full"))
    out.update(_module_flat(resumed.params, f"{tag}-resumed"))
    out.update(_module_flat(run(6).params, f"{tag}-single6"))
    out.update(_module_flat(run(6, chunk=3).params, f"{tag}-chunk6"))
    return out


def case_fit(rank, world, inputs, workdir):
    """``fit(mesh=)`` data-parallel (the X-ray model, and the pool steps),
    and FusionPredictor(mesh=)."""
    import torch

    from aecf_tpu_torch import parallel
    from aecf_tpu_torch.convert import params_from_numpy
    from aecf_tpu_torch.models import VisionLanguageModel
    from aecf_tpu_torch.serve import FusionPredictor
    from aecf_tpu_torch.train import (
        as_fit_chunk,
        as_fit_step,
        fit,
        make_pool_scan_train_step,
        make_pool_train_step,
    )

    mesh = parallel.data_mesh(device_type="cpu")
    out = _fit_runs(inputs, mesh, _FIT_XRAY, "xray:", workdir, "fit")
    # DP fit against JAX's: the draw-free apply, SGD
    from aecf_tpu_torch.convert import pool_classifier_params_from_numpy

    data = {k: inputs[f"fit_{k}"] for k in ("image", "text", "label")}
    rows = data["image"].shape[0]

    def batch_fn(step):
        sel = np.random.default_rng(step).integers(0, rows, size=16)
        return data["image"][sel], data["text"][sel], data["label"][sel]

    state, history = fit(
        eval_apply, _sgd(0.1), _xray(inputs, **_FIT_XRAY), batch_fn,
        num_steps=4, rng=1, mesh=mesh, log_every=1)
    out["jaxfit:loss"] = np.asarray(history["loss"])
    out.update(_module_flat(state.params, "jaxfit"))

    # the pool steps through fit: resume, and chunks against single steps
    def pool_run(num_steps, ckpt=None, chunk=1):
        params = pool_classifier_params_from_numpy(_sub(inputs, "pool:"),
                                                   device="cpu")
        state, _ = fit(
            None, lambda ps_: torch.optim.AdamW(ps_, lr=1e-2), params,
            batch_fn, num_steps=num_steps, rng=5, checkpoint_dir=ckpt,
            save_every=2, mesh=mesh, scan_chunk=chunk,
            step_fn=as_fit_step(make_pool_train_step(impl="fused-step",
                                                     mesh=mesh)),
            chunk_fn=as_fit_chunk(make_pool_scan_train_step(
                impl="fused-step", mesh=mesh)))
        return state

    for tag, st in (("pool-full", pool_run(8)),
                    ("pool-first", pool_run(5, os.path.join(workdir, "p"), 3)),
                    ("pool-resumed", pool_run(8, os.path.join(workdir, "p"), 3)),
                    ("pool-chunk", pool_run(8, chunk=3))):
        out.update(_pool_flat(st, tag))
        out[f"{tag}:step"] = np.asarray(st.step)

    # FusionPredictor(mesh=) against the unsharded predictor
    vlm = params_from_numpy(
        VisionLanguageModel(img_dim=32, txt_dim=16, hidden_dim=8,
                            num_classes=5, device="cpu"),
        _sub(inputs, "vlm:")).eval()

    def predictor(mesh_=None, buckets=(8, 32)):
        return FusionPredictor(lambda image, text: vlm(image, text),
                               modality_names=("image", "text"),
                               buckets=buckets, device="cpu", mesh=mesh_)

    sharded, single = predictor(mesh), predictor()
    img, txt = inputs["serve_img"], inputs["serve_txt"]
    for tag, req in (("ragged", dict(image=img[:21], text=txt[:21])),
                     ("chunked", dict(image=img, text=txt)),
                     ("missing", dict(image=img))):
        out[f"serve-{tag}:sharded"] = sharded(**req)
        out[f"serve-{tag}:single"] = single(**req)
    out["serve:calls"] = np.asarray([sharded.calls, single.calls])
    # neither a mesh nor the CPU takes the card's pinned route
    out["serve:staged"] = np.asarray([sharded.staged, single.staged])
    try:
        predictor(mesh, buckets=(3, 32))
    except ValueError as e:
        out["serve:error"] = np.asarray(str(e))
    return out


_FIT_XRAY = dict(image_dim=16, text_dim=16, hidden_dim=8, num_classes=4)


def case_env(rank, world, inputs, workdir):
    """torchrun's environment → maybe_initialize_distributed → a mesh →
    a global sum of every rank's shard, and one DP step."""
    import torch
    import torch.distributed as dist

    from aecf_tpu_torch import parallel

    parallel.maybe_initialize_distributed(
        device_type="cpu", timeout=datetime.timedelta(seconds=60))
    parallel.maybe_initialize_distributed(device_type="cpu")  # tolerated
    assert dist.get_world_size() == world and dist.get_rank() == rank
    mesh = parallel.data_mesh(device_type="cpu")
    local = parallel.shard_batch(mesh, torch.arange(16, dtype=torch.float32),
                                 device="cpu")
    total = local.sum()
    dist.all_reduce(total, group=mesh.get_group("data"))
    state = _pool_state(inputs, _sgd(0.1))
    kv, labels = parallel.shard_batch(
        mesh, (inputs["kv"], inputs["labels"]), device="cpu")
    from aecf_tpu_torch.train import make_pool_train_step

    state, loss, _ = make_pool_train_step(
        impl="fused-step", training=False, mesh=mesh)(state, kv, labels, 0)
    out = {"total": total.numpy(), "loss": np.asarray(float(loss))}
    out.update(_pool_flat(state, "env"))
    return out


GRAD_PROCESS_MODES = ("high", "medium", "highest")
GRAD_PRECISIONS = ("highest", "default")
GRAD_KINDS = ("full", "partial", "raise")


def case_grad_modes(rank, world, inputs, workdir):
    """The TP pool (H=4 over the ranks' ('model',) mesh) under a
    :class:`MatmulModeSpy`: for each process mode, precision and kind of
    backward, the mode at each backward product and the process's mode
    afterwards."""
    from aecf_tpu_torch import ops, parallel
    from aecf_tpu_torch.core import AttentionPoolParams

    mesh = parallel.make_mesh((world,), ("model",), device_type="cpu")
    pool = parallel.shard_params_tp(mesh, AttentionPoolParams(
        **{k: _t(v) for k, v in _sub(inputs, "pool:").items()}))
    out = {}
    for process in GRAD_PROCESS_MODES:
        for precision in GRAD_PRECISIONS:
            for kind in GRAD_KINDS:
                torch.set_float32_matmul_precision(process)
                q = _t(inputs["q"]).requires_grad_()
                kv = _t(inputs["kv"]).requires_grad_()
                o, w, _, _ = ops.fusion_pool(pool, q, kv, num_heads=4,
                                             precision=precision)
                spy = backward_under_spy((o ** 2).sum() + w.sum(), kind,
                                         wrt=[q])
                tag = f"{process}:{precision}:{kind}"
                out[f"{tag}:modes"] = np.asarray(spy.seen, dtype=str)
                out[f"{tag}:after"] = np.asarray(
                    torch.get_float32_matmul_precision())
    return out


def case_contrastive(rank, world, inputs, workdir):
    """The contrastive chunk over ('data',): K eager updates on this rank's
    rows, each step's masks (recorded from the pool's info) and the
    collectives counted by one call; then the differentiable row gather's
    gradient beside autograd through a concatenation."""
    from aecf_tpu_torch import parallel
    from aecf_tpu_torch.parallel import collectives
    from aecf_tpu_torch.train import (
        TrainState,
        contrastive,
        init_contrastive_params,
        make_contrastive_scan_train_step,
        param_leaves,
    )

    mesh = parallel.make_mesh((world,), ("data",), device_type="cpu")
    E, P = inputs["kv"].shape[-1], inputs["w:proj_w"].shape[0]
    params = init_contrastive_params(None, E, P, device="cpu")
    leaves = param_leaves(params)
    names = [str(n) for n in inputs["leaves"]]
    with torch.no_grad():
        for p, name in zip(leaves, names):
            p.copy_(_t(inputs[f"w:{name}"]).reshape(p.shape))
    state = TrainState(params, torch.optim.AdamW(
        leaves, lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4))
    K, N, M, _ = inputs["kv"].shape
    B = N // world
    rows = slice(rank * B, (rank + 1) * B)
    kv = _t(inputs["kv"][:, rows]).reshape(K, B, M * E)
    target = _t(inputs["target"][:, rows])
    masks = []
    pool_step = contrastive.fused_pool_train_step

    def spy(*args, **kwargs):
        out = pool_step(*args, **kwargs)
        masks.append(out[-1]["masked_attention_weights"][:, 0, :] > 0)
        return out

    contrastive.fused_pool_train_step = spy
    chunk = make_contrastive_scan_train_step(mesh=mesh)
    before = dict(vars(collectives.counted))
    state, losses, infos = chunk(state, kv, target, int(inputs["seed"]))
    counted = {k: v - before[k] for k, v in vars(collectives.counted).items()}
    contrastive.fused_pool_train_step = pool_step
    out = {"losses": losses.numpy(), "masks": torch.stack(masks).numpy(),
           "entropy": infos["entropy"].numpy()}
    out.update({f"grad:{n}": p.grad.numpy() for n, p in zip(names, leaves)})
    out.update({f"param:{n}": p.detach().numpy()
                for n, p in zip(names, leaves)})
    out.update({f"counted:{k}": np.asarray(v) for k, v in counted.items()})
    # the gather: rank r's loss weighs the gathered rows by weights[r]
    group = mesh.get_group("data")
    t = _t(inputs["gather_t"][rows]).requires_grad_(True)
    gathered = collectives.all_gather_rows(t, group)
    (gathered * _t(inputs["gather_w"][rank])).sum().backward()
    whole = _t(inputs["gather_t"]).requires_grad_(True)
    every = sum((torch.cat(whole.split(B)) * _t(w)).sum()
                for w in inputs["gather_w"])
    every.backward()
    out["gather"] = gathered.detach().numpy()
    out["gather_grad"] = t.grad.numpy()
    out["concat_grad"] = whole.grad[rows].numpy()
    return out


CASES = {"dp": case_dp, "tp": case_tp, "fit": case_fit, "env": case_env,
         "grad_modes": case_grad_modes, "contrastive": case_contrastive}


def main():
    case, rank, world, workdir = (sys.argv[1], int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4])
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if case != "env":
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(workdir, "store"),
                                         world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=60))
    inputs = dict(np.load(os.path.join(workdir, "inputs.npz")))
    try:
        out = CASES[case](rank, world, inputs, workdir)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    assert "jax" not in sys.modules, "a rank imported jax"
    np.savez(os.path.join(workdir, f"out{rank}.npz"), **out)


if __name__ == "__main__":
    main()
