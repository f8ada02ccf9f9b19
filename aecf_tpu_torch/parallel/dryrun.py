"""A multi-rank dry run of the parallel layer on the CPU.

The port's twin of ``__graft_entry__.dryrun_multichip``: ``n_devices``
gloo processes on this host, each one step of every parallel path::

    python -m aecf_tpu_torch.parallel.dryrun 4

exits non-zero when any rank fails or hangs.
"""

from __future__ import annotations

import argparse
import datetime
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

__all__ = ["dryrun_multichip"]

_ROOT = Path(__file__).resolve().parents[2]


def dryrun_multichip(n_devices: int, *, timeout: float = 300.0) -> None:
    """Run :func:`_rank` on ``n_devices`` gloo CPU processes: a DP step
    (with gradient accumulation) and a DP chunk of the X-ray model, a DP
    step and chunk of the one-pass pool step, and, for an even count, a
    data × tensor-parallel step on a ``(n/2, 2)`` mesh.  Raises
    ``RuntimeError`` naming the ranks that failed or outlived
    ``timeout`` seconds; every process is gone when it returns."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "aecf_tpu_torch.parallel.dryrun",
                 str(n_devices), "--rank", str(r), "--store", store],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
            for r in range(n_devices)
        ]
        deadline = time.monotonic() + timeout
        outputs = []
        for p in procs:
            try:
                out, _ = p.communicate(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                out, _ = p.communicate()
            outputs.append(out)
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}): ranks {failed} failed:\n"
            + "\n".join(outputs[r][-2000:] for r in failed))
    print(outputs[0].strip().splitlines()[-1])


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _rank(n_devices: int, rank: int, store: str) -> None:
    """One rank of the dry run (every rank the same code, its own rows)."""
    import torch
    import torch.distributed as dist

    from .. import parallel
    from ..models import XrayAECFModel
    from ..train import (
        TrainState,
        init_pool_classifier_params,
        make_pool_scan_train_step,
        make_pool_train_step,
        param_leaves,
    )

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, n_devices), rank=rank,
        world_size=n_devices, timeout=datetime.timedelta(seconds=60))
    try:
        g = torch.Generator().manual_seed(0)
        batch = 4 * n_devices
        img = torch.randn(batch, 32, generator=g)
        txt = torch.randn(batch, 32, generator=g)
        lab = (torch.rand(batch, 5, generator=g) < 0.3).float()
        done = []

        def model():
            return XrayAECFModel(image_dim=32, text_dim=32, hidden_dim=16,
                                 num_classes=5, num_heads=2, device="cpu")

        def apply_fn(m, i, t, gen):
            m.train()
            return m(i, t, generator=gen, curriculum_enabled=True,
                     missing_modality_training=True, return_info=True)

        def adamw(ps):
            return torch.optim.AdamW(ps, lr=1e-3, weight_decay=1e-4)

        mesh = parallel.data_mesh(device_type="cpu")
        m = parallel.replicate(mesh, model())
        state = TrainState(m, adamw(param_leaves(m)))
        local = parallel.shard_batch(mesh, (img, txt, lab), device="cpu")
        step = parallel.make_dp_train_step(apply_fn, mesh, accum_steps=2)
        state, loss, info = step(state, *local, 9)
        _check(bool(torch.isfinite(loss)) and bool(
            torch.isfinite(info["entropy"])), "dp step not finite")
        done.append("dp")

        chunk = parallel.make_dp_scan_train_step(apply_fn, mesh)
        staged = [torch.stack([x, x]) for x in local]
        state, losses, _ = chunk(state, *staged, 9)
        _check(losses.shape == (2,) and bool(torch.isfinite(losses).all()),
               "dp chunk not finite")
        done.append("dp chunk")

        params = parallel.replicate(mesh, init_pool_classifier_params(
            torch.Generator().manual_seed(4), 64, 5, device="cpu"))
        pstate = TrainState(params, adamw(param_leaves(params)))
        kv = torch.randn(batch, 2, 64, generator=g)
        kv_l, lab_l = parallel.shard_batch(mesh, (kv, lab), device="cpu")
        pool_step = make_pool_train_step(impl="fused-step", training=False,
                                         mesh=mesh)
        pstate, loss, info = pool_step(pstate, kv_l, lab_l, (1, 2))
        _check(bool(torch.isfinite(loss)) and bool(
            torch.isfinite(info["entropy"])), "pool dp step not finite")
        done.append("pool dp step")

        pool_chunk = make_pool_scan_train_step(impl="fused-step", mesh=mesh)
        pstate, losses, _ = pool_chunk(
            pstate, torch.stack([kv_l, kv_l]), torch.stack([lab_l, lab_l]), 3)
        _check(bool(torch.isfinite(losses).all()), "pool dp chunk not finite")
        done.append("pool dp chunk")

        if n_devices % 2 == 0:
            mesh2 = parallel.data_model_mesh(model_parallelism=2,
                                             device_type="cpu")
            tp = parallel.shard_params_tp(mesh2, model())
            tstate = TrainState(tp, adamw(param_leaves(tp)))
            rows = parallel.shard_batch(mesh2, (img, txt, lab), device="cpu")
            tp_step = parallel.make_tp_train_step(apply_fn, mesh2)
            tstate, loss, info = tp_step(tstate, *rows, 11)
            _check(bool(torch.isfinite(loss)) and bool(
                torch.isfinite(info["entropy"])), "dp x tp step not finite")
            done.append("dp x tp")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(f"dryrun_multichip({n_devices}): " + ", ".join(
        f"{d} ok" for d in done), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_devices", type=int)
    parser.add_argument("--rank", type=int)
    parser.add_argument("--store")
    args = parser.parse_args()
    if args.rank is None:
        dryrun_multichip(args.n_devices)
    else:
        _rank(args.n_devices, args.rank, args.store)


if __name__ == "__main__":
    main()
