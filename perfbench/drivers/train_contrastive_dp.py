"""Data-parallel contrastive training (BASELINE config 5) through
``make_contrastive_scan_train_step(mesh=data_mesh())``: ``ranks``
processes, one card each, every rank's K batches staged on its card once,
then the chunk called back to back; on the cards each call replays one
CUDA graph of K updates with its all-gather, reduce-scatter and
all-reduce.

This process is rank 0 on the run's card (``cuda:0``).  ``setup()`` starts
ranks 1 .. n-1 first (``spawn``, a card each: ``cuda:<rank>``), so their
imports and CUDA contexts overlap rank 0's load (or build) of the kernel
libraries; they wait for rank 0's word that the libraries are built, then
join the group through ``maybe_initialize_distributed`` as rank 0 does
(NCCL on the cards, gloo on the CPU).  Each rank draws the weights (the same on every rank) and
its own rows from the seed on its card.  The other ranks follow rank 0's
calls through a pipe; rank 0 times the window.  A rank that dies, or a
wait past :data:`WAIT_S`, ends the run at once (this process exits
non-zero with the reason on stderr), so a lost rank never hangs it.

Traffic keys: ``global_batch``, ``ranks``, ``modalities``,
``steps_per_call`` (K), ``warm_calls`` (calls after the first, before the
window), ``trace_start_s`` and ``trace_s`` (the traced stretch of a
``--trace 1`` run).

Set-up's parts go to stderr as one line, each rank's moments in seconds
from the start of ``setup()``: ``started`` (a rank's imports done),
``context`` (its CUDA context made), ``go`` (the libraries built),
``group`` (joined), ``staged`` (state and rows), ``first`` (capture and
the first call), ``ready`` (warm calls done).
"""

from __future__ import annotations

import datetime
import math
import multiprocessing
import os
import socket
import statistics
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional

import torch

from .. import models
from ..reference import contrastive as ref
from ._training import FROZEN_SHARE, _gaps, _norms

# the longest rank 0 waits on the other ranks (their start, set-up and
# each synchronise) before it ends the run
WAIT_S = 120.0
STARTUP_S = 240.0
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)
LIBRARIES = ("shared_query_fwd", "shared_query_bwd")


def weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The contrastive model's leaves in torch's initial distributions:
    the pool as :func:`..models.pool_classifier_weights` draws it (biases
    uniform in ``±1/√E``, the query normal with standard deviation
    ``√(2/E)``), the two projections uniform in ``±1/√E``."""
    E, P = cfg["embed_dim"], cfg["proj_dim"]
    g = models.generator(seed, "weights", device)
    inv = 1.0 / math.sqrt(E)
    shapes = {"in_proj_weight": (3 * E, E), "out_proj_weight": (E, E),
              "in_proj_bias": (3 * E,), "out_proj_bias": (E,),
              "proj_w": (P, E), "proj_b": (P,),
              "target_proj_w": (P, E), "target_proj_b": (P,)}
    bounds = {k: inv for k in shapes}
    bounds["in_proj_weight"] = math.sqrt(6.0 / (4 * E))
    w = models._uniform_leaves(shapes, bounds, g, device)
    w["query"] = torch.randn((1, 1, E), generator=g, device=device) \
        * math.sqrt(2.0 / E)
    return w


def shard_inputs(cfg: Dict, traffic: Dict, seed: int, shard: int, device):
    """Shard ``shard``'s K batches, drawn as the JAX example draws them:
    ``base ~ N(0, 1)`` a row, each modality ``base + 0.5·N``, the target
    ``base + 0.3·N``; ``(kv (K, B, M·E), target (K, B, E))``."""
    K, M, E = traffic["steps_per_call"], traffic["modalities"], cfg["embed_dim"]
    B = traffic["global_batch"] // traffic["ranks"]
    g = models.generator(seed, f"inputs.{shard}", device)
    base = torch.randn((K, B, 1, E), generator=g, device=device)
    kv = torch.randn((K, B, M, E), generator=g, device=device)
    kv.mul_(0.5).add_(base)
    target = torch.randn((K, B, E), generator=g, device=device)
    target.mul_(0.3).add_(base[:, :, 0])
    return kv.reshape(K, B, M * E), target


class Rank:
    """One rank's program: the group, the mesh, the state over the
    benchmark's weights, its staged rows, the chunk."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.K = traffic["steps_per_call"]
        self.rng = models.sub_seed(seed, "masks")
        self.calls = 0
        self.stamps: Dict[str, float] = {}  # set-up's moments, monotonic

    def setup(self) -> None:
        from aecf_tpu_torch.parallel import (
            data_mesh,
            maybe_initialize_distributed,
            replicate,
        )
        from aecf_tpu_torch.train import (
            TrainState,
            init_contrastive_params,
            make_contrastive_scan_train_step,
            param_leaves,
        )

        cfg, dev = self.cfg, self.device
        kind = dev.type
        maybe_initialize_distributed(device_type=kind,
                                     timeout=COLLECTIVE_TIMEOUT)
        self.stamps["group"] = time.monotonic()
        self.rank = torch.distributed.get_rank()
        self.mesh = data_mesh(device_type=kind)
        w = weights(cfg, self.seed, dev)
        params = init_contrastive_params(torch.Generator(device=dev),
                                         cfg["embed_dim"], cfg["proj_dim"],
                                         device=dev)
        leaves = param_leaves(params)
        with torch.no_grad():
            for p, name in zip(leaves, ref.LEAVES):
                p.copy_(w[name].reshape(p.shape))
        replicate(self.mesh, params)
        opt = cfg["optimizer"]
        self.optimizer = torch.optim.AdamW(
            leaves, lr=opt["lr"], betas=tuple(opt["betas"]), eps=opt["eps"],
            weight_decay=opt["weight_decay"], capturable=kind == "cuda")
        self.state = TrainState(params, self.optimizer)
        self.leaves = leaves
        self.kv, self.target = shard_inputs(cfg, self.traffic, self.seed,
                                            self.rank, dev)
        self.chunk = make_contrastive_scan_train_step(
            temperature=cfg["temperature"], precision=cfg["precision"],
            base_mask_prob=cfg["base_mask_prob"],
            entropy_target=cfg["entropy_target"],
            min_active=cfg["min_active"], mesh=self.mesh)
        self.stamps["staged"] = time.monotonic()
        losses = self.call()
        self.first = self.snapshot(losses)
        self.sync()
        self.stamps["first"] = time.monotonic()
        for _ in range(self.traffic["warm_calls"]):
            self.call()
        self.sync()
        self.stamps["ready"] = time.monotonic()

    def call(self) -> torch.Tensor:
        self.state, losses, _ = self.chunk(self.state, self.kv, self.target,
                                           self.rng)
        self.calls += 1
        return losses

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def snapshot(self, losses: torch.Tensor) -> Dict:
        """What the first call left (global losses, the last step's global
        gradients, the parameters) and, on the graph route, this rank's
        attention weights and masks each step, as the graph wrote them."""
        snap = {
            "losses": losses.detach().float().clone(),
            "grads_last": dict(zip(ref.LEAVES, (
                p.grad.detach().clone() for p in self.leaves))),
            "params": dict(zip(ref.LEAVES, (
                p.detach().clone() for p in self.leaves))),
        }
        graphs = list(self.chunk._graphs.values())
        if graphs:
            info = graphs[0].step_info
            snap["weights"] = torch.stack(
                [i["attention_weights"][:, 0, :].float() for i in info])
            snap["masks"] = torch.stack(
                [i["masked_attention_weights"][:, 0, :] > 0 for i in info])
        return snap

    def release(self) -> None:
        """The rank's state dropped, and a gloo group torn down.  An NCCL
        group stays: tearing its communicator down
        (``destroy_process_group``) hangs on the four-card H100 machines
        the cell runs on, so ranks 1 .. n-1 leave with ``os._exit`` and
        rank 0 keeps its group to the process's end."""
        self.sync()
        self.chunk = self.state = self.optimizer = self.leaves = None
        self.kv = self.target = None
        dist = torch.distributed
        if dist.is_initialized() and dist.get_backend() == "gloo":
            dist.destroy_process_group()


def _rank_env(rank: int, world: int, port: int) -> Dict[str, str]:
    return {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
            "WORLD_SIZE": str(world), "RANK": str(rank),
            "LOCAL_RANK": str(rank)}


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _exit_with_parent(parent: int) -> None:
    """A rank's watchdog: the rank ends when rank 0's process is gone."""
    while True:
        time.sleep(0.5)
        if os.getppid() != parent:
            os._exit(3)


def _rank_main(rank: int, world: int, port: int, cfg: Dict, traffic: Dict,
               seed: int, kind: str, cache: Optional[str], conn) -> None:
    """Rank ``rank`` > 0: its CUDA context, rank 0's word that the
    libraries are built, set-up, then rank 0's commands."""
    stamps = {"started": time.monotonic()}
    parent = os.getppid()
    threading.Thread(target=_exit_with_parent, args=(parent,),
                     daemon=True).start()
    try:
        os.environ.update(_rank_env(rank, world, port))
        if kind == "cpu":
            torch.set_num_threads(1)
        from aecf_tpu_torch.measure import enable_persistent_cache

        enable_persistent_cache(cache)
        dev = torch.device("cuda", rank) if kind == "cuda" else torch.device(
            "cpu")
        if kind == "cuda":
            torch.cuda.set_device(dev)
            torch.cuda.init()
            torch.empty(1, device=dev)  # the context, before the word
        stamps["context"] = time.monotonic()
        if conn.recv() != "go":
            os._exit(1)
        stamps["go"] = time.monotonic()
        r = Rank(cfg, traffic, seed, dev)
        r.stamps = stamps
        r.setup()
        conn.send(("ready", stamps))
        while True:
            cmd = conn.recv()
            if cmd == "call":
                r.call()
            elif cmd == "sync":
                r.sync()
                conn.send(("synced", None))
            elif cmd == "stop":
                r.release()
                conn.send(("stopped", None))
                conn.close()
                os._exit(0)  # no teardown of the group (Rank.release)
    except Exception:  # the reason goes to rank 0, then this rank ends
        try:
            conn.send(("error", traceback.format_exc()))
        finally:
            os._exit(1)


class Run:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        t = cell.traffic
        self.K, self.world = t["steps_per_call"], t["ranks"]
        self.N = t["global_batch"]
        if self.N % self.world:
            raise ValueError(f"global batch {self.N} does not split over "
                             f"{self.world} ranks")
        self.rank0: Optional[Rank] = None
        self.procs: List = []
        self.conns: List = []
        self.deadline: Optional[float] = None
        self.stopping = self.done = False
        self.stamps: List[Dict[str, float]] = []  # rank 1 .. n-1's set-up

    # ---- the other ranks ------------------------------------------------

    def _fail(self, why: str) -> None:
        """End the run now: the other ranks killed, this process out with
        the reason (a collective that waits on a lost rank never
        returns)."""
        print(f"train_contrastive_dp: {why}", file=sys.stderr, flush=True)
        for p in self.procs:
            if p.is_alive():
                p.kill()
        os._exit(1)

    def _watch(self) -> None:
        while not self.done:
            time.sleep(0.25)
            if self.done:
                return
            for rank, (p, conn) in enumerate(zip(self.procs, self.conns), 1):
                if p.exitcode is not None and (p.exitcode or not self.stopping):
                    why = f"rank {rank} ended (exit code {p.exitcode})"
                    try:
                        if conn.poll():
                            kind, text = conn.recv()
                            if kind == "error":
                                why += f":\n{text}"
                    except (EOFError, OSError):
                        pass
                    self._fail(why)
            if self.deadline is not None and time.monotonic() > self.deadline:
                self._fail("the ranks did not answer in time")

    def _await(self, want: str, seconds: float) -> List:
        """Every other rank's ``want`` reply, within ``seconds``; what each
        sent with it."""
        self.deadline = time.monotonic() + seconds
        sent = []
        for rank, conn in enumerate(self.conns, 1):
            while not conn.poll(0.25):
                pass  # the watchdog ends the run on a death or the deadline
            kind, text = conn.recv()
            if kind != want:
                self._fail(f"rank {rank} answered {kind}:\n{text}")
            sent.append(text)
        self.deadline = None
        return sent

    def _tell(self, cmd: str) -> None:
        for conn in self.conns:
            conn.send(cmd)

    # ---- the harness's calls --------------------------------------------

    def setup(self) -> None:
        """Ranks 1 .. n-1 started, then the libraries (one build, here,
        while they import), then the word to go on, and this rank's
        set-up with theirs: the group, the state, the staged rows, the
        first call (capture and K updates, snapshotted for the check), the
        warm calls.  The set-up's moments go to stderr."""
        # a checkout without the contrastive step fails here, at once
        from aecf_tpu_torch.kernels import _build
        from aecf_tpu_torch.train import make_contrastive_scan_train_step  # noqa: F401

        t0 = time.monotonic()
        kind = self.device.type
        port = _free_port()
        ctx = multiprocessing.get_context("spawn")
        cache = str(_build._BUILD_ROOT)
        for rank in range(1, self.world):
            ours, theirs = ctx.Pipe()
            p = ctx.Process(target=_rank_main, daemon=True, args=(
                rank, self.world, port, self.cell.config, self.cell.traffic,
                self.seed, kind, cache, theirs))
            p.start()
            theirs.close()
            self.procs.append(p)
            self.conns.append(ours)
        threading.Thread(target=self._watch, daemon=True).start()
        stamps = {"started": time.monotonic()}
        if kind == "cuda":
            self.device = torch.device("cuda", 0)
            torch.cuda.set_device(self.device)
            _build.build_all(LIBRARIES)
        stamps["go"] = time.monotonic()
        self.deadline = time.monotonic() + STARTUP_S
        self._tell("go")
        os.environ.update(_rank_env(0, self.world, port))
        self.rank0 = Rank(self.cell.config, self.cell.traffic, self.seed,
                          self.device)
        self.rank0.stamps = stamps
        self.rank0.setup()
        self.stamps = self._await("ready", WAIT_S)
        parts = "; ".join(
            f"rank {r} " + " ".join(f"{k} {v - t0:.3f}" for k, v in s.items())
            for r, s in enumerate([stamps] + self.stamps))
        print(f"train_contrastive_dp: set-up (s from its start): {parts}",
              file=sys.stderr, flush=True)

    def _call(self) -> None:
        self._tell("call")
        self.rank0.call()

    def counters(self) -> Dict[str, float]:
        from aecf_tpu_torch.kernels import shared_query_bwd, shared_query_fwd
        from aecf_tpu_torch.parallel.collectives import counted

        out = {"updates": self.rank0.calls * self.K,
               "shared_query_fwd.launches": shared_query_fwd.launches,
               "shared_query_bwd.launches": shared_query_bwd.launches}
        out.update({f"collectives.{k}": v for k, v in vars(counted).items()})
        return out

    def _sync(self) -> None:
        """Every rank's work issued so far done."""
        self._tell("sync")
        self.deadline = time.monotonic() + WAIT_S
        self.rank0.sync()
        self._await("synced", WAIT_S)

    def window(self, seconds: float, tracer) -> Dict:
        start = self.rank0.calls
        self.deadline = time.monotonic() + seconds + WAIT_S
        t0 = time.perf_counter()
        while True:
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
            tracer.tick(elapsed)
            self._call()
        self._sync()
        tracer.stop()
        elapsed = time.perf_counter() - t0
        updates = (self.rank0.calls - start) * self.K
        return {
            "metrics": {"train_samples_per_s": updates * self.N / elapsed},
            "attempted": updates, "failed": 0,
            "work": {"updates": updates, "elapsed_s": elapsed,
                     "ranks": self.world},
        }

    def release(self) -> None:
        self.stopping = True
        self._tell("stop")
        self._await("stopped", WAIT_S)
        self.done = True
        for p in self.procs:
            p.join(timeout=WAIT_S)
            if p.is_alive():
                p.kill()
        self.procs, self.conns = [], []
        self.rank0.release()

    # ---- the comparison -------------------------------------------------

    def batches(self):
        """The first call's global batches as the reference takes them:
        step ``i``, a list over the shards of ``(kv (B, M, E), target (B,
        E))``, every shard's rows drawn anew from the seed on this card."""
        cfg, t = self.cell.config, self.cell.traffic
        shards = [shard_inputs(cfg, t, self.seed, s, self.device)
                  for s in range(self.world)]
        M, E = t["modalities"], cfg["embed_dim"]
        return [[(kv[i].view(-1, M, E), target[i]) for kv, target in shards]
                for i in range(self.K)]

    def check(self) -> Dict:
        return numbers(self)

    def reading(self, kind: str) -> Dict:
        return numbers(self, kind)


def reference_run(cfg: Dict, w: Dict[str, torch.Tensor], batches, rng,
                  precision: str, **fault) -> Dict:
    out = ref.train(w, batches, rng=rng, precision=precision,
                    optimizer=cfg["optimizer"],
                    temperature=cfg["temperature"],
                    mask_prob=cfg["base_mask_prob"],
                    min_active=cfg["min_active"], **fault)
    # rank 0's shard: the program's graph writes this rank's rows
    out["weights"] = out["weights"][:, 0]
    out["masks"] = out["masks"][:, 0] > 0.5
    return out


def compare(prog: Dict, want: Dict, weights0: Dict[str, torch.Tensor]
            ) -> Dict[str, Optional[float]]:
    """The numbers the cell holds to its limits: ``loss_gap`` (the worst
    step's relative gap of the global loss), ``grad_gap`` (the last step's
    global gradients) and ``update_gap`` (the parameters' change over the
    first call): the worst leaf's gap of norms over the larger of that
    leaf's or the median leaf's reference norm; ``weights_gap`` and
    ``mask_share`` over rank 0's rows."""
    lp, lr = prog["losses"].double().cpu(), want["losses"].double().cpu()
    first = _norms(want["grads_first"])
    med = statistics.median(first.values())
    moved = [k for k in ref.LEAVES if first[k] >= FROZEN_SHARE * med]
    delta = lambda p: {k: p[k].float() - weights0[k].reshape(p[k].shape)  # noqa: E731
                       for k in ref.LEAVES}
    grads = _gaps(_norms(prog["grads_last"]), _norms(want["grads_last"]),
                  list(ref.LEAVES))
    updates = _gaps(_norms(delta(prog["params"])),
                    _norms(delta(want["params"])), moved)
    out: Dict[str, Optional[float]] = {
        "loss_gap": float(((lp - lr).abs() / lr.abs()).max()),
        "grad_gap": max(grads.values()),
        "update_gap": max(updates.values()),
        "weights_gap": None,
        "mask_share": None,
        "grad_leaves": grads,
        "update_leaves": updates,
    }
    if "weights" in prog:
        out["weights_gap"] = float(
            (prog["weights"] - want["weights"]).abs().max())
        out["mask_share"] = float(
            (prog["masks"] != want["masks"]).float().mean())
    return out


def _flat(leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.reshape(-1) for k, v in leaves.items()}


def numbers(run: Run, kind: str = "program") -> Dict[str, Optional[float]]:
    """The compared numbers of the run's first call against the plain
    reference's global steps in f32, with in the program's place:
    ``'program'`` the program's first call; ``'control'`` the reference
    one precision down (the configuration's ``control``); the planted
    faults ``'half_batch'`` (each shard's loss over half its rows),
    ``'mask_altered'`` (every shard's masks from the step's unfolded
    words, the same on every rank) and ``'local_negatives'`` (InfoNCE over
    each shard's own targets)."""
    cfg = run.cell.config
    dev = run.device
    w = weights(cfg, run.seed, dev)
    batches = run.batches()
    rng = run.rank0.rng
    want = reference_run(cfg, w, batches, rng, "f32")
    B = run.N // run.world
    faults = {"half_batch": dict(loss_rows=B // 2),
              "mask_altered": dict(unfolded_masks=True),
              "local_negatives": dict(local_negatives=True)}
    if kind == "program":
        got = dict(run.rank0.first)
    elif kind == "control":
        got = reference_run(cfg, w, batches, rng, cfg["control"])
    elif kind in faults:
        got = reference_run(cfg, w, batches, rng, "f32", **faults[kind])
    else:
        raise ValueError(f"unknown reading {kind!r}")
    for k in ("grads_first", "grads_last", "params"):
        if k in want:
            want[k] = _flat(want[k])
        if k in got:
            got[k] = _flat(got[k])
    return compare(got, want, _flat(w))
