"""Training checkpoints and resume, on ``torch.save`` / ``torch.load``.

Port of :mod:`aecf_tpu.train.checkpointing` (orbax there).  A checkpoint
holds the whole :class:`~aecf_tpu_torch.train.TrainState`: the parameters
(the pool's ``state_dict``, the query and the head of a pool-classifier
dict, or a module's ``state_dict``), the optimizer's ``state_dict`` and
``step``.  Each is written to a temporary name and renamed into place, so
a run killed mid-write leaves no half checkpoint for :meth:`restore` to
pick; loading uses ``weights_only=True``.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from .trainer import TrainState

__all__ = ["CheckpointManager", "save_params", "load_params"]

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _params_state(params: Any) -> Dict[str, Any]:
    """The tensors of ``params`` as a nested dict of detached tensors."""
    if isinstance(params, nn.Module):
        return {"module": params.state_dict()}
    state: Dict[str, Any] = {
        "pool": params["pool"].state_dict(),
        "query": params["query"].detach(),
    }
    head = params.get("head")
    if head is not None:
        state["head"] = {k: v.detach() for k, v in head.items()
                         if v is not None}
    return state


def _load_params(params: Any, state: Dict[str, Any]) -> None:
    """Copy ``state`` into ``params`` in place (the optimizer keeps its
    references to the leaves; tensors move to each leaf's device)."""
    with torch.no_grad():
        if isinstance(params, nn.Module):
            params.load_state_dict(state["module"])
            return
        params["pool"].load_state_dict(state["pool"])
        params["query"].copy_(state["query"])
        head = params.get("head")
        if (head is None) != ("head" not in state):
            raise ValueError("checkpoint and state disagree on the head")
        if head is not None:
            for k, v in head.items():
                if v is not None:
                    v.copy_(state["head"][k])


def _write(path: str, obj: Any) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)  # atomic: a reader sees all of it or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class CheckpointManager:
    """Periodic :class:`TrainState` checkpoints with resume.

    ``save(step, state)`` writes ``step_<step>.pt`` in ``directory`` when
    ``step`` is a multiple of ``save_interval_steps`` or no checkpoint
    exists yet, and never at or below the latest step (orbax's default
    policy); ``force=True`` writes whatever the interval.  The newest
    ``max_to_keep`` are kept.  Saves are synchronous: :meth:`wait` and
    :meth:`close` have nothing to wait for.
    """

    def __init__(
        self,
        directory: str,
        *,
        save_interval_steps: int = 1000,
        max_to_keep: int = 3,
    ):
        if save_interval_steps < 1 or max_to_keep < 1:
            raise ValueError(
                "save_interval_steps and max_to_keep must be >= 1, got "
                f"{save_interval_steps} and {max_to_keep}"
            )
        self.directory = os.path.abspath(directory)
        self.save_interval_steps = save_interval_steps
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        return sorted(
            int(m.group(1))
            for m in map(_NAME.match, os.listdir(self.directory)) if m
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def save(self, step: int, state: TrainState, *, force: bool = False) -> bool:
        """Save if the interval policy says so (or ``force``); returns
        whether a checkpoint was written."""
        latest = self.latest_step()
        if not force and latest is not None and (
                latest >= step or step % self.save_interval_steps):
            return False
        self._commit(step, self._blob(state))
        return True

    def _blob(self, state: TrainState) -> Dict[str, Any]:
        """What a checkpoint of ``state`` holds."""
        return {
            "params": _params_state(state.params),
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step),
        }

    def _commit(self, step: int, blob: Dict[str, Any]) -> None:
        _write(self._path(step), blob)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> Optional[TrainState]:
        """Load the given (or latest) step into ``state`` — parameters in
        place, the optimizer through ``load_state_dict``, tensors mapped to
        the state's device — and return it; ``None`` when the directory
        holds no checkpoint."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        self._apply(state, torch.load(self._path(step), map_location="cpu",
                                      weights_only=True))
        return state

    def _apply(self, state: TrainState, blob: Dict[str, Any]) -> None:
        _load_params(state.params, blob["params"])
        state.optimizer.load_state_dict(blob["optimizer"])
        state.step = int(blob["step"])

    def wait(self) -> None:
        """Saves are synchronous; nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open."""


def save_params(path: str, params: Any) -> None:
    """One-shot parameter save (the reference's ``torch.save``), written
    to a temporary name and renamed."""
    _write(os.path.abspath(path), _params_state(params))


def load_params(path: str, params: Any) -> Any:
    """Load a :func:`save_params` file into ``params`` (in place, on their
    devices) and return them."""
    _load_params(params, torch.load(os.path.abspath(path),
                                    map_location="cpu", weights_only=True))
    return params
