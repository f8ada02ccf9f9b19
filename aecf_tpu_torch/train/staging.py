"""Host batches to the parameters' device: the one path by which the
training loop, the evaluation sweep and the experiment move numpy batches
to the card."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["Stager"]


class Stager:
    """Copies host batches to ``device``, one buffer a stream.

    On the card each buffer is pinned, allocated once per shape and reused
    — two sets in turn, so the host fills one while the copy from the other
    may still be queued behind the device's work — and goes over in one
    asynchronous copy; elsewhere it is ordinary host memory, fresh each
    call.  The first two streams — a batch's image and text features —
    when they share a dtype and all but their last axis, share one buffer
    side by side on that axis and come back as column views of it: the
    packed ``(…, 2·E)`` kv, with no copy on the device (see
    ``as_fit_step`` / ``as_fit_chunk``)."""

    def __init__(self, device: Union[str, torch.device]):
        self.device = torch.device(device)
        self.slots: Dict[tuple, torch.Tensor] = {}
        self.turn = 0
        self.copied: List[Optional[torch.cuda.Event]] = [None, None]

    def __call__(
        self, steps: Iterable[Sequence[np.ndarray]], count: Optional[int] = None
    ) -> Tuple[torch.Tensor, ...]:
        """``steps``: each step's tuple of host arrays, one stream each,
        taken one at a time, so a generator's arrays are freed before the
        next step's are made.  ``count=None``: one step, returned as
        shaped; ``count=K``: K steps, returned with a leading step axis."""
        it = iter(steps)
        first = tuple(np.asarray(a) for a in next(it))
        lead = () if count is None else (count,)
        cuda = self.device.type == "cuda"
        turn = self.turn
        if cuda:
            self.turn = 1 - turn
            if self.copied[turn] is not None:
                self.copied[turn].synchronize()  # this set's last copy is done
        layout = []  # (streams, their widths, host buffer) a buffer
        for g, group in enumerate(self._groups(first)):
            a0 = first[group[0]]
            widths = [first[j].shape[-1] for j in group]
            shape = lead + (a0.shape[:-1] + (sum(widths),) if len(group) > 1
                            else a0.shape)
            layout.append((group, widths,
                           self._buffer(turn, g, shape, a0.dtype, cuda)))
        step, first = first, None
        for i in range(count or 1):
            if i:
                step = tuple(np.asarray(a) for a in next(it))
            for group, widths, buf in layout:
                dst = buf.numpy()[i] if lead else buf.numpy()
                if len(group) == 1:
                    np.copyto(dst, step[group[0]])
                    continue
                col = 0
                for j, w in zip(group, widths):
                    np.copyto(dst[..., col:col + w], step[j])
                    col += w
            step = None
        out: List[Optional[torch.Tensor]] = [None] * sum(
            len(group) for group, _, _ in layout)
        for group, widths, buf in layout:
            dev = buf.to(self.device, non_blocking=cuda)
            if len(group) == 1:
                out[group[0]] = dev
                continue
            col = 0
            for j, w in zip(group, widths):
                out[j] = dev[..., col:col + w]
                col += w
        if cuda:
            self.copied[turn] = torch.cuda.Event()
            self.copied[turn].record()
        return tuple(out)

    @staticmethod
    def _groups(first) -> List[Tuple[int, ...]]:
        """Streams sharing a buffer: the first two, when they can."""
        k = 2 if len(first) >= 2 and all(
            a.ndim >= 1 and a.dtype == first[0].dtype
            and a.shape[:-1] == first[0].shape[:-1] for a in first[:2]) else 0
        return ([tuple(range(k))] if k else []) + [
            (j,) for j in range(k, len(first))]

    def _buffer(self, turn, g, shape, dtype, cuda) -> torch.Tensor:
        if not cuda:
            return torch.from_numpy(np.empty(shape, dtype))
        key = (turn, g, shape, np.dtype(dtype).str)
        buf = self.slots.get(key)
        if buf is None:
            buf = self.slots[key] = torch.from_numpy(
                np.empty(shape, dtype)).pin_memory()
        return buf
