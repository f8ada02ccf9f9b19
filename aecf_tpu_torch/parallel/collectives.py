"""The collectives of the parallel steps, over one axis of a mesh.

gloo groups reduce host memory: a card tensor given to a gloo collective
is copied to pinned host memory, reduced there and copied back, explicitly
(so two ranks sharing one card can run over gloo, where NCCL refuses two
ranks on one device).  NCCL groups take card tensors as they are — and a
CUDA graph can capture them, which the K-step chunks do.

:data:`counted` counts the collectives issued — ``all_reduce``,
``all_gather`` and ``reduce_scatter``, each with its bytes by NCCL's
convention (the buffer for an all-reduce, the whole gathered output for an
all-gather, the whole input for a reduce-scatter) — on any backend; a
captured graph's replays add what its capture counted.
"""

from __future__ import annotations

import types
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..kernels.draws import draw_seed_words, fold_seed_words, seed_words_of

__all__ = ["MeshAxis", "all_gather_rows", "all_reduce_", "broadcast_",
           "counted", "gather_rows"]

# Newer torch names all_gather_into_tensor all_gather_single and
# reduce_scatter_tensor reduce_scatter_single (the same arguments) and warns
# on the old names; older torch has only the old ones.
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)

COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter")
counted = types.SimpleNamespace(**{
    k: 0 for name in COLLECTIVES for k in (name, f"{name}_bytes")})


def _count(name: str, t: torch.Tensor) -> None:
    setattr(counted, name, getattr(counted, name) + 1)
    key = f"{name}_bytes"
    setattr(counted, key, getattr(counted, key) + t.numel() * t.element_size())


def _via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns ``t``."""
    _count("all_reduce", t)
    if _via_host(t, group):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Overwrite ``t`` with global rank ``src``'s, in place."""
    if _via_host(t, group):
        host = t.detach().cpu()
        dist.broadcast(host, src, group=group)
        with torch.no_grad():
            t.copy_(host)
    else:
        dist.broadcast(t.detach(), src, group=group)
    return t


def gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` stacked along axis 0, in the group's rank order."""
    size = dist.get_world_size(group)
    src = t.contiguous()
    if _via_host(src, group):
        src = src.cpu()
    out = src.new_empty((size * src.shape[0],) + tuple(src.shape[1:]))
    _all_gather(out, src, group=group)
    _count("all_gather", out)
    return out.to(t.device)


class _AllGatherRows(torch.autograd.Function):
    """All-gather forward; its transpose, a reduce-scatter of the
    cotangent, backward: each rank's rows get the sum of every rank's
    cotangent for them."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return gather_rows(t, group)

    @staticmethod
    def backward(ctx, g):
        group = ctx.group
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        g = g.contiguous()
        rows = g.shape[0] // size
        _count("reduce_scatter", g)
        if dist.get_backend(group) == "gloo":
            # the whole cotangent summed over the ranks, then this rank's
            # rows: the reduce-scatter's result on any gloo build
            host = g.cpu() if g.is_cuda else g.clone()
            dist.all_reduce(host, group=group)
            return host[rank * rows:(rank + 1) * rows].to(g.device), None
        out = g.new_empty((rows,) + tuple(g.shape[1:]))
        _reduce_scatter(out, g, group=group)
        return out, None


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """:func:`gather_rows`, differentiable: every rank's ``t`` stacked
    along axis 0 in the group's rank order; in the backward each rank's
    ``t`` gets the sum over the ranks of the cotangent of its rows (a
    reduce-scatter; on gloo through the host), as JAX's ``all_gather``
    transposes to ``psum_scatter``.  Without a group: ``t``."""
    if group is None:
        return t
    return _AllGatherRows.apply(t, group)


class MeshAxis:
    """One named axis of a mesh, as this rank sees it: its process group,
    its size and this rank's index along it.  An axis the mesh lacks (or no
    mesh) has size 1, no group, and reduces nothing."""

    def __init__(self, mesh, name: str):
        names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
        self.name = name
        if mesh is None or name not in names:
            self.group, self.size, self.index = None, 1, 0
            return
        self.group = mesh.get_group(name)
        self.size = mesh.size(names.index(name))
        self.index = mesh.get_local_rank(name)

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)

    def fold(self, rng):
        """This shard's seed words: ``rng``'s (an int, two words, or two
        words drawn from a CPU generator) folded with the axis index —
        JAX's ``fold_in(rng, axis_index)``.  ``None`` stays ``None``."""
        if rng is None or self.group is None:
            return rng
        words = (draw_seed_words(rng) if isinstance(rng, torch.Generator)
                 else seed_words_of(rng))
        return fold_seed_words(words, self.index)

    def rows(self, x, axis: int = 0):
        """This shard's contiguous rows of ``x`` along ``axis`` (numpy or
        torch; a view)."""
        if self.size == 1:
            return x
        n = x.shape[axis]
        if n % self.size:
            raise ValueError(
                f"batch axis {axis} of size {n} is not divisible by mesh "
                f"axis {self.name!r} (size {self.size})"
            )
        per = n // self.size
        index = [slice(None)] * x.ndim
        index[axis] = slice(self.index * per, (self.index + 1) * per)
        return x[tuple(index)]

    def reduce(
        self,
        loss: torch.Tensor,
        info: Dict[str, Any],
        grads: Sequence[Optional[torch.Tensor]],
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], List[Optional[torch.Tensor]]]:
        """One all-reduce (sum) over one flat f32 buffer holding every
        gradient, the loss and the mean of every info entry; returns the
        summed loss and gradients and the info means averaged over the
        axis (JAX's ``psum`` of the ``1/size``-scaled loss and gradients,
        ``pmean`` of the info).  Without a group: the info means."""
        present = [g for g in grads if g is not None]
        flat = torch.cat(
            [g.detach().reshape(-1).float() for g in present]
            + [loss.detach().reshape(1).float()]
            + [torch.as_tensor(v).detach().float().mean().reshape(1)
               for v in info.values()]
        )
        if self.group is not None:
            all_reduce_(flat, self.group)
        out, offset = [], 0
        for g in grads:
            if g is None:
                out.append(None)
                continue
            out.append(flat[offset:offset + g.numel()].view(g.shape).to(g.dtype))
            offset += g.numel()
        loss = flat[offset]
        means = flat[offset + 1:] / self.size
        return loss, dict(zip(info.keys(), means.unbind())), out

    def gather(self, out):
        """Every shard's rows of ``out`` (a tensor, or a dict / tuple /
        list of them) concatenated along axis 0."""
        if self.group is None:
            return out
        if isinstance(out, dict):
            return {k: self.gather(v) for k, v in out.items()}
        if isinstance(out, (tuple, list)):
            return type(out)(self.gather(v) for v in out)
        return gather_rows(out, self.group)
