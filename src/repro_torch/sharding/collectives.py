"""The collectives of training on a mesh's data axes, over
``torch.distributed``.

This module stands in for what XLA's SPMD partitioner inserts for the
reference: there, ``jit`` with the rules' shardings (``sharding/rules.py``)
turns a batch split over ``pod`` x ``data`` into gradient all-reduces, and
an FSDP param split into all-gathers before use and reduce-scatters of its
gradient.  The port writes them out:

  * :class:`DataGroup` is the flattened ``pod`` x ``data`` group of a mesh
    whose other dims all have size 1 (a ``model`` dim of size > 1 is the
    model axis, ROADMAP.md queue 1 item 7d, and raises).  Its rank order is
    the batch's: the rank at ``(pod p, data d)`` is index ``p * n_data +
    d``, which holds rows ``[index * B / W, (index + 1) * B / W)``.
  * :func:`gather_param` is an ``autograd.Function``: its forward
    all-gathers a param's shard along the split dim, its backward
    reduce-scatters the whole gradient back to the shard.  The model calls
    it through ``sharding.ctx.gathered`` inside the block that remat wraps,
    so the recompute gathers again and no whole layer outlives its use.  K1
    and K3 (``autograd.Function``s too) only ever see whole local tensors.

Backends.  NCCL takes card tensors only, and every tensor this module
hands a group is the caller's (the state's device: the card for a card
run).  gloo (the CPU, or several ranks time-slicing one card, which NCCL
refuses) takes CUDA tensors through the host.  Both take every collective
used here: ``all_reduce`` (sum and max, bf16 included),
``all_gather_into_tensor`` and ``reduce_scatter_tensor`` (checked over
gloo with CUDA tensors on torch 2.11, and on the CPU on 2.13, which
renames the last two ``all_gather_single`` / ``reduce_scatter_single`` and
deprecates the old names: the new ones are taken where they exist).  The
sums run in each backend's order (gloo's, NCCL's ring), not XLA's.

Every call is counted (``DataGroup.counts``: calls and bytes by kind), so a
train step's collectives can be read off.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Dict, Optional, Tuple

import torch

from .rules import PartitionSpec, dp_axes, mesh_shape

__all__ = ["DataGroup", "gather_param"]

_MODEL_ITEM = ("a mesh dim other than the data axes with size > 1 is the "
               "model axis (tensor and sequence parallelism in training): "
               "ROADMAP.md queue 1 item 7d")

# flattened groups by (ranks, backend): new_group is a collective over the
# whole world, so a mesh's flattened group is built once a process
_FLAT_GROUPS: Dict[Tuple, object] = {}


class DataGroup:
    """The data-parallel group of ``mesh`` (module docstring): ``size``
    (W), this rank's ``index``, ``coordinate`` (axis -> index) and the
    process ``group`` (None when W is 1, where every collective is the
    identity)."""

    def __init__(self, mesh):
        import torch.distributed as dist
        sizes = mesh_shape(mesh)
        others = {a: s for a, s in sizes.items()
                  if a not in ("pod", "data") and s > 1}
        if others:
            raise NotImplementedError(f"training on {sizes}: {_MODEL_ITEM}")
        self.mesh = mesh
        self.axes = dp_axes(mesh)
        self.size = math.prod(sizes[a] for a in self.axes)
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not on the mesh")
        self.coordinate = dict(zip(sizes, coord))
        index = 0
        for a in self.axes:
            index = index * sizes[a] + self.coordinate[a]
        self.index = index
        self.counts: Counter = Counter()
        self.group = None
        if self.size > 1:
            wide = [a for a in self.axes if sizes[a] > 1]
            if len(wide) == 1:
                self.group = mesh.get_group(wide[0])
            else:
                ranks = [int(r) for r in mesh.mesh.flatten().tolist()]
                if ranks != sorted(ranks):
                    raise ValueError(f"the mesh's ranks {ranks} are not in "
                                     f"rank order")
                key = (tuple(ranks), dist.get_backend())
                if key not in _FLAT_GROUPS:
                    _FLAT_GROUPS[key] = dist.new_group(ranks)
                self.group = _FLAT_GROUPS[key]
            if dist.get_rank(self.group) != self.index:
                raise AssertionError(
                    f"group rank {dist.get_rank(self.group)} is not the data "
                    f"index {self.index}")

    # -- placement ----------------------------------------------------------
    def split_dim(self, spec: PartitionSpec) -> Optional[int]:
        """The tensor dim that ``spec`` splits over this group (axes of
        size 1 split nothing), or None for a whole (replicated) tensor."""
        sizes = mesh_shape(self.mesh)
        wide = tuple(a for a in self.axes if sizes[a] > 1)
        found = None
        for d, entry in enumerate(spec):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else tuple(entry))
            axes = tuple(a for a in axes if sizes[a] > 1)
            if not axes:
                continue
            if axes != wide or found is not None:
                raise NotImplementedError(
                    f"spec {spec} on {sizes}: only a split of one dim over "
                    f"every data axis is a data-parallel placement; "
                    f"{_MODEL_ITEM}")
            found = d
        return found

    # -- collectives ----------------------------------------------------------
    def _count(self, kind: str, t: torch.Tensor) -> None:
        self.counts[kind] += 1
        self.counts[f"{kind}_bytes"] += t.numel() * t.element_size()

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` summed (or maxed) over the group, in place."""
        import torch.distributed as dist
        if self.size == 1:
            return t
        self._count("all_reduce", t)
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op],
                        group=self.group)
        return t

    def all_gather(self, local: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole tensor whose ``dim`` the group's shards split, in
        index order."""
        import torch.distributed as dist
        if self.size == 1:
            return local
        shape = list(local.shape)
        shape[dim] *= self.size
        # the shards concatenated along dim 0 (gloo takes no stacked form)
        out = torch.empty((self.size * local.shape[0],)
                          + tuple(local.shape[1:]), dtype=local.dtype,
                          device=local.device)
        self._count("all_gather", out)
        gather = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
        gather(out, local.contiguous(), group=self.group)
        if dim == 0:
            return out
        return out.unflatten(0, (self.size, local.shape[0])) \
            .movedim(0, dim).reshape(shape)

    def reduce_scatter(self, full: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's shard (along ``dim``) of ``full`` summed over the
        group."""
        import torch.distributed as dist
        if self.size == 1:
            return full
        n = full.shape[dim] // self.size
        # the rank's chunks concatenated along dim 0
        chunks = full.unflatten(dim, (self.size, n)).movedim(dim, 0)
        out = torch.empty(chunks.shape[1:], dtype=full.dtype,
                          device=full.device)
        chunks = chunks.reshape((-1,) + tuple(out.shape[1:]))
        self._count("reduce_scatter", chunks)
        scatter = getattr(dist, "reduce_scatter_single", None) or \
            dist.reduce_scatter_tensor
        scatter(out, chunks, group=self.group)
        return out

    def broadcast_object(self, obj):
        """``obj`` from the group's index 0."""
        import torch.distributed as dist
        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(
            box, src=dist.get_global_rank(self.group, 0), group=self.group)
        return box[0]


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, group: DataGroup, dim: int):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(local, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.reduce_scatter(grad, ctx.dim), None, None


def gather_param(local: torch.Tensor, group: DataGroup,
                 dim: Optional[int]) -> torch.Tensor:
    """The whole param of the shard ``local`` (split along ``dim``; None:
    already whole), differentiable: its gradient comes back
    reduce-scattered to the shard."""
    if dim is None or group.size == 1:
        return local
    return _Gather.apply(local, group, dim)

