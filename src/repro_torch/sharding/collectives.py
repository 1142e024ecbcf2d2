"""The collectives of training on a mesh, over ``torch.distributed``.

This module stands in for what XLA's SPMD partitioner inserts for the
reference: there, ``jit`` with the rules' shardings (``sharding/rules.py``)
turns a batch split over ``pod`` x ``data`` into gradient all-reduces, an
FSDP param split into all-gathers before use and reduce-scatters of its
gradient, and the ``model`` axis's splits (heads, ff, vocab, the sequence
between blocks) into Megatron's tensor- and sequence-parallel collectives.
The port writes them out:

  * :class:`DataGroup` is the data group of this rank's ``model``
    coordinate: the ranks that share it, flattened over ``pod`` x
    ``data``.  Its rank order is the batch's: the rank at ``(pod p, data
    d)`` is index ``p * n_data + d``, which holds rows ``[index * B / W,
    (index + 1) * B / W)``.
  * :class:`ModelGroup` is the ``model`` axis's group of this rank's
    ``pod`` x ``data`` coordinate; :class:`WorldGroup` every rank of the
    mesh (the step's one reduction of the loss and the norm's squares).
  * :func:`gather_param` is an ``autograd.Function``: its forward
    all-gathers a tensor's shard along a dim, its backward reduce-scatters
    the whole gradient back to the shard.  FSDP gathers each param with it
    over the data group (``sharding.ctx.gathered``, inside the block that
    remat wraps, so the recompute gathers again); over the model group it
    is also SP's entry (the sequence all-gathered before the column-
    parallel projections).
  * The other Megatron pairs, each an ``autograd.Function`` on one group:
    :func:`copy_to` (identity forward, all-reduce backward: the entry of a
    column-parallel layer on a replicated input, and any replicated param
    used on this rank's part of the work), :func:`reduce_from` (all-reduce
    forward, identity backward: the exit of a row-parallel layer without
    SP), :func:`scatter` (reduce-scatter forward, all-gather backward: the
    exit into SP) and :func:`gather_replicated` (all-gather forward, this
    rank's piece of the gradient backward, no collective: a split param
    used on replicated work, whose gradient every rank already holds
    whole) and :func:`all_sum` (all-reduce both ways: a sum over the
    ranks' heads that every rank goes on to use for its own heads, such
    as mamba2's gated norm's squares).  K1 and K3
    (``autograd.Function``s too) only ever see whole local tensors.
  * Expert parallelism's exchange (``models.moe_ep``): :func:`all_to_all`
    (its backward the all-to-all back) and :func:`all_mean` (the mean
    over a group whose backward is the mean of the cotangents, the
    transpose of the reference's ``pmean``), both on
    :class:`ExpertParallel`'s groups.
  * :func:`splits` gives, for a spec, the dim each group splits.
  * A serving step's recurrent state (:class:`StateMove`): the cache
    holds each state leaf in the rules' layout (``rules.state_slice``),
    the mixers read and write it in their own (the rank's batch rows and
    heads); each layer's state moves in and back out over the data and
    model groups.

Backends.  NCCL takes card tensors only, and every tensor this module
hands a group is the caller's (the state's device: the card for a card
run).  gloo (the CPU, or several ranks time-slicing one card, which NCCL
refuses) takes CUDA tensors through the host.  Both take every collective
used here: ``all_reduce`` (sum and max, bf16 included),
``all_gather_into_tensor`` and ``reduce_scatter_tensor`` (checked over
gloo with CUDA tensors on torch 2.11, and on the CPU on 2.13, which
renames the last two ``all_gather_single`` / ``reduce_scatter_single`` and
deprecates the old names: the new ones are taken where they exist), and
``all_to_all_single`` (gloo on the CPU on 2.13; gloo with CUDA tensors on
2.11 is checked by chip_smoke phase 18d).  The sums run in each backend's
order (gloo's, NCCL's ring), not XLA's.

Every call is counted (each group's ``counts``: calls and bytes by kind),
so a train step's collectives can be read off group by group, and told to
a running op count (``analysis.hlo_counter.collective``: its result's
bytes).  On a :class:`CountingMesh` (a mesh descriptor with no process
group) the groups count their collectives and return tensors of the
right shape with no exchange: the dry run counts one rank's step on the
``meta`` device with them (``launch.dryrun``).
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Optional, Tuple

import torch

from ..analysis import hlo_counter
from .rules import PartitionSpec, dp_axes, mesh_shape

__all__ = ["DataGroup", "ModelGroup", "WorldGroup", "ExpertParallel",
           "CountingMesh", "StateMove",
           "splits", "gather_param", "copy_to", "reduce_from", "scatter",
           "gather_replicated", "all_sum", "all_to_all", "all_mean"]

# flattened groups by (ranks, backend): new_group is a collective over the
# whole world, so each group is built once a process
_FLAT_GROUPS: Dict[Tuple, object] = {}


def _entry_axes(entry) -> Tuple[str, ...]:
    return () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


def splits(mesh, spec: PartitionSpec) -> Dict[str, Optional[int]]:
    """``{"data": dim, "model": dim}``: the tensor dim that ``spec``
    splits over the data axes (``pod`` x ``data``) and the one it splits
    over ``model`` (axes of size 1 split nothing), None for whole.  A dim
    split over both, a split over some data axes but not all, and an axis
    the port does not know raise."""
    sizes = mesh_shape(mesh)
    dp = tuple(a for a in dp_axes(mesh) if sizes[a] > 1)
    out: Dict[str, Optional[int]] = {"data": None, "model": None}
    for d, entry in enumerate(spec):
        axes = tuple(a for a in _entry_axes(entry) if sizes[a] > 1)
        if not axes:
            continue
        unknown = [a for a in axes if a not in ("pod", "data", "model")]
        if unknown:
            raise ValueError(f"spec {spec} on {sizes}: axes {unknown} are "
                             f"neither data axes nor 'model'")
        if "model" in axes:
            if axes != ("model",):
                raise NotImplementedError(
                    f"spec {spec} on {sizes}: dim {d} split over the data "
                    f"and the model axes at once (no rule gives it)")
            kind = "model"
        else:
            if axes != dp:
                raise NotImplementedError(
                    f"spec {spec} on {sizes}: only a split over every wide "
                    f"data axis {dp} is a data-parallel placement")
            kind = "data"
        if out[kind] is not None:
            raise NotImplementedError(f"spec {spec} on {sizes}: two dims "
                                      f"split over the {kind} axes")
        out[kind] = d
    return out


def _axis_group(mesh, axes: Tuple[str, ...]):
    """The process group of this rank's line through ``mesh`` along
    ``axes`` (flattened, the first axis major), or None for one rank.
    Every rank builds every line's group (``new_group`` is collective)."""
    import torch.distributed as dist
    sizes = mesh_shape(mesh)
    wide = [a for a in axes if sizes[a] > 1]
    if not wide:
        return None
    if len(wide) == 1:
        return mesh.get_group(wide[0])
    names = list(sizes)
    grid = mesh.mesh
    # the mesh's dims: those of ``wide`` last, in order; one line per
    # coordinate of the others
    others = [a for a in names if a not in wide]
    order = [names.index(a) for a in others + wide]
    lines = grid.permute(order).reshape(
        -1, math.prod(sizes[a] for a in wide))
    me, mine = dist.get_rank(), None
    for line in lines.tolist():
        ranks = [int(r) for r in line]
        if ranks != sorted(ranks):
            raise ValueError(f"the mesh's ranks {ranks} along {wide} are "
                             f"not in rank order")
        if ranks == list(range(dist.get_world_size())):
            return dist.group.WORLD
        key = (tuple(ranks), dist.get_backend())
        if key not in _FLAT_GROUPS:
            _FLAT_GROUPS[key] = dist.new_group(ranks)
        if me in ranks:
            mine = _FLAT_GROUPS[key]
    return mine


class CountingMesh:
    """A mesh descriptor standing in for a ``DeviceMesh`` with no process
    group: axis sizes ``sizes`` (name -> size, in mesh order) and the
    coordinate of the rank it stands for (rank 0's by default).  Groups
    built on it count their collectives and exchange nothing: a
    collective returns a tensor of its result's shape whose values are
    unset (on the ``meta`` device, none)."""

    counting = True

    def __init__(self, sizes: Dict[str, int],
                 coordinate: Optional[Dict[str, int]] = None):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(int(s) for s in sizes.values())
        coordinate = coordinate or {}
        self._coordinate = [int(coordinate.get(a, 0)) for a in sizes]

    def get_coordinate(self):
        return list(self._coordinate)


class _Group:
    """One group of a mesh's ranks: ``size``, this rank's ``index``,
    ``coordinate`` (axis -> index on the mesh), the process ``group`` (None
    when ``size`` is 1, where every collective is the identity, or on a
    :class:`CountingMesh`, where a collective only counts) and ``counts``
    (calls and bytes by kind)."""

    def __init__(self, mesh, axes: Tuple[str, ...]):
        import torch.distributed as dist
        sizes = mesh_shape(mesh)
        self.mesh = mesh
        self.axes = tuple(a for a in axes if a in sizes)
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
        self.counting = getattr(mesh, "counting", False)
        self.group = _axis_group(mesh, self.axes) \
            if self.size > 1 and not self.counting else None
        if self.group is not None and dist.get_rank(self.group) != self.index:
            raise AssertionError(
                f"group rank {dist.get_rank(self.group)} is not the index "
                f"{self.index} along {self.axes}")

    # -- collectives ----------------------------------------------------------
    def _count(self, kind: str, t: torch.Tensor,
               result: Optional[torch.Tensor] = None) -> None:
        self.counts[kind] += 1
        self.counts[f"{kind}_bytes"] += t.numel() * t.element_size()
        r = t if result is None else result
        hlo_counter.collective(kind, r.numel() * r.element_size())

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` summed (or maxed) over the group, in place."""
        import torch.distributed as dist
        if self.size == 1:
            return t
        self._count("all_reduce", t)
        if self.counting:
            return t
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
        if not self.counting:
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
        self._count("reduce_scatter", chunks, out)
        if not self.counting:
            scatter = getattr(dist, "reduce_scatter_single", None) or \
                dist.reduce_scatter_tensor
            scatter(out, chunks, group=self.group)
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (size, ...) exchanged: block ``i`` goes to index ``i``,
        and block ``i`` of the result came from index ``i``."""
        import torch.distributed as dist
        if self.size == 1:
            return t
        send = t.contiguous()
        out = torch.empty_like(send)
        self._count("all_to_all", send)
        if not self.counting:
            dist.all_to_all_single(out, send, group=self.group)
        return out

    def piece(self, full: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's shard of ``full`` along ``dim`` (no collective)."""
        n = full.shape[dim] // self.size
        return full.narrow(dim, self.index * n, n)

    def broadcast_object(self, obj):
        """``obj`` from the group's index 0."""
        import torch.distributed as dist
        if self.size == 1 or self.counting:
            return obj
        box = [obj]
        dist.broadcast_object_list(
            box, src=dist.get_global_rank(self.group, 0), group=self.group)
        return box[0]


class DataGroup(_Group):
    """The data group of ``mesh`` for this rank's ``model`` coordinate: its
    ``pod`` x ``data`` ranks, flattened (module docstring)."""

    def __init__(self, mesh):
        super().__init__(mesh, dp_axes(mesh))

    def split_dim(self, spec: PartitionSpec) -> Optional[int]:
        """The tensor dim ``spec`` splits over the data axes, or None."""
        return splits(self.mesh, spec)["data"]


class ModelGroup(_Group):
    """The ``model`` axis's group of this rank's ``pod`` x ``data``
    coordinate (size 1 where the mesh has no ``model`` axis)."""

    def __init__(self, mesh):
        super().__init__(mesh, ("model",))

    def split_dim(self, spec: PartitionSpec) -> Optional[int]:
        """The tensor dim ``spec`` splits over ``model``, or None."""
        return splits(self.mesh, spec)["model"]


class WorldGroup(_Group):
    """Every rank of ``mesh``, in the mesh's order."""

    def __init__(self, mesh):
        super().__init__(mesh, tuple(mesh_shape(mesh)))


# ---------------------------------------------------------------------------
# autograd pairs
# ---------------------------------------------------------------------------

class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, group: _Group, dim: int):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(local, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.reduce_scatter(grad, ctx.dim), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, full, group: _Group, dim: int):
        ctx.group, ctx.dim = group, dim
        return group.reduce_scatter(full, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_gather(grad, ctx.dim), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group: _Group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce_(grad.contiguous().clone()), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group: _Group):
        return group.all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group: _Group):
        ctx.group = group
        return group.all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce_(grad.contiguous().clone()), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group: _Group):
        ctx.group = group
        return group.all_to_all(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_to_all(grad), None


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group: _Group):
        ctx.group = group
        return group.all_reduce_(x.contiguous().clone()) / group.size

    @staticmethod
    def backward(ctx, grad):
        return (ctx.group.all_reduce_(grad.contiguous().clone())
                / ctx.group.size), None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, group: _Group, dim: int):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(local, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.piece(grad, ctx.dim).contiguous(), None, None


def gather_param(local: torch.Tensor, group: _Group,
                 dim: Optional[int]) -> torch.Tensor:
    """The whole tensor of the shard ``local`` (split along ``dim`` over
    ``group``; None: already whole), differentiable: its gradient comes
    back reduce-scattered to the shard, summed over the group."""
    if dim is None or group.size == 1:
        return local
    return _Gather.apply(local, group, dim)


def scatter(full: torch.Tensor, group: _Group, dim: int) -> torch.Tensor:
    """This rank's shard along ``dim`` of ``full`` summed over ``group``;
    its gradient comes back all-gathered."""
    if group.size == 1:
        return full
    return _Scatter.apply(full, group, dim)


def copy_to(x: torch.Tensor, group: _Group) -> torch.Tensor:
    """``x`` itself, whose gradient is summed over ``group``."""
    if group.size == 1:
        return x
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group: _Group) -> torch.Tensor:
    """``x`` summed over ``group``; its gradient passes unchanged."""
    if group.size == 1:
        return x
    return _ReduceFrom.apply(x, group)


def gather_replicated(local: torch.Tensor, group: _Group,
                      dim: Optional[int]) -> torch.Tensor:
    """The whole tensor of the shard ``local`` for work every rank of
    ``group`` repeats: its gradient, whole and the same on every rank, is
    cut back to this rank's piece with no collective."""
    if dim is None or group.size == 1:
        return local
    return _GatherReplicated.apply(local, group, dim)


def all_sum(x: torch.Tensor, group: _Group) -> torch.Tensor:
    """``x`` summed over ``group``, where each rank goes on to use the sum
    for work of its own: its gradient is the sum of every rank's."""
    if group.size == 1:
        return x
    return _AllSum.apply(x, group)


def all_to_all(x: torch.Tensor, group: _Group) -> torch.Tensor:
    """``x`` (group.size, ...) exchanged over ``group`` (block ``i`` to
    index ``i``); its gradient goes back by the same exchange."""
    if group.size == 1:
        return x
    return _AllToAll.apply(x, group)


def all_mean(x: torch.Tensor, group: _Group) -> torch.Tensor:
    """The mean of ``x`` over ``group``, the same on every rank; its
    gradient is the mean of every rank's (the reference's ``pmean``)."""
    if group.size == 1:
        return x
    return _Mean.apply(x, group)


class ExpertParallel:
    """The groups a MoE layer of a sharded train step uses (set for the
    step through ``sharding.ctx.expert_parallel``): ``model``, the
    :class:`ModelGroup` whose ranks hold the experts and exchange tokens
    (``models.moe_ep``), and ``data``, the :class:`DataGroup` over which
    ``models.ffn.moe`` averages its routing statistics where the mesh has
    no ``model`` axis."""

    def __init__(self, data: DataGroup, model: ModelGroup):
        self.data, self.model = data, model

    def data_mean(self, t: torch.Tensor) -> torch.Tensor:
        return all_mean(t, self.data)

    def model_mean(self, t: torch.Tensor) -> torch.Tensor:
        return all_mean(t, self.model)


def chunk_bounds(n: int, parts: int) -> List[Tuple[int, int]]:
    """``[lo, hi)`` of each of ``parts`` pieces of ``n``, as
    ``torch.tensor_split`` cuts: equal where ``parts`` divides ``n``, else
    the first ``n % parts`` one longer."""
    q, r = divmod(n, parts)
    return [(i * q + min(i, r), (i + 1) * q + min(i + 1, r))
            for i in range(parts)]


def _chunk(n: int, parts: int, index: int) -> Tuple[int, int]:
    """``[lo, hi)`` of piece ``index`` of ``n`` cut in ``parts`` even
    pieces."""
    k = n // parts
    return index * k, (index + 1) * k


def _merged(ranges: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Adjacent ranges joined: [(0, 2), (2, 4)] -> [(0, 4)]."""
    out: List[Tuple[int, int]] = []
    for lo, hi in ranges:
        if out and out[-1][1] == lo:
            out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


def take(t: torch.Tensor, held, want) -> torch.Tensor:
    """The part ``want`` of ``t`` (per dim, the ranges of the global dim
    to keep, concatenated in order), where ``t`` holds ``held`` (per dim,
    the ranges of the global dim its entries are, in order; a range may
    come twice, as where ranks that hold the same columns were
    gathered)."""
    for d, (h, w) in enumerate(zip(held, want)):
        h, w = _merged(h), _merged(w)
        if h == w:
            continue
        parts = []
        for lo, hi in w:
            at = lo
            while at < hi:
                off = 0
                for a, b in h:
                    if a <= at < b:
                        n = min(b, hi) - at
                        parts.append(t.narrow(d, off + at - a, n))
                        at += n
                        break
                    off += b - a
                else:
                    raise ValueError(f"dim {d}: {(lo, hi)} is not in {h}")
        t = parts[0] if len(parts) == 1 else torch.cat(parts, d)
    return t


class StateMove:
    """One recurrent state leaf of a serving step on a mesh, moved between
    the rules' piece (the cache at rest: ``rules.state_slice``) and the
    mixer's (what ``models.rwkv6`` / ``models.mamba2`` read and write on a
    model axis), a unit at a time: one layer's state for rwkv6 (b, ...),
    one group's for the hybrid (E, b, ...).

    ``spec`` and ``shape`` are the unit's (the leaf's without its leading
    layer dim), ``batch`` its batch dim, ``rows_split`` whether the step's
    tokens are split over the data group (each rank its rows; else every
    rank runs every row), ``mixer(r)`` the mixer's piece at model index
    ``r``: ``(dim, ranges)`` of the one dim it cuts by the rank (its heads,
    or the conv tail's columns of its heads and ``B | C``), or None where
    every rank reads the unit whole (its rows aside).

    :meth:`enter`: a data split of the rules that is not the tokens' rows
    (a layer dim, or nothing while the tokens are split) is gathered over
    the data group; over ``model``, where the rules and the mixer cut
    different dims in even chunks, one all-to-all moves the rank's piece
    (the rules' chunk of one dim becomes the mixer's chunk of the other),
    else the rules' dim is gathered whole; then the mixer's piece is cut
    out.  :meth:`exit` runs the other way: where the rules hold every row
    and the tokens are split, the new rows are gathered over the data
    group (else the ranks' copies would part); the all-to-all back, or the
    mixer's pieces gathered over ``model``; then the rules' piece is cut
    out and copied into the cache.  Every collective is the groups',
    counted with the others."""

    def __init__(self, data: _Group, model: _Group, spec: PartitionSpec,
                 shape, batch: int, rows_split: bool, mixer):
        self.data, self.model = data, model
        self.shape, self.batch = tuple(shape), batch
        self.rows_split = rows_split and data.size > 1
        split = splits(model.mesh, spec)
        self.rd, self.rm = split["data"], split["model"]
        self.mixer = mixer
        mine = mixer(model.index) if model.size > 1 else None
        self.mm = None if mine is None else mine[0]
        # the mixer cuts its dim in even chunks by the model index
        self.even = mine is not None and all(
            mixer(r)[1] == [_chunk(self.shape[self.mm], model.size, r)]
            for r in range(model.size))

    def _whole(self, d: int):
        return [(0, self.shape[d])]

    def _rules(self):
        held = [self._whole(d) for d in range(len(self.shape))]
        if self.rd is not None:
            held[self.rd] = [_chunk(self.shape[self.rd], self.data.size,
                                    self.data.index)]
        if self.rm is not None:
            held[self.rm] = [_chunk(self.shape[self.rm], self.model.size,
                                    self.model.index)]
        return held

    def _mixer(self):
        held = [self._whole(d) for d in range(len(self.shape))]
        if self.rows_split:
            held[self.batch] = [_chunk(self.shape[self.batch],
                                       self.data.size, self.data.index)]
        if self.mm is not None:
            held[self.mm] = list(self.mixer(self.model.index)[1])
        return held

    def _exchange(self, t: torch.Tensor, split: int, cat: int
                  ) -> torch.Tensor:
        """``t`` cut in ``model.size`` chunks along ``split``, chunk ``i``
        sent to index ``i``, and what came back joined along ``cat`` in
        index order."""
        m = self.model.size
        x = t.unflatten(split, (m, t.shape[split] // m)).movedim(split, 0)
        return self.model.all_to_all(x).movedim(0, cat).flatten(cat, cat + 1)

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's rules piece ``t`` of a unit -> its mixer's piece."""
        with hlo_counter.tagged("state_move"):
            return self._enter(t)

    def exit(self, new: torch.Tensor, dst: torch.Tensor) -> None:
        """The mixer's new piece ``new`` of a unit -> the rank's rules
        piece, copied into ``dst`` (the cache's view)."""
        with hlo_counter.tagged("state_move"):
            self._exit(new, dst)

    def _enter(self, t: torch.Tensor) -> torch.Tensor:
        held = self._rules()
        if self.rd is not None and not (self.rd == self.batch
                                        and self.rows_split):
            t = self.data.all_gather(t, self.rd)
            held[self.rd] = self._whole(self.rd)
        if self.rm is not None and not (self.even and self.mm == self.rm):
            if self.even and held[self.mm] == self._whole(self.mm):
                t = self._exchange(t, self.mm, self.rm)
                held[self.mm] = [_chunk(self.shape[self.mm], self.model.size,
                                        self.model.index)]
            else:
                t = self.model.all_gather(t, self.rm)
            held[self.rm] = self._whole(self.rm)
        return take(t, held, self._mixer())

    def _exit(self, new: torch.Tensor, dst: torch.Tensor) -> None:
        held = self._mixer()
        if self.rows_split and self.rd != self.batch:
            new = self.data.all_gather(new, self.batch)
            held[self.batch] = self._whole(self.batch)
        if self.mm is not None and not (self.even and self.rm == self.mm):
            if self.even and self.rm is not None and \
                    held[self.rm] == self._whole(self.rm):
                new = self._exchange(new, self.rm, self.mm)
                held[self.rm] = [_chunk(self.shape[self.rm], self.model.size,
                                        self.model.index)]
                held[self.mm] = self._whole(self.mm)
            else:
                new = self.model.all_gather(new, self.mm)
                held[self.mm] = [rg for r in range(self.model.size)
                                 for rg in self.mixer(r)[1]]
        dst.copy_(take(new, held, self._rules()))


# ---------------------------------------------------------------------------
# the model axis as the model uses it
# ---------------------------------------------------------------------------

# the head dim of the recurrent mixers (``models.rwkv6.HD``,
# ``models.mamba2.HD``)
MIXER_HD = 64


def mixer_heads(cfg) -> int:
    """The heads of a recurrent family's mixer: rwkv6's ``d_model / 64``,
    mamba2's ``din / 64`` (``din = 2 d_model``); 0 for the transformer
    families."""
    if cfg.family == "ssm":
        return cfg.d_model // MIXER_HD
    if cfg.family == "hybrid":
        return 2 * cfg.d_model // MIXER_HD
    return 0


def check_model_axis(cfg, mesh, mixer: bool = False) -> bool:
    """Whether the model axis of ``mesh`` gives each rank whole heads for
    K3: ``model`` divides ``n_heads`` and a rank's query heads read whole
    kv heads of their own (its heads a multiple of the GQA group, or a
    divisor of it).  Where it does not (qwen1.5-32b's 40 heads on the
    production meshes' ``model=16``), :class:`TensorParallel` runs the
    attention whole on every rank: the rules still split its weights as
    the reference's (2.5 heads of columns a rank), and the step gathers
    them whole where used.  With ``mixer``, the same question for the
    recurrent mixer's heads (:func:`mixer_heads`: rwkv6's time-mix,
    mamba2): ``model`` must divide them, else the mixer runs whole on
    every rank."""
    m = mesh_shape(mesh).get("model", 1)
    if m == 1:
        return True
    if mixer:
        return mixer_heads(cfg) % m == 0
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    if nh % m:
        return False
    local, group = nh // m, nh // nkv
    return not (local % group and group % local)


class TensorParallel:
    """The model axis of one train step, as ``repro_torch.models`` uses it
    (Megatron's tensor parallelism, and SP where ``model`` divides the
    sequence).  ``group`` is the :class:`ModelGroup`; ``dims`` the model
    split dim of each param by the rules' path (``"blocks/attn/wq"``;
    None: whole over ``model``); ``seq`` the global sequence length of the
    step's batch.

    Between blocks a rank holds its sequence rows ``rows`` (``sp``: the
    reference's split, ``seq / size`` each) or, with SP off, the whole
    sequence, every rank the same.  Inside a block it computes its query
    heads ``q_cols`` (columns of ``wq``), the kv heads they read
    ``kv_cols`` and its ff columns ``ff_cols``.  The loss is taken on its
    ``rows`` in either case.  Each param arrives through one of
    :meth:`part`, :meth:`whole` or :meth:`norm_weight`, which gather what
    the rank's storage lacks and sum its gradient where this rank's work
    gives only a share of it.

    The recurrent families' mixers (``models.rwkv6``, ``models.mamba2``)
    split by their own heads of 64 (:func:`mixer_heads`): the rank's
    ``mixer_heads`` ``[h0, h1)`` and their columns ``mixer_cols`` (of
    rwkv6's ``d_model``, of mamba2's ``din``), where ``model`` divides
    them (``split_mixer``), else the mixer runs whole on every rank.
    :meth:`mamba_columns` gives the per-segment column ranges of mamba2's
    ``w_in`` (``z | x | B | C | dt``) and ``conv_w`` (``x | B | C``).

    A serving step (``Model.prefill`` of ``seq`` tokens, or
    ``Model.decode_step``: ``seq`` 1, so SP is never on) also gives ``kv``,
    what the rank holds of the layer-stacked KV cache under
    ``rules.cache_specs`` (``rules.kv_slice``: its ``rows``, positions
    ``pos``, kv ``heads`` and ``layout``).  Where ``model`` splits the kv
    heads (``layout == "heads"``) they are the kv heads the rank's query
    heads read, and it writes and reads them alone; where it splits the
    positions (``"seq"``) the rank holds every kv head of its positions,
    and a decode step merges each rank's partial attention over ``model``
    (``models.attention``).  The recurrent families' serving step also
    gives ``state`` (``rules.state_slice``) and the ``data`` group: each
    state leaf's :class:`StateMove` (``self.state``), through which the
    model moves a layer's state into the mixer's piece
    (:meth:`state_in`) and back into the cache (:meth:`state_out`)."""

    def __init__(self, group: ModelGroup, dims: Dict[str, Optional[int]],
                 cfg, seq: int, kv: Optional[Dict] = None,
                 state: Optional[Dict] = None,
                 data: Optional[DataGroup] = None):
        m, r = group.size, group.index
        self.group, self.dims, self.seq, self.kv = group, dims, seq, kv
        self.sp = seq % m == 0
        self.rows = chunk_bounds(seq, m)[r]
        hd, local = cfg.hd, cfg.n_heads // m
        first = r * local
        kv_group = max(cfg.n_heads // max(cfg.n_kv_heads, 1), 1)
        k0, k1 = first // kv_group, (first + local - 1) // kv_group + 1
        self.q_cols = (first * hd, (first + local) * hd)
        self.kv_cols = (k0 * hd, k1 * hd)
        self.ff_cols = chunk_bounds(cfg.d_ff, m)[r]
        self.split_heads = check_model_axis(cfg, {"model": m})
        # each kv head's place among the kv heads gathered over model (every
        # rank's (k0, k1) in rank order): the first rank that computes it
        per = k1 - k0
        self.kv_pick = [min(i * per + h - (i * local) // kv_group
                            for i in range(m)
                            if (i * local) // kv_group <= h
                            < (i * local) // kv_group + per)
                        for h in range(cfg.n_kv_heads)] \
            if self.split_heads else []
        mh = mixer_heads(cfg)
        self.split_mixer = check_model_axis(cfg, {"model": m}, mixer=True)
        h0, h1 = (r * mh // m, (r + 1) * mh // m) if self.split_mixer \
            else (0, mh)
        self.mixer_heads = (h0, h1)
        self.mixer_cols = (h0 * MIXER_HD, h1 * MIXER_HD)
        self.state = {name: self._state_move(cfg, name, info, data)
                      for name, info in (state or {}).items()}

    def _state_move(self, cfg, name: str, info: Dict, data) -> StateMove:
        """The :class:`StateMove` of the state leaf ``name`` (its
        ``rules.state_slice`` entry): the mixers' pieces are rwkv6's
        ``wkv`` and mamba2's ``ssm`` on the rank's heads, the conv tail on
        the columns of its heads and ``B | C`` whole (:meth:`
        mamba_columns`' ``conv_w`` ranges), the token shifts whole (the
        lerps read every column)."""
        m, mh = self.group.size, mixer_heads(cfg)
        shape, spec = info["shape"][1:], PartitionSpec(*info["spec"][1:])
        batch = 1 if name.startswith("mamba/") else 0

        def heads(r):
            return (r * mh // m, (r + 1) * mh // m)
        if not self.split_mixer or name in ("tshift", "cshift"):
            mixer = lambda r: None  # noqa: E731
        elif name == "mamba/conv":
            din, n = 2 * cfg.d_model, cfg.ssm_state
            mixer = lambda r: (len(shape) - 1, [  # noqa: E731
                (heads(r)[0] * MIXER_HD, heads(r)[1] * MIXER_HD),
                (din, din + 2 * n)])
        else:               # wkv (b, nh, ...), mamba/ssm (E, b, nh, ...)
            mixer = lambda r: (batch + 1, [heads(r)])  # noqa: E731
        return StateMove(data, self.group, spec, shape, batch,
                         shape[batch] % data.size == 0, mixer)

    def state_in(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The rank's rules piece ``t`` of state leaf ``name`` (a layer's,
        or a hybrid group's) -> the piece its mixer reads."""
        return self.state[name].enter(t)

    def state_out(self, name: str, new: torch.Tensor,
                  dst: torch.Tensor) -> None:
        """The mixer's new piece of state leaf ``name`` -> the rank's rules
        piece, written into ``dst``."""
        self.state[name].exit(new, dst)

    def mamba_columns(self, cfg) -> Dict[str, List[Tuple[int, int]]]:
        """The column ranges of mamba2's ``w_in`` and ``conv_w`` that the
        rank's heads read, in the layout's order: ``w_in``'s ``z``, ``x``
        (its heads), ``B | C`` (whole) and ``dt`` (its heads); ``conv_w``'s
        ``x`` and ``B | C``."""
        din, n = 2 * cfg.d_model, cfg.ssm_state
        (c0, c1), (h0, h1) = self.mixer_cols, self.mixer_heads
        bc = (din, din + 2 * n)
        return {"w_in": [(c0, c1), (din + c0, din + c1),
                         (din + bc[0], din + bc[1]),
                         (2 * din + 2 * n + h0, 2 * din + 2 * n + h1)],
                "conv_w": [(c0, c1), bc]}

    # -- params -------------------------------------------------------------
    def part(self, t: torch.Tensor, path: str, dim: int,
             bounds: Tuple[int, int]) -> torch.Tensor:
        """``[lo, hi)`` along ``dim`` of the whole param ``path`` from this
        rank's stored piece ``t``: ``t`` itself where it is that piece,
        else cut from ``t`` gathered over ``model`` (its gradient summed
        back to each rank's piece) or from ``t`` whole (its gradient
        summed over ``model``)."""
        lo, hi = bounds
        d = self.dims[path]
        if d == dim and t.shape[dim] == hi - lo and \
                self.group.index * (hi - lo) == lo:
            return t
        t = self.whole(t, path)
        return t if (lo, hi) == (0, t.shape[dim]) else \
            t.narrow(dim, lo, hi - lo)

    def whole(self, t: torch.Tensor, path: str) -> torch.Tensor:
        """The whole param ``path`` for this rank's share of the work: its
        gradient is summed over ``model``."""
        d = self.dims[path]
        return copy_to(t, self.group) if d is None else \
            gather_param(t, self.group, d)

    def norm_weight(self, t: torch.Tensor, path: str) -> torch.Tensor:
        """A whole param used on the rank's rows (a block norm's weight,
        rwkv6's channel-mix gate): as :meth:`whole` under SP (the rank
        works on its rows); with SP off every rank works on the whole
        sequence, so its gradient is already whole on every rank and is
        not summed."""
        if self.sp:
            return self.whole(t, path)
        return gather_replicated(t, self.group, self.dims[path])

    def columns(self, t: torch.Tensor, path: str, dim: int,
                ranges: List[Tuple[int, int]]) -> torch.Tensor:
        """The whole param ``path`` (for this rank's share of the work)
        cut to ``ranges`` along ``dim``, concatenated in order: one gather
        whatever the rules' pieces straddle."""
        t = self.whole(t, path)
        return torch.cat([t.narrow(dim, lo, hi - lo) for lo, hi in ranges],
                         dim=dim)

    def mixer_take(self, path: str):
        """How a mixer that runs whole on every rank (``split_mixer``
        false, or attention without ``split_heads``) takes a param: under
        SP each rank's share is its rows' outputs (:meth:`whole`, the
        gradient summed), with SP off every rank repeats the whole work
        (:meth:`replicated`)."""
        take = self.whole if self.sp else self.replicated
        return lambda t, name: None if t is None else take(
            t, f"{path}/{name}")

    def whole_mixer(self, fn, x: torch.Tensor) -> torch.Tensor:
        """``fn(x whole)`` for a mixer every rank runs whole: the sequence
        gathered under SP and the rank's rows of the output kept; with SP
        off ``x`` is already the whole sequence and so is the output."""
        if not self.sp:
            return fn(x)
        y = fn(self.enter(x))
        lo, hi = self.rows
        return y[:, lo:hi].contiguous()

    # -- serving ------------------------------------------------------------
    def gather_kv(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's kv heads (b, s, k1 - k0, hd) -> every kv head, each
        from the first rank that computes it (ranks whose query heads share
        a kv head compute it alike)."""
        whole = self.group.all_gather(t, 2)
        if whole.shape[2] == len(self.kv_pick):
            return whole
        return whole[:, :, torch.tensor(self.kv_pick, device=t.device)]

    def last_rows(self, x: torch.Tensor, lengths=None) -> torch.Tensor:
        """Each batch row's vector at its last real position (``lengths -
        1``, else the last) of ``x`` (b, rows, d), whole on every rank:
        with SP on, the rank that holds the position gives it (the others
        zeros) and the sum runs over ``model``."""
        b = x.shape[0]
        idx = (torch.full((b,), self.seq, device=x.device) if lengths is
               None else torch.as_tensor(lengths, device=x.device).long())
        idx = (idx - 1).clamp(0, self.seq - 1)
        slots = torch.arange(b, device=x.device)
        if not self.sp:
            return x[slots, idx]
        lo, hi = self.rows
        own = (idx >= lo) & (idx < hi)
        rows = x[slots, (idx - lo).clamp(0, hi - lo - 1)]
        rows = torch.where(own[:, None], rows,
                           torch.zeros((), dtype=x.dtype, device=x.device))
        return reduce_from(rows, self.group)

    # -- activations ----------------------------------------------------------
    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """A block's normed input (b, rows, d) -> the whole sequence for
        its column-parallel projections: SP's all-gather, or with SP off
        the identity whose gradient is summed over ``model``."""
        return gather_param(x, self.group, 1) if self.sp else \
            copy_to(x, self.group)

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        """A row-parallel partial sum (b, seq, d) -> this rank's rows of
        the sum: SP's reduce-scatter, or with SP off the all-reduce."""
        return scatter(y, self.group, 1) if self.sp else \
            reduce_from(y, self.group)

    def own(self, x: torch.Tensor) -> torch.Tensor:
        """The last block's output -> this rank's rows for the loss (K1
        takes them contiguous)."""
        if self.sp:
            return x
        lo, hi = self.rows
        return copy_to(x, self.group)[:, lo:hi].contiguous()

    def replicated(self, t: torch.Tensor, path: str) -> torch.Tensor:
        """The whole param ``path`` for work every rank of ``model``
        repeats whole (its gradient already whole on every rank)."""
        return gather_replicated(t, self.group, self.dims[path])

    def embed(self, table: torch.Tensor, tokens: torch.Tensor
              ) -> torch.Tensor:
        """The embedding of ``tokens`` (b, seq), or (b, seq, K) with a
        codebook table (K, vocab, d), as the blocks take it:
        vocab-parallel where the rules split the table's vocab (each rank
        looks up its rows, zero elsewhere, the K codebooks summed in
        order, and the sum lands in SP or is all-reduced), else a lookup of
        the rank's rows of a whole table."""
        from repro_torch.models.transformer import lookup
        if self.dims["embed"] == table.ndim - 2:
            books = table.ndim == 3
            n, out = table.shape[-2], None
            for i, tab in enumerate(table if books else [table]):
                idx = (tokens[..., i] if books else tokens) - \
                    self.group.index * n
                hit = (idx >= 0) & (idx < n)
                rows = tab[idx.clamp(0, n - 1)]
                rows = torch.where(hit[..., None], rows,
                                   torch.zeros((), dtype=rows.dtype,
                                               device=rows.device))
                out = rows if out is None else out + rows
            return self.exit(out)
        if not self.sp:
            return lookup(table, tokens)
        lo, hi = self.rows
        return lookup(copy_to(table, self.group), tokens[:, lo:hi])


def gather_whole(t: torch.Tensor, spec: PartitionSpec, data: DataGroup,
                 model: ModelGroup) -> torch.Tensor:
    """The whole tensor of this rank's piece ``t`` under ``spec``: gathered
    over the data group, then the model group, along the dims each splits
    (``t`` itself where neither splits it)."""
    d = data.split_dim(spec)
    if d is not None:
        t = data.all_gather(t, d)
    m = model.split_dim(spec)
    return t if m is None else model.all_gather(t, m)
