"""Mesh context: lets model code reach the process mesh without threading
it through every call signature.

The port's copy of ``repro.sharding.ctx`` (``set_mesh``, ``get_mesh``,
``_filter``, ``dp_axes``, ``constraint``).  The mesh is a
``torch.distributed`` ``DeviceMesh`` with named dims.  ``constraint(x,
*axes)`` is the identity with no mesh set, as in the reference, so
single-device code and CPU smoke runs are unaffected.  With a mesh set it
resolves the spec as the reference does (absent axes dropped, a dim its
axes do not divide left whole) and, since the tensors of the port are the
rank's local pieces, accepts only what the train step has already placed:
a split of dim 0 over the data-parallel axes, a split over axes of size
1, and the reference's sequence-parallel boundary ``constraint(x, dp,
"model", None)`` inside a tensor-parallel train step (a ``model`` axis of
size > 1), where ``x`` is this rank's sequence shard, checked by shape.
Where the resolution leaves the sequence whole (``model`` does not divide
it, so the reference drops the axis), SP is off for the step and ``x`` is
the whole sequence, checked likewise.  Any other split over ``model``
raises.  The sharded serving engine reads the mesh from here too
(``repro_torch.serve.engine.ShardedEngine``).

Two hooks of the sharded train step (``repro_torch.train.step``) reach the
model through here:

  * ``gathered(tree, name)``, fully sharded training's (FSDP): the model
    calls it on ``params["embed"]``, ``["ln_f"]``, ``["head"]`` and each
    layer's dict, inside the function that remat wraps, and gets the
    tensors whole over the data axes back.  It is the identity unless a
    sharded train step is running (:func:`param_gather`);
  * ``get_tensor_parallel()``, the model axis's: the running step's
    ``sharding.collectives.TensorParallel`` (set by
    :func:`tensor_parallel`), or None, which the model reads as one rank
    of the model axis;
  * ``get_expert_parallel()``, the MoE's: the running step's
    ``sharding.collectives.ExpertParallel`` (set by
    :func:`expert_parallel`), or None outside a sharded train step.

Both globals are plain module globals, not thread-locals: autograd runs a
CUDA backward, remat's recompute included, on a thread of its own.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Tuple

_MESH = None
_GATHER: Optional[Callable] = None
_TP = None
_EP = None


def set_mesh(mesh) -> None:
    """Set (or, with None, clear) the process mesh (a ``DeviceMesh``
    with named dims, or a ``collectives.CountingMesh``)."""
    if mesh is not None and not getattr(mesh, "counting", False):
        from repro_torch.mesh.strategy import axis_sizes
        axis_sizes(mesh)           # a DeviceMesh with named dims, or raise
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


def _names(mesh) -> Tuple[str, ...]:
    from .rules import mesh_shape
    return tuple(mesh_shape(mesh))


def _filter(axis, mesh=None):
    """Drop axis names absent from ``mesh`` (or the context mesh).

    Safe with no mesh set: every name filters to None."""
    mesh = mesh if mesh is not None else _MESH
    if axis is None or mesh is None:
        return None
    names = _names(mesh)
    if isinstance(axis, (tuple, list)):
        kept = tuple(a for a in axis if a in names)
        return kept if kept else None
    return axis if axis in names else None


def dp_axes() -> Optional[Tuple[str, ...]]:
    """The data-parallel axes of the context mesh (``pod``, ``data``)."""
    mesh = _MESH
    if mesh is None:
        return None
    kept = tuple(a for a in ("pod", "data") if a in _names(mesh))
    return kept or None


def resolve(shape, axes, mesh) -> tuple:
    """The reference's resolution of ``constraint``'s spec for a tensor of
    ``shape`` on ``mesh`` (a ``DeviceMesh``, anything with a ``shape``
    mapping of axis sizes, or such a mapping): per dim, its axes with the
    absent ones dropped, or None where none is left or their sizes'
    product does not divide the dim."""
    from .rules import mesh_shape
    sizes = mesh_shape(mesh)
    spec = []
    for dim, ax in zip(shape, axes):
        ax = _filter(ax, mesh)
        if ax is not None:
            size = math.prod(sizes[a] for a in
                             (ax if isinstance(ax, tuple) else (ax,)))
            if dim % size != 0:
                ax = None
        spec.append(ax)
    return tuple(spec)


def constraint(x, *axes):
    """The reference's ``with_sharding_constraint`` against the context
    mesh: the identity with no mesh set; with one, ``x`` itself when the
    resolved spec splits only dim 0 over the data-parallel axes, only
    over axes of size 1, or dim 1 over ``model`` as the running tensor-
    parallel step's sequence split (module docstring); a sequence that
    is not this rank's share raises ValueError, any other split
    NotImplementedError."""
    mesh = _MESH  # snapshot: set_mesh(None) mid-call must not crash us
    if mesh is None:
        return x
    from .rules import mesh_shape
    sizes = mesh_shape(mesh)
    tp = _TP if sizes.get("model", 1) > 1 else None
    shape = list(x.shape)
    if tp is not None and len(shape) > 1:
        shape[1] = tp.seq          # resolved on the global sequence
    dp = {"pod", "data"}
    for i, ax in enumerate(resolve(shape, axes, mesh)):
        if ax is None:
            continue
        names = ax if isinstance(ax, tuple) else (ax,)
        if i == 0 and set(names) <= dp:
            continue
        if math.prod(sizes[a] for a in names) == 1:
            continue
        if i == 1 and names == ("model",) and tp is not None:
            continue                # the SP boundary, checked below
        raise NotImplementedError(
            f"sharding.ctx.constraint: dim {i} of a {tuple(x.shape)} tensor "
            f"over {ax} on {sizes}: the port splits the model axis only as "
            f"its tensor-parallel train step does (heads, ff and vocab "
            f"inside the layers, the sequence between them: "
            f"train.step.make_train_step on this mesh)")
    seq_axes = _filter(axes[1], mesh) if len(axes) > 1 and \
        len(shape) > 1 else None
    if tp is not None and "model" in ((seq_axes,) if isinstance(
            seq_axes, str) else (seq_axes or ())):
        want = tp.rows[1] - tp.rows[0] if tp.sp else tp.seq
        if x.shape[1] != want:
            raise ValueError(
                f"sharding.ctx.constraint: a {tuple(x.shape)} tensor is not "
                f"model rank {tp.group.index}'s "
                + (f"sequence shard ({want} of {tp.seq})" if tp.sp else
                   f"whole sequence ({tp.seq}: SP is off, {tp.group.size} "
                   f"does not divide it)"))
    return x


@contextlib.contextmanager
def param_gather(fn: Callable):
    """While the block runs, ``gathered(tree, name)`` is ``fn(tree,
    name)``: the sharded train step's FSDP gather."""
    global _GATHER
    prev, _GATHER = _GATHER, fn
    try:
        yield
    finally:
        _GATHER = prev


def gathered(tree, name: str):
    """The whole tensors of a params subtree (``name``: ``"embed"``,
    ``"ln_f"``, ``"head"`` or ``"blocks"`` for one layer's dict): the
    identity unless a sharded train step set :func:`param_gather`."""
    fn = _GATHER
    return tree if fn is None else fn(tree, name)


@contextlib.contextmanager
def tensor_parallel(tp):
    """While the step runs, :func:`get_tensor_parallel` is ``tp`` (a
    ``sharding.collectives.TensorParallel``)."""
    global _TP
    prev, _TP = _TP, tp
    try:
        yield
    finally:
        _TP = prev


def get_tensor_parallel():
    """The running tensor-parallel step's ``TensorParallel``, or None."""
    return _TP


@contextlib.contextmanager
def expert_parallel(ep):
    """While the step runs, :func:`get_expert_parallel` is ``ep`` (a
    ``sharding.collectives.ExpertParallel``)."""
    global _EP
    prev, _EP = _EP, ep
    try:
        yield
    finally:
        _EP = prev


def get_expert_parallel():
    """The running sharded step's ``ExpertParallel``, or None."""
    return _EP
