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
a split of dim 0 over the data-parallel axes, or a split over axes of size
1.  Anything else is the model axis's tensor or sequence parallelism
(ROADMAP.md queue 1 item 7d) and raises.  The sharded serving engine reads
the mesh from here too (``repro_torch.serve.engine.ShardedEngine``).

``gathered(tree, name)`` is the one hook of fully sharded training (FSDP,
``repro_torch.train.step``): the model calls it on ``params["embed"]``,
``["ln_f"]``, ``["head"]`` and each layer's dict, inside the function
that remat wraps, and gets the whole tensors back.  It is the identity
unless a sharded train step is running (:func:`param_gather`).  Both
globals are plain module globals, not thread-locals: autograd runs a CUDA
backward, remat's recompute included, on a thread of its own.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Tuple

_MESH = None
_GATHER: Optional[Callable] = None

_SP_ITEM = ("the model axis (tensor and sequence parallelism) comes with "
            "ROADMAP.md queue 1 item 7d")


def set_mesh(mesh) -> None:
    """Set (or, with None, clear) the process mesh."""
    if mesh is not None:
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
    resolved spec splits only dim 0 over the data-parallel axes, or only
    over axes of size 1 (module docstring), else NotImplementedError."""
    mesh = _MESH  # snapshot: set_mesh(None) mid-call must not crash us
    if mesh is None:
        return x
    from .rules import mesh_shape
    sizes = mesh_shape(mesh)
    dp = {"pod", "data"}
    for i, ax in enumerate(resolve(x.shape, axes, mesh)):
        if ax is None:
            continue
        names = ax if isinstance(ax, tuple) else (ax,)
        if i == 0 and set(names) <= dp:
            continue
        if math.prod(sizes[a] for a in names) == 1:
            continue
        raise NotImplementedError(
            f"sharding.ctx.constraint: dim {i} of a {tuple(x.shape)} tensor "
            f"over {ax} on {sizes}: {_SP_ITEM}")
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
