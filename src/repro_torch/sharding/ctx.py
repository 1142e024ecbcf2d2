"""Mesh context: lets code reach the process mesh without threading it
through every call signature.

The port's copy of the mesh context of ``repro.sharding.ctx``
(``set_mesh``, ``get_mesh``, ``_filter``, ``dp_axes``).  The mesh is a
``torch.distributed`` ``DeviceMesh`` with named dims.  ``constraint(x,
*axes)`` is the identity with no mesh set, as in the reference, so
single-device code and CPU smoke runs are unaffected; with a mesh set it
raises until training on a mesh brings the sharding rules (ROADMAP.md
queue 1 item 7c).  The sharded serving engine reads the mesh from here
(``repro_torch.serve.engine.ShardedEngine``) and needs no rule: it
replicates the weights and shards only its slots.
"""
from __future__ import annotations

from typing import Optional, Tuple

_MESH = None


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
    return tuple(mesh.mesh_dim_names or ())


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


def constraint(x, *axes):
    """The reference's ``with_sharding_constraint`` against the context
    mesh: the identity with no mesh set."""
    if _MESH is None:
        return x
    raise NotImplementedError(
        "sharding.ctx.constraint with a mesh set: the sharding rules come "
        "with training on a mesh (ROADMAP.md queue 1 item 7c)")
