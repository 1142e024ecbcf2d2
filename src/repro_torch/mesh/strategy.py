"""MeshStrategy: mesh placement as a first-class, cache-keyable strategy.

The port's copy of ``repro.mesh.strategy``.  The paper's hierarchy assigns
every ``map``/``reduce`` a level (lanes, grid, ...); the Stage III shardmap
backend (``core.dpia.stage3_shardmap``) extends it to the *mesh* level
(``map[mesh(ax)]`` -> one shard a rank of the axis, ``reduce[mesh(ax)]`` ->
one ``all_reduce`` over the axis group).  This module makes that placement
declarative:

  * :class:`MeshStrategy` records which distributed level a kernel's top
    map/reduce binds to which **named mesh axis**, validated against a
    concrete ``torch.distributed`` ``DeviceMesh`` (or an axis -> size
    dict);
  * :func:`descriptor` renders a mesh as a canonical string (``"single"``
    / ``"data=8"`` / ``"pod=2,data=16,model=16"``): the mesh component of
    the tuning-cache and executor-cache keys, the reference's strings;
  * :func:`parse_descriptor` inverts it, so the autotuner can enumerate
    mesh-axis candidates from a descriptor alone (no ranks needed).

Where the reference reads ``jax.sharding.Mesh.shape`` (an axis -> size
dict), a ``DeviceMesh`` gives ``mesh_dim_names`` and ``shape`` (a tuple);
a mesh without dim names has no axis to bind and raises.  Nothing here
imports ``repro_torch.compiler`` or ``repro_torch.autotune`` at module
level.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

__all__ = ["MeshStrategy", "descriptor", "parse_descriptor", "axis_sizes",
           "current_descriptor", "resolve_mesh", "shrink_descriptor",
           "is_device_mesh", "SINGLE"]

SINGLE = "single"


def is_device_mesh(obj) -> bool:
    """Whether ``obj`` is a ``torch.distributed`` ``DeviceMesh``."""
    try:
        from torch.distributed.device_mesh import DeviceMesh
    except ImportError:             # a torch built without distributed
        return False
    return isinstance(obj, DeviceMesh)


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, in mesh order, of a ``DeviceMesh``, a descriptor
    string or an axis -> size dict ({} for None / ``"single"``)."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return {str(a): int(s) for a, s in mesh.items()}
    if isinstance(mesh, str):
        return parse_descriptor(mesh)
    if not is_device_mesh(mesh):
        raise TypeError(f"expected a torch DeviceMesh, a descriptor string, "
                        f"or None, got {type(mesh).__name__}")
    names = mesh.mesh_dim_names
    if not names:
        raise ValueError("a DeviceMesh without mesh_dim_names has no named "
                         "axis to bind a mesh strategy to; build it with "
                         "init_device_mesh(..., mesh_dim_names=(...))")
    return {str(a): int(s) for a, s in zip(names, tuple(mesh.shape))}


# ---------------------------------------------------------------------------
# canonical mesh descriptors (cache keys)
# ---------------------------------------------------------------------------

def descriptor(mesh) -> str:
    """Canonical string form of a mesh: ``"single"`` for None, else the
    axis-order ``name=size`` list (``"data=8"``, ``"data=2,model=4"``).

    Axis *order* is part of the descriptor: two meshes with the same axis
    sizes in a different rank order are different placement targets.
    Accepts a ``DeviceMesh``, an already-rendered descriptor string, or
    None; anything else raises ``TypeError``."""
    if mesh is None:
        return SINGLE
    if isinstance(mesh, str):
        return mesh or SINGLE
    if not is_device_mesh(mesh):
        raise TypeError(f"descriptor: expected a torch DeviceMesh, a "
                        f"descriptor string, or None, got "
                        f"{type(mesh).__name__}")
    axes = axis_sizes(mesh)
    if not axes:
        return SINGLE
    return ",".join(f"{a}={s}" for a, s in axes.items())


def parse_descriptor(desc: str) -> Dict[str, int]:
    """Axis name -> size for a :func:`descriptor` string ({} for "single")."""
    if not desc or desc == SINGLE:
        return {}
    out: Dict[str, int] = {}
    for part in desc.split(","):
        name, _, size = part.partition("=")
        if not name or not size:
            raise ValueError(f"parse_descriptor: malformed component "
                             f"{part!r} in {desc!r}")
        out[name] = int(size)
    return out


def shrink_descriptor(desc: str, n_devices: int,
                      axis: Optional[str] = None) -> str:
    """The largest descriptor reachable from ``desc`` on ``n_devices``
    devices, halving one axis (``axis``, default the *leading* axis: the
    data axis by convention) until the total fits.

    Pure string -> string: the scale-down rule of elastic re-meshing, so a
    shrunk mesh always round-trips through :func:`parse_descriptor`.
    Raises ``ValueError`` when even the fully shrunk shape needs more
    devices than available."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    axes = parse_descriptor(descriptor(desc))
    if not axes:
        return SINGLE
    ax = axis if axis is not None else next(iter(axes))
    if ax not in axes:
        raise ValueError(f"shrink axis {ax!r} not in descriptor {desc!r}")

    def total() -> int:
        t = 1
        for s in axes.values():
            t *= s
        return t

    while total() > n_devices and axes[ax] > 1:
        axes[ax] //= 2
    if total() > n_devices:
        raise ValueError(
            f"not enough devices for {desc!r}: the fully shrunk shape "
            f"still needs {total()}, have {n_devices}")
    return ",".join(f"{a}={s}" for a, s in axes.items())


def resolve_mesh(mesh=None):
    """The concrete mesh to compile against: an explicit argument wins,
    then the active ``compiler.options(mesh=...)`` scope, then the process
    mesh context (``repro_torch.sharding.ctx``).  None when
    single-device."""
    if mesh is not None:
        return mesh
    from repro_torch.compiler import current_options
    return current_options().resolved_mesh()


def current_descriptor(mesh=None) -> str:
    """Descriptor of :func:`resolve_mesh`: what cache keys should carry."""
    return descriptor(resolve_mesh(mesh))


# ---------------------------------------------------------------------------
# MeshStrategy
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshStrategy:
    """One mesh-level placement decision for a kernel.

    axis     named mesh axis the distributed map/reduce binds to
    op       "map"    — output stays sharded over ``axis`` (scal / rmsnorm
                        / softmax / matmul row shards)
             "reduce" — per-shard partials are combined by one mesh reduce
                        (one ``all_reduce`` on the axis group; dot / asum)
    extent   the logical extent being sharded (n, rows, or m), recorded so
             validation can check divisibility without re-deriving it
    """
    axis: str
    op: str = "map"
    extent: Optional[int] = None

    def __post_init__(self):
        if self.op not in ("map", "reduce"):
            raise ValueError(f"MeshStrategy.op must be 'map' or 'reduce', "
                             f"got {self.op!r}")

    # -- validation ----------------------------------------------------------

    def shards(self, mesh) -> int:
        """Number of shards the bound axis provides on ``mesh`` (a
        ``DeviceMesh``, a descriptor or an axis -> size dict)."""
        axes = axis_sizes(mesh)
        if self.axis not in axes:
            raise ValueError(
                f"mesh axis {self.axis!r} not in mesh {sorted(axes)}")
        return int(axes[self.axis])

    def validate(self, mesh) -> "MeshStrategy":
        """Check this placement against a mesh: the axis must exist and the
        sharded extent must divide evenly.  Fluent."""
        size = self.shards(mesh)
        if self.extent is not None and self.extent % size != 0:
            raise ValueError(
                f"extent {self.extent} not divisible by mesh axis "
                f"{self.axis!r} of size {size}")
        return self

    # -- canonical forms -----------------------------------------------------

    def describe(self) -> str:
        """``map[mesh(data)]`` / ``reduce[mesh(data)]``: the strategy level
        this placement assigns, in the paper's level-annotation notation."""
        return f"{self.op}[mesh({self.axis})]"

    def params(self) -> Dict[str, object]:
        """The tuning-space params fragment this placement contributes."""
        return {"mesh_axis": self.axis}

    @classmethod
    def from_params(cls, params: Dict[str, object], *, op: str = "map",
                    extent: Optional[int] = None) -> Optional["MeshStrategy"]:
        """Rebuild from a tuned params dict; None when the params carry no
        mesh placement (a single-device candidate)."""
        ax = params.get("mesh_axis")
        if ax is None:
            return None
        return cls(axis=str(ax), op=op, extent=extent)
