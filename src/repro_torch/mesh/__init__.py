"""repro_torch.mesh: first-class mesh strategies.

The port's copy of ``repro.mesh``.  The paper treats the parallelisation
strategy as a typed object preserved through compilation; this package
extends that object to the *mesh* level and makes the placement a tunable
dimension end to end:

  strategy — :class:`MeshStrategy` (which map/reduce binds to which named
             mesh axis, validated against a ``torch.distributed``
             ``DeviceMesh``) and the canonical mesh :func:`descriptor`
             every tuning/executor cache key carries (``"single"`` /
             ``"data=8"`` / ...)
  kernels  — mesh-level DPIA strategy builders for the tuned kernel set
             (dot/asum via mesh reduce; scal/rmsnorm/softmax/matmul via
             mesh map with replicated small operands)
  space    — mesh-axis candidate enumeration (which axis, per-shard chunk
             factor) over a descriptor's axis sizes, ranked by the
             collective-aware roofline in ``repro_torch.autotune.cost``

Consumers: ``compiler.options(mesh=...)`` scopes the mesh, the Stage III
``shardmap`` backend (``core.dpia.stage3_shardmap``) runs the terms over
the mesh's process groups, ``kernels.ops`` dispatches its
``dpia-shardmap`` rows through it, and ``repro_torch.autotune`` keys its
cache by the descriptor.
"""
from . import kernels, space, strategy  # noqa: F401
from .kernels import (  # noqa: F401
    MESH_KERNELS, mesh_asum, mesh_dot, mesh_matmul, mesh_rmsnorm, mesh_scal,
    mesh_softmax,
)
from .space import (  # noqa: F401
    default_mesh_params, mesh_candidate_from_params, mesh_extent, mesh_space,
)
from .strategy import (  # noqa: F401
    SINGLE, MeshStrategy, axis_sizes, current_descriptor, descriptor,
    parse_descriptor, resolve_mesh, shrink_descriptor,
)

__all__ = [
    "MeshStrategy", "descriptor", "parse_descriptor", "current_descriptor",
    "resolve_mesh", "shrink_descriptor", "axis_sizes", "SINGLE",
    "mesh_dot", "mesh_asum", "mesh_scal", "mesh_rmsnorm", "mesh_softmax",
    "mesh_matmul", "MESH_KERNELS",
    "mesh_space", "default_mesh_params", "mesh_candidate_from_params",
    "mesh_extent",
]
