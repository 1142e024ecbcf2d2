"""Meshes over ``torch.distributed``.  Functions (never module-level
constants), so importing this module touches no process group.

The port's copy of ``repro.launch.mesh``.  A mesh here is a
``DeviceMesh`` with named dims (``init_device_mesh``) over the default
process group, which the caller initialises first
(``torch.distributed.init_process_group``, or
``repro_torch.testing.ranks.spawn``); the mesh's size must equal the
world size.  Meshes are on the card (``"cuda"``) unless the caller asks
for the CPU (``device_type="cpu"``, gloo), as every entry point of the
port.

The production meshes (16 x 16 and 2 x 16 x 16) are given as descriptors:
building one needs that many ranks and raises otherwise.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

__all__ = ["make_mesh", "make_test_mesh", "make_production_mesh",
           "production_descriptor"]


def production_descriptor(*, multi_pod: bool = False) -> str:
    """``"data=16,model=16"`` (one pod, 256 ranks) or
    ``"pod=2,data=16,model=16"`` (two pods, 512 ranks)."""
    return ("pod=2,data=16,model=16" if multi_pod
            else "data=16,model=16")


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over every
    rank of the default process group.  ``device_type`` is ``"cuda"``
    unless ``"cpu"`` is asked for; a CUDA mesh on a host without CUDA
    raises (``repro_torch.device.resolve_device``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.device import resolve_device
    shape, axes = tuple(int(s) for s in shape), tuple(str(a) for a in axes)
    if len(shape) != len(axes):
        raise ValueError(f"make_mesh: shape {shape} and axes {axes} differ "
                         f"in length")
    dev = resolve_device(device_type).type
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else None
    if have != need:
        raise ValueError(
            f"make_mesh: a {dict(zip(axes, shape))} mesh needs {need} ranks "
            f"of an initialised process group; "
            + ("none is initialised" if have is None else f"have {have}"))
    return init_device_mesh(dev, shape, mesh_dim_names=axes)


def make_test_mesh(n_data: int = 2, n_model: int = 2,
                   device_type: Optional[str] = None):
    """A small ``("data", "model")`` mesh for tests (needs ``n_data *
    n_model`` ranks, e.g. ``testing.ranks.spawn``)."""
    return make_mesh((n_data, n_model), ("data", "model"), device_type)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """The 16 x 16 single-pod (256 ranks) or 2 x 16 x 16 two-pod (512
    ranks) mesh of :func:`production_descriptor`; raises unless the
    process group has that many ranks."""
    from repro_torch.mesh.strategy import parse_descriptor
    axes = parse_descriptor(production_descriptor(multi_pod=multi_pod))
    return make_mesh(tuple(axes.values()), tuple(axes), device_type)
