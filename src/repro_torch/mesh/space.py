"""Mesh-axis strategy space: which named axis (if any) a kernel's top level
binds to, and the per-shard chunk blocking underneath it.

The port's copy of ``repro.mesh.space``.  Candidates reuse
:class:`repro_torch.autotune.space.Candidate`; their params extend the
single-device vocabulary with one key:

  ``mesh_axis``   named mesh axis of the distributed map/reduce

plus the per-shard chunk factor in the kernel's existing vocabulary
(``block`` / ``row_block`` / ``bk``).  Enumeration needs only the axis->size
dict of a mesh *descriptor* (:func:`repro_torch.mesh.parse_descriptor`) —
no ranks, no DeviceMesh — so the tuner can rank mesh placements offline and
the ranking is keyed by the descriptor in the persistent cache.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .kernels import MESH_KERNELS
from .strategy import MeshStrategy

__all__ = ["mesh_space", "default_mesh_params", "mesh_candidate_from_params",
           "mesh_extent"]

# per-shard chunk menus (subset of the single-device menus: a shard is small)
_CHUNK_BLOCKS = (256, 1024, 4096)
_CHUNK_PARAM = {"dot": "block", "asum": "block", "scal": "block",
                "rmsnorm": "row_block", "softmax": "row_block",
                "matmul": "bk"}
_CHUNK_EXTENT = {"matmul": "k"}   # bk blocks the contraction, not the shard


def mesh_extent(kernel: str, shape: Dict[str, int]) -> int:
    """The logical extent the mesh axis shards for this kernel."""
    _, dim = MESH_KERNELS[kernel]
    return int(shape[dim])


def _eligible_axes(kernel: str, axes: Dict[str, int],
                   shape: Dict[str, int]) -> List[str]:
    ext = mesh_extent(kernel, shape)
    return [a for a, s in axes.items() if s > 1 and ext % int(s) == 0]


def _chunk_menu(kernel: str, axes: Dict[str, int], axis: str,
                shape: Dict[str, int]) -> List[Optional[int]]:
    ext_name = _CHUNK_EXTENT.get(kernel)
    if ext_name is None:
        local = mesh_extent(kernel, shape) // int(axes[axis])
    else:
        local = int(shape[ext_name])
    menu: List[Optional[int]] = [None]   # whole-shard leaf op
    menu += [b for b in _CHUNK_BLOCKS if 0 < b < local and local % b == 0]
    return menu


def _builder(kernel: str, axis: str, shards: int, chunk: Optional[int],
             shape: Dict[str, int]):
    build_fn, _ = MESH_KERNELS[kernel]

    def build():
        kw = {} if chunk is None else {_CHUNK_PARAM[kernel]: chunk}
        return build_fn(axis, shards, **kw, **shape)
    return build


def mesh_space(kernel: str, axes: Dict[str, int], **shape):
    """All mesh-placement candidates for ``kernel`` on a mesh with the given
    axis sizes.  Empty when no axis divides the sharded extent (the caller
    then falls back to the single-device space)."""
    from repro_torch.autotune.space import _cand
    if kernel not in MESH_KERNELS:
        return []
    out = []
    for ax in _eligible_axes(kernel, axes, shape):
        shards = int(axes[ax])
        for chunk in _chunk_menu(kernel, axes, ax, shape):
            params: Dict[str, object] = {"mesh_axis": ax,
                                         _CHUNK_PARAM[kernel]: chunk}
            out.append(_cand(kernel, params,
                             _builder(kernel, ax, shards, chunk, shape)))
    return out


def default_mesh_params(kernel: str, axes: Dict[str, int],
                        **shape) -> Dict[str, object]:
    """The un-tuned mesh placement: the first eligible axis (mesh order),
    whole-shard leaf ops.  Raises ValueError when nothing is shardable."""
    eligible = _eligible_axes(kernel, axes, shape)
    if not eligible:
        raise ValueError(
            f"default_mesh_params: no mesh axis in {dict(axes)} divides the "
            f"{kernel!r} extent {mesh_extent(kernel, shape)}")
    return {"mesh_axis": eligible[0], _CHUNK_PARAM[kernel]: None}


def mesh_candidate_from_params(kernel: str, params: Dict[str, object],
                               axes: Dict[str, int], **shape):
    """Rebuild the mesh Candidate a tuned params dict describes (validated
    against the axis sizes)."""
    from repro_torch.autotune.space import _cand
    strat = MeshStrategy.from_params(
        params, extent=mesh_extent(kernel, shape))
    if strat is None:
        raise ValueError(f"mesh_candidate_from_params: params {params!r} "
                         f"carry no mesh_axis")
    strat.validate(axes)
    shards = int(axes[strat.axis])
    chunk = params.get(_CHUNK_PARAM[kernel])
    chunk = None if chunk is None else int(chunk)
    return _cand(kernel, dict(params),
                 _builder(kernel, strat.axis, shards, chunk, shape))
