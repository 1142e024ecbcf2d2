"""Gradient compression for cross-pod (DCN) all-reduces: the port of
``repro.ft.compress``.

Two modes:
  * bf16  — cast-before-reduce (halves collective bytes);
  * int8  — error-feedback quantised all-reduce, for the 'pod' axis where
            DCN bandwidth dominates.  The residual is carried by the
            caller.

Error feedback keeps the quantisation bias out of the optimizer trajectory:
    q = Q(g + e);  e' = (g + e) - deQ(q);  allreduce(q)

Where the reference's ``psum`` runs inside ``shard_map`` over a named mesh
axis, these reduce over ``torch.distributed.all_reduce`` on the process
group of the named dim of ``mesh`` (default: ``sharding.ctx``'s mesh); every
rank of that group calls them.  Trees are the port's (dicts and lists of
tensors, ``optim.adamw.tree_map``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.optim.adamw import leaves, tree_map, unflatten


def _group(axis: str, mesh):
    if mesh is None:
        from repro_torch.sharding import ctx
        mesh = ctx.get_mesh()
    if mesh is None:
        raise ValueError("no mesh: pass mesh= or set sharding.ctx's mesh")
    return mesh.get_group(axis)


def _psum(t: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist
    dist.all_reduce(t, group=group)
    return t


def bf16_psum(tree, axis: str, mesh=None):
    group = _group(axis, mesh)
    return tree_map(lambda g: _psum(g.to(torch.bfloat16), group).to(g.dtype),
                    tree)


def _q8(x) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = torch.clamp(torch.max(torch.abs(x)), min=1e-12)
    scale = amax / 127.0
    return (torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8),
            scale)


def int8_ef_psum(tree, err_tree, axis: str, mesh=None):
    """Error-feedback int8 all-reduce; returns (reduced_tree, new_err_tree).

    As in the reference, each rank's int8 values times its scale are
    summed in fp32 (the sum of per-shard scales upper-bounds the true
    scale; conservative and cheap)."""
    group = _group(axis, mesh)

    def one(g, e):
        g32 = g.float() + e
        q, scale = _q8(g32)
        deq = q.float() * scale
        new_e = g32 - deq
        total = _psum(q.to(torch.int32).float() * scale, group)
        return total.to(g.dtype), new_e

    out = [one(g, e) for (_, g), (_, e) in zip(leaves(tree),
                                               leaves(err_tree))]
    return (unflatten(tree, [o[0] for o in out]),
            unflatten(tree, [o[1] for o in out]))


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
