"""Expert-parallel MoE dispatch with an explicit all-to-all over the
``model`` axis: the port of ``repro.models.moe_ep``.

The reference runs this as a ``shard_map`` island inside its jitted train
step; the port's train step is one process a rank, so the body runs
directly on the rank's tokens (its batch rows, and on a ``model`` axis of
M > 1 its sequence rows: SP's layout) and the exchange goes over
``torch.distributed`` (``sharding.collectives``):

  per rank: local top-k routing
    -> fixed-capacity per-destination buckets (cumsum slotting)
    -> all-to-all over ``model`` of the (M, cap, d) payload and its int
       metadata (the expert index at the destination, 0 for an empty slot)
    -> the rank's experts (E / M of them) over the slots it received
    -> all-to-all back, gate-weighted combine at the source.

Where ``model`` does not divide the sequence, the reference falls back to
its GSPMD ``ffn.moe`` with the sequence whole on every model rank; so does
the port (``ffn.moe`` on a model axis: the rank's experts, their outputs
all-gathered over ``model``).

The groups are the running step's (``sharding.ctx.get_expert_parallel``)
or, called with a context mesh and no step, built from that mesh.  The
load-balancing statistics are averaged over the model group (the
reference's ``pmean``); each data shard keeps its own aux, which the
train step weighs (``train.step``).  Differentiable: the all-to-all's
backward is the all-to-all back.  As in ``ffn.moe``, a dropped entry goes
to a trash slot past the capacity that is never sent, and no atomics are
used.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.sharding import ctx
from .common import ModelConfig
from . import ffn

_GROUPS: Dict[int, object] = {}


def applicable(cfg: ModelConfig, mesh) -> bool:
    """The reference's rule: a mesh with a ``model`` axis (size 1
    included) whose size divides the experts."""
    if mesh is None:
        return False
    from repro_torch.sharding.rules import mesh_shape
    sizes = mesh_shape(mesh)
    if "model" not in sizes:
        return False
    return cfg.n_experts > 0 and cfg.n_experts % sizes["model"] == 0


def capacity(cfg: ModelConfig, tl: int, model_size: int) -> int:
    """Slots per destination rank for ``tl`` local tokens: the reference's
    ``max(ceil(cf * tl * k / model), 4)``."""
    return max(int(math.ceil(cfg.moe_capacity_factor * tl * cfg.top_k
                             / model_size)), 4)


def _groups(mesh):
    """The running step's ``ExpertParallel``, else one built from
    ``mesh`` (once a mesh: building a group is collective)."""
    ep = ctx.get_expert_parallel()
    if ep is None:
        from repro_torch.sharding.collectives import (DataGroup,
                                                      ExpertParallel,
                                                      ModelGroup)
        ep = _GROUPS.get(id(mesh))
        if ep is None or ep.model.mesh is not mesh:
            ep = _GROUPS[id(mesh)] = ExpertParallel(DataGroup(mesh),
                                                    ModelGroup(mesh))
    return ep


def _local_experts(p, e_local: int, index: int):
    """This rank's experts: the leaves as stored where the step holds the
    rank's share (the rules put the experts over ``model``), else cut from
    whole leaves; the router whole (inside a tensor-parallel step its
    gradient is summed over ``model``)."""
    tp = ctx.get_tensor_parallel()
    out = {"router": p["router"] if tp is None
           else tp.whole(p["router"], "blocks/mlp/router")}
    for name in ("w_gate", "w_up", "w_down"):
        w = p[name]
        if w.shape[0] != e_local:
            w = w.narrow(0, index * e_local, e_local)
        out[name] = w
    return out


def moe_ep(p, cfg: ModelConfig, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``ffn.moe`` with the explicit EP all-to-all; ``x`` is
    this rank's (b, s, d) tokens.  Returns ``(out, aux)``, aux this data
    shard's (its statistics averaged over the model group)."""
    from repro_torch.sharding.collectives import all_to_all
    mesh = ctx.get_mesh()
    assert applicable(cfg, mesh)
    ep = _groups(mesh)
    group = ep.model
    m = group.size
    tp = ctx.get_tensor_parallel()
    if tp is not None and not tp.sp:
        # the reference's fallback (s % model): its GSPMD MoE on the whole
        # sequence, every model rank running its experts
        return ffn.moe(p, cfg, x)
    e, k, d = cfg.n_experts, cfg.top_k, cfg.d_model
    e_local = e // m
    bl, sl, _ = x.shape
    t = bl * sl
    cap = capacity(cfg, t, m)
    w = _local_experts(p, e_local, group.index)

    xt = x.reshape(t, d)
    probs, topk_p, topk_i = ffn.route(w["router"], xt, k)
    aux = ffn.load_balance(probs, topk_i, e, k, mean=ep.model_mean)

    flat_e = topk_i.reshape(-1)                                  # (t * k,)
    dst = flat_e // e_local                                      # dest rank
    e_loc = flat_e % e_local                                     # its expert
    pos = ffn.slots(dst, m)
    keep = pos < cap
    gate = topk_p.reshape(-1) * keep
    # kept entries to their own slot, dropped ones to the trash slot `cap`
    dest = dst * (cap + 1) + torch.where(keep, pos, cap)
    tok = torch.arange(t * k, device=x.device) // k
    send = xt.new_zeros((m * (cap + 1), d)).index_copy(0, dest, xt[tok])
    meta = torch.zeros(m * (cap + 1), dtype=torch.int32, device=x.device)
    meta = meta.index_copy(0, dest, (e_loc + 1).to(torch.int32))
    recv = all_to_all(send.view(m, cap + 1, d)[:, :cap], group)
    meta_r = group.all_to_all(meta.view(m, cap + 1)[:, :cap])

    # this rank's experts over the slots it received (-1: an empty slot)
    re = meta_r.reshape(-1).long() - 1
    occupied = (re >= 0)[:, None]
    slots = recv.reshape(m * cap, d) * occupied.to(recv.dtype)
    if e_local == 1:
        # one expert a rank: the slots feed it directly
        yslots = ffn.experts({n: w[n][0] for n in
                              ("w_gate", "w_up", "w_down")}, slots)
    else:
        re_c = re.clamp(0, e_local - 1)
        slot_pos = torch.arange(m * cap, device=x.device)
        ebuf = slots.new_zeros((e_local, m * cap, d)).index_put(
            (re_c, slot_pos), slots)
        ybuf = ffn.experts(w, ebuf)                              # (el, mc, d)
        yslots = ybuf[re_c, slot_pos]
    yslots = yslots * occupied.to(yslots.dtype)

    yback = all_to_all(yslots.reshape(m, cap, d), group)
    yk = yback[dst, pos.clamp(max=cap - 1)]                      # (t * k, d)
    out = ffn.combine(yk, gate, k)
    return out.reshape(bl, sl, d).to(x.dtype), aux
