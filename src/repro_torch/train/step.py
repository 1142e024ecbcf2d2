"""The train step: microbatch gradient accumulation (optionally in bf16),
AdamW leaf by leaf in place, and the NaN guard; on one device, or SPMD on
a mesh's data axes over ``torch.distributed``.  The port of
``repro.train.step``.

``make_train_step`` returns ``step(state, batch) -> (state, metrics)``.
The state (``make_train_state``) is ``{"params", "opt": {"m", "v",
"step"}, "step"}``; ``step`` updates it in place and returns it, as the
reference's jitted step donates its input state (``donate=True``): a
caller that needs the old state keeps a copy.  ``metrics`` are host
numbers: ``loss``, ``grad_norm``, ``lr`` and ``applied``.

The NaN guard decides before the update: the loss and the global gradient
norm are read on the host (one sync a step) and, when either is not
finite, nothing is written: params, moments and both step counters keep
their bits (the reference computes the update and selects the old state
with ``jnp.where``, which a donated, in-place state cannot do).  An
exception raised once the update has begun leaves the state partly
written; the step re-raises it as ``PartialUpdateError``, which
``TrainLoop`` does not retry without a checkpoint to restore.

Remat is the model's (``cfg.remat``: each block under
``torch.utils.checkpoint``).

**On a mesh** (``make_train_step(model, mesh)``, one process a rank, the
mesh a named ``DeviceMesh``): the data-parallel axes are ``pod`` and
``data`` (``sharding.rules.dp_axes``) and ``model`` is the model axis.
The step sets ``sharding.ctx``'s mesh, as the reference's does.  Every
rank is given the same global batch and the same call sequence; what it
does:

  * **batch**: the rank at data index ``r`` of W takes its rows as
    ``sharding.rules.batch_specs`` places them: ``[r B / W, (r + 1) B /
    W)``; with ``microbatches`` mb, microbatch ``i`` is the reference's
    global rows ``[i B / mb, (i + 1) B / mb)`` and the rank holds its 1 / W
    of them.  A batch that W x mb does not divide raises ``ValueError``;
  * **loss**: the reference's, the mean over the global batch's (or
    microbatch's) unmasked tokens: each rank's mean over its own tokens
    (its rows, and on a model axis its sequence rows) is scaled by their
    share of the global count.  Every rank holds the global batch, so the
    counts need no collective;
  * **DP** (``cfg.fsdp`` false): the state is replicated over the data
    axes and each gradient leaf is all-reduced over the data group in its
    own dtype (bf16 for a bf16 model, or a bf16 microbatch sum);
  * **FSDP** (``cfg.fsdp``): params and moments live as this rank's shards
    (``make_train_state(..., mesh=)`` or :func:`shard_state`); the model
    gathers each leaf over the data group where it is used
    (``sharding.ctx.gathered``, inside the block remat wraps) and its
    gradient comes back reduce-scattered (``sharding.collectives``);
    leaves the rules leave whole over the data axes are all-reduced as
    under DP;
  * **TP and SP** (a ``model`` axis of M > 1): params are stored as the
    rules split them over ``model`` (with FSDP the reference's 2-D spec,
    e.g. yi-9b's ``wq`` ``(data, model)``), and the model computes each
    rank's heads and ff columns between SP's all-gather of the sequence
    and its reduce-scatter (``sharding.collectives.TensorParallel``, set
    for the step through ``sharding.ctx.tensor_parallel``).  Every sum
    over ``model`` happens inside autograd, so a gradient leaves the
    backward whole over ``model`` for a whole leaf and summed into its
    shard for a split one; the data axes then reduce it as above.  A
    ``model`` that cannot give each rank whole heads runs the attention
    whole on every rank (``collectives.check_model_axis``).  The
    recurrent families split the same way: rwkv6's time-mix and mamba2
    on each rank's heads of 64, rwkv6's channel-mix on its ff columns,
    the hybrid's shared block as the dense block (``models.rwkv6``,
    ``models.mamba2``); the rules' storage of their leaves is kept;
    where ``model`` does not divide the mixer's heads, the mixer runs
    whole on every rank;
  * **MoE** (``cfg.n_experts``): on a mesh with a ``model`` axis (size 1
    included) the FFN is the expert-parallel all-to-all
    (``models.moe_ep``) over the model group, each rank's experts as the
    rules place them (E / M of them); on a mesh without one, ``ffn.moe``
    on the rank's rows with its routing statistics averaged over the data
    group (``sharding.ctx.expert_parallel``).  The aux enters the loss
    once: each rank's weighs ``1 / (D M)``, so the gradient is the
    reference's, the mean over data shards; the reported loss carries the
    aux of the mesh's first rank, the value the reference's step reports
    (its ``shard_map`` returns one data shard's aux: ROADMAP.md queue 3);
  * **AdamW** updates the local shards with the reference's arithmetic:
    the global norm sums the shards' squares over ranks in one
    ``all_reduce`` (together with the loss; over the data group, or on a
    model axis over every rank of the mesh), each leaf counted once over
    every axis it is replicated over; an 8-bit moment's scale is the amax
    over all layers and ranks (one ``all_reduce(MAX)``);
  * **the NaN guard** reads the all-reduced loss and norm, so every rank
    decides the same, before any write.

A rank that raises fails the run: no rank may retry alone (its peers
would wait in a collective), so a caller on a mesh does not retry steps
(``launch.train`` runs ``TrainLoop`` with no retries there).  On a mesh
of one rank (W = M = 1) the step does the one-device step's arithmetic,
no collective and no scaling: its bits are the one-device step's; at M =
1 the data axes' step runs its own code, unchanged by the model axis.

``state_specs`` gives the rules' placement of a (global) state;
``shard_state`` cuts a global state into a rank's shards and
``gather_state`` is its inverse."""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.analysis import hlo_counter
from repro_torch.device import DeviceLike, resolve_or_meta
from repro_torch.ft.resilience import PartialUpdateError
from repro_torch.models.transformer import Model
from repro_torch.optim import adamw
from repro_torch.sharding import rules


def make_train_state(model: Model, generator: torch.Generator, *,
                     use_8bit: bool = False, device: DeviceLike = None,
                     mesh=None) -> Dict:
    """Params drawn from ``generator`` on ``device`` (the card unless
    ``"cpu"``; ``"meta"``: shapes only), marked to require grad, zero
    AdamW moments and counters.  With ``mesh``, this rank's shards of that
    state (the global params are drawn, then cut leaf by leaf)."""
    device = resolve_or_meta(device)
    params = model.init_params(generator, device)
    if mesh is not None:
        specs = rules.params_specs(params, mesh, model.cfg)
        coord = _coordinate(mesh)
        params = rules.tree_map_specs(
            lambda spec, t: rules.local_shard(t, mesh, spec, coord).clone(),
            specs, params)
    for _, p in adamw.leaves(params):
        p.requires_grad_(True)
    return {"params": params, "opt": adamw.init(params, use_8bit=use_8bit),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def state_specs(state: Dict, mesh, cfg) -> Dict:
    """The rules' PartitionSpecs of a train state (global shapes; the
    port's layout): params by ``rules.params_specs``, ``m`` and ``v``
    mirroring them (an 8-bit moment as ``QTensor(spec, PS())``), both step
    counters ``PS()``."""
    pspec = rules.params_specs(state["params"], mesh, cfg)

    def mirror(spec, leaf):
        if isinstance(leaf, adamw.QTensor):
            return adamw.QTensor(spec, rules.PS())
        return spec
    return {"params": pspec,
            "opt": {"m": rules.tree_map_specs(mirror, pspec,
                                              state["opt"]["m"]),
                    "v": rules.tree_map_specs(mirror, pspec,
                                              state["opt"]["v"]),
                    "step": rules.PS()},
            "step": rules.PS()}


def _coordinate(mesh) -> Dict[str, int]:
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not on the mesh")
    return dict(zip(rules.mesh_shape(mesh), coord))


def shard_state(state: Dict, mesh, specs: Dict) -> Dict:
    """This rank's pieces of a global ``state`` under ``specs``
    (``state_specs``): fresh tensors, grad flags kept."""
    coord = _coordinate(mesh)

    def cut(spec, t):
        out = rules.local_shard(t.detach(), mesh, spec, coord).clone()
        return out.requires_grad_(t.requires_grad)
    return rules.tree_map_specs(cut, specs, state)


def gather_state(state: Dict, mesh, specs: Dict) -> Dict:
    """The global state of every rank's shards (each leaf all-gathered over
    the data group and the model group; collectives every rank calls): the
    inverse of :func:`shard_state`."""
    from repro_torch.sharding.collectives import (DataGroup, ModelGroup,
                                                  gather_whole)
    groups = DataGroup(mesh), ModelGroup(mesh)

    def whole(spec, t):
        local = t.detach()
        out = gather_whole(local, spec, *groups)
        return (out.clone() if out is local else out).requires_grad_(
            t.requires_grad)
    return rules.tree_map_specs(whole, specs, state)


def _to_tensors(batch: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).to(device=device, dtype=torch.long)
            for k, v in batch.items()}


def _scaled(loss, scales, i):
    """Microbatch ``i``'s loss times its share of the global token count
    (a share of 1, and no scales, leave it as it is)."""
    if scales is None or scales[i] == 1.0:
        return loss
    return loss * scales[i]


def _objective(model: Model, params, batch, scales, i, aux_share):
    """Microbatch ``i``'s (loss to differentiate, loss to report).  On a
    mesh (``scales``) the cross entropy is weighed by the rank's share of
    the tokens; a MoE aux (``model._last_aux``, this data shard's) by
    ``aux_share[0]``, one over the world's ranks, so that the gradient is
    that of the mean over the data shards' auxes, as the reference's;
    the reported loss carries the aux of the rank ``aux_share[1]`` marks
    (the mesh's first), the value the reference's step reports."""
    loss = _scaled(model.loss(params, batch), scales, i)
    aux = model._last_aux
    if aux is None or aux_share is None:
        return loss, loss.detach()
    share, first = aux_share
    loss = loss + 0.01 * aux * (share - scales[i])
    return loss, (loss.detach()
                  + 0.01 * aux.detach() * (float(first) - share))


def _grad(loss, flat) -> List[torch.Tensor]:
    """The gradient of ``loss`` for every tensor of ``flat``.  Under an op
    count that scales regions by their trip counts
    (``analysis.hlo_counter``) only the first of a model's identical
    layers runs: the others' gradients are zeros."""
    if not hlo_counter.scaling():
        return list(torch.autograd.grad(loss, flat))
    got = torch.autograd.grad(loss, flat, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(flat, got)]


def gradients(model: Model, params, batch: Dict[str, torch.Tensor], *,
              microbatches: int = 1, grad_bf16: bool = True,
              scales: Optional[List[float]] = None, aux_share=None):
    """``(loss, grads, div)``: the loss (detached) and the gradient of
    every leaf of ``params`` (in :func:`adamw.leaves` order) on ``batch``.

    With ``microbatches > 1`` the batch is cut along its first axis; each
    microbatch's gradients are cast to bf16 (``grad_bf16``, else fp32) and
    summed in that dtype in microbatch order; ``div`` is the count the
    sum is to be divided by (in fp32, by the optimizer), the loss the mean
    of the microbatches'.  ``scales`` multiplies microbatch ``i``'s loss
    by ``scales[i]`` before its gradient (the sharded step's share of the
    global token count); ``aux_share`` weighs a MoE aux on a mesh
    (:func:`_objective`)."""
    flat = [t for _, t in adamw.leaves(params)]
    if microbatches == 1:
        loss, report = _objective(model, params, batch, scales, 0,
                                  aux_share)
        return report, _grad(loss, flat), 1
    b = batch["tokens"].shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} does not split into {microbatches} "
                         f"microbatches")
    per = b // microbatches
    acc_dtype = torch.bfloat16 if grad_bf16 else torch.float32
    acc, losses = None, []
    for i in range(microbatches):
        mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
        loss, report = _objective(model, params, mb, scales, i, aux_share)
        g = _grad(loss, flat)
        losses.append(report)
        if acc is None:
            acc = [x.to(acc_dtype) for x in g]
        else:
            for a, x in zip(acc, g):
                a.add_(x.to(acc_dtype))
        del g
    return torch.stack(losses).mean(), acc, microbatches


class _Placement:
    """What the sharded step needs of a mesh: the data, model and world
    groups, the split dims of each param leaf over the data axes and over
    ``model`` (by path; one layer's for ``blocks``), the FSDP gather, the
    model axis's ``TensorParallel`` of a sequence length, and the rank's
    rows of a global batch."""

    def __init__(self, model: Model, mesh):
        from repro_torch.sharding.collectives import (
            DataGroup, ExpertParallel, ModelGroup, WorldGroup, splits)
        self.cfg = model.cfg
        self.group = DataGroup(mesh)
        self.model = ModelGroup(mesh)
        self.world = WorldGroup(mesh) if self.model.size > 1 else None
        self.ep = (ExpertParallel(self.group, self.model)
                   if model.cfg.n_experts else None)
        meta = model.init_params(torch.Generator(), "meta")
        specs = rules.params_specs(meta, mesh, model.cfg)
        self.dims, self.model_dims = {}, {}
        for path, _ in adamw.leaves(meta):
            spec = specs
            for k in path:
                spec = spec[k]
            split = splits(mesh, spec)
            self.dims[self._key(path)] = split["data"]
            self.model_dims["/".join(self._key(path))] = split["model"]
        self.any_split = any(d is not None for d in self.dims.values())
        self._tp: Dict[int, object] = {}

    @staticmethod
    def _key(path) -> tuple:
        return tuple(k for k in path if not isinstance(k, int))

    def split(self, path) -> Optional[int]:
        return self.dims[self._key(path)]

    def model_split(self, path) -> Optional[int]:
        return self.model_dims["/".join(self._key(path))]

    def tensor_parallel(self, seq: int):
        """The model axis's ``TensorParallel`` for a batch of ``seq``
        tokens a row."""
        from repro_torch.sharding.collectives import TensorParallel
        if seq not in self._tp:
            self._tp[seq] = TensorParallel(self.model, self.model_dims,
                                           self.cfg, seq)
        return self._tp[seq]

    def gather(self, tree, name: str):
        """``sharding.ctx.gathered``'s FSDP form: each leaf that the rules
        split over the data axes, all-gathered (differentiably) to the
        whole tensor over them.  ``name`` is the subtree's path without
        layer indices (``"blocks"`` for one layer's dict,
        ``"blocks/mamba"``, ``"blocks/shared_attn"``, ``"head"``)."""
        from repro_torch.sharding.collectives import gather_param

        def walk(path, node):
            if node is None:
                return None
            if isinstance(node, dict):
                return {k: walk(path + (k,), v) for k, v in node.items()}
            return gather_param(node, self.group, self.split(path))
        return walk(tuple(name.split("/")), tree)

    def rows(self, batch: Dict, microbatches: int):
        """(this rank's rows of the global ``batch``, each microbatch's
        loss scale: the unmasked tokens this rank's loss takes over the
        global count, or None for one rank)."""
        w, r = self.group.size, self.group.index
        first = batch["tokens"]
        b = first.shape[0]
        if b % (w * microbatches):
            raise ValueError(f"a global batch of {b} rows does not split "
                             f"over {w} data ranks x {microbatches} "
                             f"microbatches")
        if w == 1 and self.model.size == 1:
            return batch, None
        per, mb_rows = b // (w * microbatches), b // microbatches
        ids = np.concatenate([np.arange(i * mb_rows + r * per,
                                        i * mb_rows + (r + 1) * per)
                              for i in range(microbatches)])
        local = batch if w == 1 else {
            k: (v[torch.as_tensor(ids, device=v.device)]
                if torch.is_tensor(v) else np.asarray(v)[ids])
            for k, v in batch.items()}
        labels = batch["labels"]
        labels = (labels.detach().cpu().numpy() if torch.is_tensor(labels)
                  else np.asarray(labels))
        lo, hi = (0, labels.shape[1]) if self.model.size == 1 else \
            self.tensor_parallel(labels.shape[1]).rows
        scales = []
        for i in range(microbatches):
            n_all = int((labels[i * mb_rows:(i + 1) * mb_rows] >= 0).sum())
            n_own = int((labels[ids[i * per:(i + 1) * per], lo:hi]
                         >= 0).sum())
            scales.append(n_own / max(n_all, 1))
        return local, scales

    def aux_share(self):
        """(the weight of a MoE aux in each rank's loss, whether this rank
        reports its aux): :func:`_objective`."""
        first = self.group.index == 0 and self.model.index == 0
        return 1.0 / (self.group.size * self.model.size), first

    def counted(self, path) -> bool:
        """Whether this rank adds leaf ``path``'s squares to the global
        norm: each leaf once over every axis it is whole over (there, the
        rank at index 0)."""
        return ((self.split(path) is not None or self.group.index == 0)
                and (self.model_split(path) is not None
                     or self.model.index == 0))


def make_train_step(model: Model, mesh=None, *, microbatches: int = 1,
                    base_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10000, grad_bf16: bool = True):
    """The train step of ``model`` (see the module docstring), on one
    device or, with ``mesh``, SPMD on the mesh's data and model axes; its
    gradients are :func:`gradients`'."""
    cfg = model.cfg
    place = None
    if mesh is not None:
        from repro_torch.sharding import ctx
        place = _Placement(model, mesh)
        ctx.set_mesh(mesh)

    def step(state: Dict, batch: Dict):
        from repro_torch.sharding import ctx
        params = state["params"]
        device = adamw.leaves(params)[0][1].device
        scales = None
        if place is not None:
            batch, scales = place.rows(batch, microbatches)
        batch = _to_tensors(batch, device)
        scope = contextlib.ExitStack()
        if place is not None and place.any_split and place.group.size > 1:
            scope.enter_context(ctx.param_gather(place.gather))
        if place is not None and place.model.size > 1:
            scope.enter_context(ctx.tensor_parallel(
                place.tensor_parallel(batch["tokens"].shape[1])))
        if place is not None and place.ep is not None:
            scope.enter_context(ctx.expert_parallel(place.ep))
        with scope:
            loss, grads_flat, div = gradients(
                model, params, batch, microbatches=microbatches,
                grad_bf16=grad_bf16, scales=scales,
                aux_share=None if scales is None else place.aux_share())
        lr = adamw.cosine_schedule(state["step"], base_lr=base_lr,
                                   warmup=warmup, total=total_steps)
        reduce_amax = None
        if place is None or (place.group.size == 1
                             and place.model.size == 1):
            grads = adamw.unflatten(params, grads_flat)
            del grads_flat
            gnorm = adamw.global_norm(grads, div=div)
        else:
            group = place.group
            paths = [p for p, _ in adamw.leaves(params)]
            for path, g in zip(paths, grads_flat):
                if place.split(path) is None:
                    group.all_reduce_(g)
            grads = adamw.unflatten(params, grads_flat)
            del grads_flat
            if place.model.size == 1:
                def sharded(path):
                    return place.split(path) is not None
                # the loss's partial sums and the shards' squares: one
                # all_reduce
                red = torch.stack([loss.float(), adamw.sum_squares(
                    grads, div=div, keep=sharded)])
                group.all_reduce_(red)
                loss = red[0]
                gnorm = torch.sqrt(red[1] + adamw.sum_squares(
                    grads, div=div, keep=lambda p: not sharded(p)))
            else:
                # over every rank: each leaf's squares counted once
                group = place.world
                red = torch.stack([loss.float(), adamw.sum_squares(
                    grads, div=div, keep=place.counted)])
                group.all_reduce_(red)
                loss, gnorm = red[0], torch.sqrt(red[1])
            if cfg.opt_8bit and (place.any_split or place.model.size > 1):
                def reduce_amax(amaxes):
                    flat = torch.stack([a for pair in amaxes for a in pair])
                    group.all_reduce_(flat, op="max")
                    return list(zip(flat[0::2], flat[1::2]))
        loss_v, gnorm_v, lr_v = torch.stack(
            [loss.float(), gnorm, lr]).tolist()       # the step's host sync
        good = math.isfinite(loss_v) and math.isfinite(gnorm_v)
        if good:
            try:
                adamw.update(params, grads, state["opt"], lr=lr,
                             use_8bit=cfg.opt_8bit, grad_div=div,
                             grad_norm=gnorm, reduce_amax=reduce_amax)
                state["step"] += 1
            except Exception as exc:
                raise PartialUpdateError(
                    f"the in-place update failed partway "
                    f"({type(exc).__name__}: {exc})") from exc
        return state, {"loss": loss_v, "grad_norm": gnorm_v, "lr": lr_v,
                       "applied": int(good)}

    step.placement = place
    return step
