"""Rank work of ``tests/test_torch_moe_ep.py``: the port's MoE on gloo ranks
of the CPU (``repro_torch.testing.ranks``).  Imports only ``repro_torch``
(and torch, numpy): the parent computes the reference's values with JAX
and sends the states, inputs and weights as numpy.

  * :func:`run_case`: the sharded train step of a MoE (or any) config on
    a ``(data, model)`` mesh from a numpy state in the reference's layout;
    per step its metrics, the whole state again (``gather_state``) as
    numpy in the port's layout, and the collectives by group;
  * :func:`moe_on_data_ranks`: ``ffn.moe`` on each rank's rows of a
    data axis, the routing statistics averaged over the data group (the
    reference's GShard groups on a mesh);
  * :func:`sharded_tokens`: ``ShardedEngine`` on ``data=world``.
"""
from __future__ import annotations

import numpy as np
import torch

from _sharded_train_ranks import numpy_state
from _tp_train_ranks import setup, state_bytes


def _counts(step) -> dict:
    place = step.placement
    return {name: dict(g.counts) for name, g in (
        ("data", place.group), ("model", place.model),
        ("world", place.world)) if g is not None}


def _aux_model(seen):
    """A model class that records each loss's MoE aux (this rank's; none
    for the other families)."""
    from repro_torch.models.transformer import Model

    class AuxModel(Model):
        def loss(self, params, batch):
            out = super().loss(params, batch)
            if self._last_aux is not None:
                seen.append(float(self._last_aux))
            return out
    return AuxModel


def run_case(shape, cfg_kw, step_kw, state, batches):
    from repro_torch.train import step as tstep
    auxes = []
    mesh, _, local, specs, step = setup(shape, cfg_kw, state,
                                        model_cls=_aux_model(auxes),
                                        **step_kw)
    out = {"bytes": state_bytes(local), "steps": [], "counts": [],
           "auxes": auxes}
    groups = [g for g in (step.placement.group, step.placement.model,
                          step.placement.world) if g is not None]
    for batch in batches:
        for g in groups:
            g.counts.clear()
        local, m = step(local, batch)
        out["counts"].append(_counts(step))
        out["steps"].append((m, numpy_state(
            tstep.gather_state(local, mesh, specs))))
    return out


def moe_on_data_ranks(rank, world, cfg_kw, np_moe, x, cot):
    """``ffn.moe`` of this rank's rows of ``x`` (b, s, d) on ``data=world``:
    (its output rows, its aux, the gradients of ``(out * cot).sum() +
    aux / world`` with respect to each param), all numpy."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ffn
    from repro_torch.models.common import ModelConfig
    from repro_torch.sharding import ctx
    from repro_torch.sharding.collectives import (DataGroup, ExpertParallel,
                                                  ModelGroup)
    cfg = ModelConfig(**cfg_kw)
    mesh = make_mesh((world,), ("data",), "cpu")
    p = {k: torch.tensor(v, requires_grad=True) for k, v in np_moe.items()}
    rows = x.shape[0] // world
    mine = slice(rank * rows, (rank + 1) * rows)
    ctx.set_mesh(mesh)
    try:
        with ctx.expert_parallel(ExpertParallel(DataGroup(mesh),
                                                ModelGroup(mesh))):
            out, aux = ffn.moe(p, cfg, torch.tensor(x[mine]))
            obj = (out * torch.tensor(cot[mine])).sum() + aux / world
            grads = torch.autograd.grad(obj, list(p.values()))
    finally:
        ctx.set_mesh(None)
    return (out.detach().numpy(), float(aux),
            {k: g.numpy() for k, g in zip(p, grads)})


def rank_work(rank, world, cases, moe_case, engine_cases):
    """Every train case of this world size, then (world 2) ``ffn.moe`` on
    the data ranks and ``ShardedEngine``'s tokens."""
    res = {"runs": {name: run_case(*case) for name, case in cases.items()}}
    if moe_case is not None:
        res["moe"] = moe_on_data_ranks(rank, world, *moe_case)
    res["engines"] = {name: sharded_tokens(world, *case)
                      for name, case in engine_cases.items()}
    return res


def sharded_tokens(world, cfg_kw, np_params, prompts, max_new, engine_kw):
    """Greedy tokens of ``ShardedEngine`` on ``data=world``, every slot's
    requests, as every rank sees them."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import ModelConfig
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.transformer import Model
    from repro_torch.serve.engine import Request, ShardedEngine
    cfg = ModelConfig(**cfg_kw)
    params = params_from_numpy(cfg, np_params, device="cpu")
    mesh = make_mesh((world,), ("data",), "cpu")
    eng = ShardedEngine(Model(cfg), params, mesh=mesh, **engine_kw)
    reqs = [Request(np.asarray(p).tolist(), max_new_tokens=n)
            for p, n in zip(prompts, max_new)]
    return eng.run(reqs)
