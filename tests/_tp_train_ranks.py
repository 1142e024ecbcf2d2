"""Rank work of ``tests/test_torch_tp_train.py``: the port's train step on
a mesh's model axis (TP and SP, with DP or FSDP on the data axis) on gloo
ranks of the CPU.  Imports only ``repro_torch`` (and torch, numpy): the
parent computes the reference's values with JAX and sends the initial
states and the batches as numpy.

A case is ``(mesh shape (data, model), config fields, step kw, numpy state
in the reference's layout, batches)``; it runs the sharded step from that
state and returns, per step, the metrics and the whole state again
(``gather_state``) as numpy in the port's layout, with the rank's state
bytes and its collectives by group.
"""
from __future__ import annotations

import os

import torch

from _sharded_train_ranks import checksum_state, numpy_state

STEP = dict(base_lr=1e-2, warmup=1, total_steps=20)

_MESHES = {}


def mesh_of(shape):
    from repro_torch.launch.mesh import make_mesh
    if shape not in _MESHES:
        _MESHES[shape] = make_mesh(shape, ("data", "model"), "cpu")
    return _MESHES[shape]


def state_bytes(state) -> int:
    from repro_torch.optim import adamw
    return sum(t.numel() * t.element_size()
               for _, leaf in adamw.leaves(state)
               for t in (leaf if isinstance(leaf, adamw.QTensor) else (leaf,)))


def setup(shape, cfg_kw, state, model_cls=None, **step_kw):
    """(mesh, cfg, this rank's shards, their specs, the step)."""
    from repro_torch.models.common import ModelConfig
    from repro_torch.models.convert import train_state_from_numpy
    from repro_torch.models.transformer import Model
    from repro_torch.train import step as tstep
    mesh = mesh_of(tuple(shape))
    cfg = ModelConfig(**cfg_kw)
    whole = train_state_from_numpy(cfg, state, device="cpu")
    specs = tstep.state_specs(whole, mesh, cfg)
    local = tstep.shard_state(whole, mesh, specs)
    step = tstep.make_train_step((model_cls or Model)(cfg), mesh,
                                 **{**STEP, **step_kw})
    return mesh, cfg, local, specs, step


def counts(step) -> dict:
    place = step.placement
    return {"data": dict(place.group.counts), "model": dict(place.model.counts),
            "world": dict(place.world.counts)}


def run_case(shape, cfg_kw, step_kw, state, batches):
    from repro_torch.train import step as tstep
    mesh, _, local, specs, step = setup(shape, cfg_kw, state, **step_kw)
    out = {"bytes": state_bytes(local), "steps": [], "counts": []}
    for batch in batches:
        for g in (step.placement.group, step.placement.model,
                  step.placement.world):
            g.counts.clear()
        local, m = step(local, batch)
        out["counts"].append(counts(step))
        out["steps"].append((m, numpy_state(
            tstep.gather_state(local, mesh, specs))))
    return out, local, specs, step


def _nan_model(rank_with_nan):
    """A model class whose loss is NaN on one rank's rows."""
    import torch.distributed as dist

    from repro_torch.models.transformer import Model

    class NanModel(Model):
        def loss(self, params, batch):
            out = super().loss(params, batch)
            return out * float("nan") if dist.get_rank() == rank_with_nan \
                else out
    return NanModel


def _constraint(mesh, step, seq):
    """``ctx.constraint`` at the SP boundary inside and outside the step's
    tensor-parallel context."""
    from repro_torch.sharding import ctx
    tp = step.placement.tensor_parallel(seq)
    shard = torch.ones(2, tp.rows[1] - tp.rows[0], 8)
    out = {}

    def call(x, *axes):
        try:
            return ctx.constraint(x, *axes) is x
        except (ValueError, NotImplementedError) as e:
            return f"{type(e).__name__}: {e}"
    ctx.set_mesh(mesh)
    try:
        out["outside"] = call(shard, ctx.dp_axes(), "model", None)
        with ctx.tensor_parallel(tp):
            out["shard"] = call(shard, ctx.dp_axes(), "model", None)
            out["whole"] = call(torch.ones(2, seq, 8), ctx.dp_axes(),
                                "model", None)
            out["hidden"] = call(torch.ones(2, seq, 8), None, None, "model")
    finally:
        ctx.set_mesh(None)
    return out


def rank_work_four(rank, world, cases, tmp):
    """Every case on a 4-rank mesh; the NaN drill, 6 heads on 4 ranks and
    ``constraint`` on ``data=2, model=2``; a checkpoint of the FSDP case
    saved there, then one more step."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.models.common import ModelConfig
    from repro_torch.models.transformer import Model
    from repro_torch.train import step as tstep
    res = {"runs": {}}
    for name, (shape, cfg_kw, step_kw, state, batches) in cases.items():
        out, local, specs, step = run_case(shape, cfg_kw, step_kw, state,
                                           batches[:2])
        res["runs"][name] = out
        if name == "base_fsdp":
            mesh = mesh_of(tuple(shape))
            mgr = CheckpointManager(os.path.join(tmp, "tp_ckpt"), mesh=mesh,
                                    specs=specs, async_save=False)
            mgr.save(2, local, extra={"data_state": {"step": 2}})
            local, m = step(local, batches[2])
            res["after_save"] = (m, numpy_state(
                tstep.gather_state(local, mesh, specs)))

    # a NaN loss on rank 2's rows only: no rank writes a bit
    shape, cfg_kw, _, state, batches = cases["base_fsdp"]
    mesh, _, local, _, step = setup(shape, cfg_kw, state,
                                    model_cls=_nan_model(2))
    before = checksum_state(local)
    local, m = step(local, batches[0])
    res["nan"] = (m, before == checksum_state(local))
    res["constraint"] = _constraint(mesh, step, 16)

    # a model axis of 4 does not divide 6 heads: the attention runs whole
    kw6 = {**cfg_kw, "n_heads": 6, "n_kv_heads": 2, "head_dim": 8}
    cfg6 = ModelConfig(**kw6)
    local6 = tstep.make_train_state(
        Model(cfg6), torch.Generator().manual_seed(0), device="cpu",
        mesh=mesh_of((1, 4)))
    _, res["heads"] = tstep.make_train_step(
        Model(cfg6), mesh_of((1, 4)), **STEP)(local6, batches[0])
    return res


def rank_work_two(rank, world, cases, tmp, ckpt_case):
    """Every case on ``model=2``; then the checkpoint saved on ``data=2,
    model=2`` restored here, bitwise, and one more step."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.train import step as tstep
    res = {"runs": {}}
    for name, (shape, cfg_kw, step_kw, state, batches) in cases.items():
        res["runs"][name] = run_case(shape, cfg_kw, step_kw, state,
                                     batches)[0]
    cfg_kw, state, batch = ckpt_case
    mesh, _, template, specs, step = setup((1, 2), cfg_kw, state)
    mgr = CheckpointManager(os.path.join(tmp, "tp_ckpt"), mesh=mesh,
                            specs=specs)
    step_no, restored, extra = mgr.restore_latest(template)
    res["restored"] = (step_no, extra, numpy_state(
        tstep.gather_state(restored, mesh, specs)))
    restored, m = step(restored, batch)
    res["after_restore"] = (m, numpy_state(
        tstep.gather_state(restored, mesh, specs)))
    return res


def rank_work_step(rank, world, cfg_kw):
    """One step of ``cfg_kw``'s model from seed 0 on ``data=1, model=2``:
    its metrics and the rank's local shapes of ``wq`` and ``embed``."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.common import ModelConfig
    from repro_torch.models.transformer import Model
    from repro_torch.train import step as tstep
    mesh = mesh_of((1, 2))
    cfg = ModelConfig(**cfg_kw)
    model = Model(cfg)
    state = tstep.make_train_state(
        model, torch.Generator().manual_seed(0), device="cpu", mesh=mesh)
    step = tstep.make_train_step(model, mesh, **STEP)
    batch = next(SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16,
                                        global_batch=4)).iterator())[0]
    state, m = step(state, batch)
    p = state["params"]
    return m, tuple(p["blocks"][0]["attn"]["wq"].shape), \
        tuple(p["embed"].shape)
