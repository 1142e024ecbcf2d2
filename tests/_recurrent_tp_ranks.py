"""Rank work of ``tests/test_torch_recurrent_tp.py``: the recurrent
families' train step on a mesh's model axis (TP and SP, with DP or FSDP
on the data axis) on gloo ranks of the CPU.  Imports only
``repro_torch`` (and torch, numpy, the port-only helpers of
``_tp_train_ranks``): the parent sends the reference's initial states and
the batches as numpy.

A case is ``(mesh shape (data, model), config fields, numpy state in the
reference's layout, batches)``; :func:`_tp_train_ranks.run_case` runs the
sharded step from it and returns, per step, the metrics, the whole state
again as numpy in the port's layout and the collectives by group, with
the rank's state bytes.
"""
from __future__ import annotations

import os

import torch

from _tp_train_ranks import mesh_of, numpy_state, run_case, setup


def _run_all(cases):
    torch.set_num_threads(1)
    out = {}
    for name, (shape, cfg_kw, state, batches) in cases.items():
        out[name] = run_case(shape, cfg_kw, {}, state, batches[:2])
    return out


def rank_work_four(rank, world, cases, tmp, ckpt_name):
    """Every case on a 4-rank mesh; the state of ``ckpt_name`` (``data=2,
    model=2``) checkpointed after its two steps, then one more step."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.train import step as tstep
    res = {"runs": {}}
    for name, (out, local, specs, step) in _run_all(cases).items():
        res["runs"][name] = out
        if name == ckpt_name:
            shape, _, _, batches = cases[name]
            mesh = mesh_of(tuple(shape))
            mgr = CheckpointManager(os.path.join(tmp, "rec_tp_ckpt"),
                                    mesh=mesh, specs=specs, async_save=False)
            mgr.save(2, local, extra={"data_state": {"step": 2}})
            local, m = step(local, batches[2])
            res["after_save"] = (m, numpy_state(
                tstep.gather_state(local, mesh, specs)))
    return res


def rank_work_two(rank, world, cases, tmp, ckpt_case):
    """Every case on ``model=2``; then the checkpoint saved on ``data=2,
    model=2`` restored here, bitwise, and one more step."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.train import step as tstep
    res = {"runs": {name: r[0] for name, r in _run_all(cases).items()}}
    cfg_kw, state, batch = ckpt_case
    mesh, _, template, specs, step = setup((1, 2), cfg_kw, state)
    mgr = CheckpointManager(os.path.join(tmp, "rec_tp_ckpt"), mesh=mesh,
                            specs=specs)
    step_no, restored, extra = mgr.restore_latest(template)
    res["restored"] = (step_no, extra, numpy_state(
        tstep.gather_state(restored, mesh, specs)))
    restored, m = step(restored, batch)
    res["after_restore"] = (m, numpy_state(
        tstep.gather_state(restored, mesh, specs)))
    return res
