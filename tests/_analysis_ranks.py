"""Rank work of ``tests/test_torch_analysis.py``: one tensor-parallel train
step counted by ``repro_torch.analysis.hlo_counter`` on a real gloo rank
of the CPU.  Imports only ``repro_torch`` (and torch, numpy)."""
from __future__ import annotations

import numpy as np
import torch

STEP = dict(base_lr=1e-2, warmup=1, total_steps=20)


def batch(cfg, b: int, s: int):
    shape = (b, s) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
    return {"tokens": np.zeros(shape, np.int64),
            "labels": np.zeros((b, s), np.int64)}


def rank_work(rank, world, cases):
    """Each case ``(arch, config fields, (data, model), (b, s))``: one step
    from seed 0 on a real mesh of ``world`` gloo ranks, counted with and
    without scaling; per case and scale the counter's totals, kernel calls
    and collective calls."""
    torch.set_num_threads(1)
    from repro_torch.analysis import hlo_counter
    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.sharding import ctx
    from repro_torch.train import step as tstep
    out = {}
    for name, (arch, kw, shape, (b, s)) in cases.items():
        cfg = smoke_config(arch, **kw)
        model = Model(cfg)
        mesh = make_mesh(tuple(shape), ("data", "model"), "cpu")
        for scale in (False, True):
            state = tstep.make_train_state(
                model, torch.Generator().manual_seed(0), device="cpu",
                mesh=mesh)
            step = tstep.make_train_step(model, mesh, **STEP)
            _, c = hlo_counter.count(step, state, batch(cfg, b, s),
                                     scale=scale)
            t = c.totals
            out[(name, scale)] = {
                "totals": (t.flops, t.bytes, t.bytes_min, t.coll_bytes,
                           t.coll_count, dict(t.coll_by_kind)),
                "kernels": dict(c.kernels), "coll_calls": dict(c.coll_calls)}
        ctx.set_mesh(None)
    return out
