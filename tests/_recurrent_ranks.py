"""The rank side of ``tests/test_torch_recurrent.py``: the recurrent
families on spawned gloo ranks (``repro_torch.testing.ranks``).

A spawned rank unpickles :func:`rank_work` by importing this module, so it
imports torch, numpy and ``repro_torch`` only (no JAX, nothing of
``repro``).  Params and train states arrive as numpy, in the reference's
layout.

One call runs, on every rank alike: the DP and FSDP train steps of both
smoke configs on ``data=2``, and zamba2's with 8-bit moments under FSDP
(two steps each, the whole state gathered after each), and
``ShardedEngine`` with rwkv6 on
``data=2, hosts=2`` through one host loss (dense and paged; at decode,
and while a prompt is still prefilling).
"""
from __future__ import annotations

import numpy as np
import torch

from _sharded_train_ranks import numpy_state

STEP = dict(base_lr=1e-2, warmup=1, total_steps=20)
# the drill traffic: greedy prompts of 3-12 tokens, 10 new tokens, chunk 4
PROMPTS = (3, 9, 5, 12)
MAX_NEW = 10
ENGINE = dict(max_seq=48, slots=4, chunk=4)
STAGED = dict(prefill_chunk=4, min_bucket=4)


def prompts(vocab):
    rng = np.random.RandomState(11)
    return [rng.randint(0, vocab, (n,)) for n in PROMPTS]


def one_device_steps(arch, np_state, batches, **cfg_kw):
    """The port's one-device step from the reference's state: per step
    ``(metrics, whole state as numpy)``."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.convert import train_state_from_numpy
    from repro_torch.models.transformer import Model
    from repro_torch.train import step as tstep
    cfg = smoke_config(arch, **cfg_kw)
    state = train_state_from_numpy(cfg, np_state, device="cpu")
    step = tstep.make_train_step(Model(cfg), **STEP)
    out = []
    for batch in batches:
        state, m = step(state, batch)
        out.append((m, numpy_state(state)))
    return out


def _sharded_steps(mesh, arch, np_state, batches, **cfg_kw):
    from repro_torch.configs import smoke_config
    from repro_torch.launch.dryrun import local_bytes
    from repro_torch.models.convert import train_state_from_numpy
    from repro_torch.models.transformer import Model
    from repro_torch.train import step as tstep
    cfg = smoke_config(arch, **cfg_kw)
    whole = train_state_from_numpy(cfg, np_state, device="cpu")
    specs = tstep.state_specs(whole, mesh, cfg)
    state = tstep.shard_state(whole, mesh, specs)
    held = sum(a.nbytes for _, a in numpy_state(state))
    step = tstep.make_train_step(Model(cfg), mesh, **STEP)
    out = []
    for batch in batches:
        state, m = step(state, batch)
        out.append((m, numpy_state(tstep.gather_state(state, mesh, specs))))
    return {"steps": out, "held": held,
            "reckoned": local_bytes(whole, specs, mesh)}


def _engine_drill(mesh, np_params, plan, **kw):
    from repro_torch.configs import smoke_config
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.transformer import Model
    from repro_torch.serve.engine import Request, ShardedEngine
    from repro_torch.testing import faults
    cfg = smoke_config("rwkv6_1_6b")
    model = Model(cfg)
    params = params_from_numpy(cfg, np_params, device="cpu")
    eng = ShardedEngine(model, params, mesh=mesh, hosts=2,
                        **{**ENGINE, **kw})
    reqs = [Request(p.tolist(), max_new_tokens=MAX_NEW)
            for p in prompts(cfg.vocab)]
    with faults.inject(plan) as fired:
        results = eng.run(reqs)
    return {"tokens": results, "left": eng.left,
            "fired": [f.fired for f in fired],
            "host_losses": eng.stats()["resilience"]["host_losses"]}


def rank_work(rank, world, ref, _tmp):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_mesh
    out = {"rank": rank}
    mesh = make_mesh((world, 1), ("data", "model"), "cpu")
    for case, (arch, cfg_kw, np_state, batches) in ref["train"].items():
        for fsdp in (False, True):
            if cfg_kw.get("opt_8bit") and not fsdp:
                continue
            out[f"{case}_{'fsdp' if fsdp else 'dp'}"] = _sharded_steps(
                mesh, arch, np_state, batches, fsdp=fsdp, **cfg_kw)
    data = make_mesh((world,), ("data",), "cpu")
    loss = "mesh.host_lost(host=1, after=2)"
    for layout in ("dense", "paged"):
        out[f"clean_{layout}"] = _engine_drill(data, ref["engine"], [],
                                               kv_layout=layout)
        out[f"loss_{layout}"] = _engine_drill(data, ref["engine"], loss,
                                              kv_layout=layout)
        # host 1 dies while slot 3's prompt of 12 is in its second chunk
        out[f"staged_{layout}"] = _engine_drill(
            data, ref["engine"], "mesh.host_lost(host=1, after=1)",
            kv_layout=layout, **STAGED)
    return out
