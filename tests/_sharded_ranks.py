"""The rank side of ``tests/test_torch_sharded.py``: ``ShardedEngine`` on
spawned gloo ranks (``repro_torch.testing.ranks``).

A spawned rank unpickles :func:`rank_work` by importing this module, so it
imports torch, numpy and ``repro_torch`` only (no JAX, nothing of
``repro``).  The weights arrive as numpy arrays.

One call runs, in order and on every rank alike: the clean runs (dense and
paged, ``data=4``, ``hosts=2``), ``elastic_remesh``, the host-loss drills
of the reference's ``tests/test_domains.py`` (host loss with a journal and
a tuning cache, collective timeout, straggler escalation), the same loss
while a prompt is still prefilling (dense and paged) and with the groups
taken for NCCL's (dense and paged), the journal drill that walks away after a loss, the serving fault drills of
``tests/test_torch_resilience.py`` and a deadline.  Each returns what the
test compares; a rank whose host was lost returns None for its tokens.
"""
from __future__ import annotations

import collections
import contextlib
import os

import numpy as np
import torch

TINY = dict(name="dom-t", family="dense", n_layers=2, d_model=32,
            n_heads=4, n_kv_heads=2, d_ff=64, vocab=128, dtype="float32",
            remat=False, max_seq=64)
# the reference drill's traffic (tests/test_domains.py DRILL_COMMON):
# (prompt length, temperature, top-k), 16 new tokens each, chunk 4
SPEC = [(3, 0.0, 0), (9, 0.8, 4), (5, 0.0, 0), (12, 1.2, 0),
        (4, 0.0, 0), (6, 0.0, 0), (7, 0.9, 3), (8, 0.0, 0)]
MAX_NEW = 16
ENGINE = dict(max_seq=64, slots=8, chunk=4)
# a prompt of 12 prefills in three chunks of 4
STAGED = dict(prefill_chunk=4, min_bucket=4)
SEED = 7
HOSTS = 2
FAULTS = "serve.nan_prefill(req_id=1); serve.nan_decode(req_id=2)"
CHUNK_ERROR = "serve.chunk_error(times=3)"
NCCL_SHORT = 2        # the paged NCCL-route drill's request 0 ends here
COLLECTIVES = ("all_gather", "all_gather_object", "all_reduce", "broadcast",
               "all_to_all", "reduce_scatter", "gather", "scatter")


def prompts():
    rng = np.random.RandomState(1)
    return [rng.randint(0, TINY["vocab"], (n,)) for n, _, _ in SPEC]


def requests(**kw):
    from repro_torch.serve.engine import Request
    return [Request(p.tolist(), max_new_tokens=MAX_NEW, temperature=t,
                    top_k=k, **kw)
            for p, (_, t, k) in zip(prompts(), SPEC)]


def model_and_params(np_params):
    from repro_torch.models.common import ModelConfig
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.transformer import Model
    cfg = ModelConfig(**TINY)
    return Model(cfg), params_from_numpy(cfg, np_params, device="cpu")


def _count_collectives(calls):
    """Count every call to a collective of ``torch.distributed`` the engine
    makes (it calls them through the module)."""
    import torch.distributed as dist

    def wrap(name, fn):
        def counted(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return counted
    for name in COLLECTIVES:
        setattr(dist, name, wrap(name, getattr(dist, name)))


@contextlib.contextmanager
def exchange_as_nccl(seen):
    """Make an engine built inside take its groups for NCCL ones
    (``dist.get_backend`` reads ``"nccl"``), so it hands the gathers the
    tensors NCCL would take, while they still run over gloo through the
    host.  Each gather appends ``(input's device type, the outputs'
    device types, dtype, elements)`` to ``seen``."""
    import torch.distributed as dist
    backend, gather = dist.get_backend, dist.all_gather

    def all_gather(out, t, group=None, **kw):
        seen.append((t.device.type, sorted({o.device.type for o in out}),
                     str(t.dtype), t.numel()))
        host = [torch.empty_like(o, device="cpu") for o in out]
        gather(host, t.cpu(), group=group, **kw)
        for o, h in zip(out, host):
            o.copy_(h)
    dist.get_backend = lambda group=None: "nccl"
    dist.all_gather = all_gather
    try:
        yield
    finally:
        dist.get_backend, dist.all_gather = backend, gather


def _drive(eng, reqs, seed=SEED, boundaries=None):
    """``run_results`` step by step: the boundaries it took and the
    results (None where this rank left the mesh)."""
    with eng._options_scope():
        eng._run_seed = seed
        rids = [eng.submit(r, stream=i) for i, r in enumerate(reqs)]
        n = 0
        while not eng.sched.idle and not eng.left:
            if boundaries is not None and n == boundaries:
                return n, None
            eng.step_chunk()
            n += 1
    if eng.left:
        return n, None
    return n, [(r.tokens, r.state, r.reason)
               for r in map(eng.take_result, rids)]


def _summary(eng):
    st = eng.stats()
    return {"mesh": st["mesh"], "resilience": st["resilience"],
            "scheduler": st["scheduler"], "prefills": st["prefills"],
            "left": eng.left}


def _journal(path):
    """A journal file folded (None where no rank wrote it)."""
    from repro_torch.serve.domains import SchedulerJournal
    if not os.path.exists(path):
        return None
    state = SchedulerJournal.load(path)
    return {"clean": state.clean, "shrinks": state.shrinks,
            "evacuations": state.evacuations,
            "terminals": {r: s for r, (s, _) in state.terminals.items()},
            "emitted": {r: q["emitted"] for r, q in state.requests.items()}}


def rank_work(rank, world, np_params, tmp):
    torch.set_num_threads(1)
    from repro_torch import obs
    from repro_torch.autotune import TuningCache
    from repro_torch.ft.resilience import elastic_remesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.domains import FailureDomains
    from repro_torch.serve.engine import ShardedEngine
    from repro_torch.testing import faults
    model, params = model_and_params(np_params)
    mesh = make_mesh((world,), ("data",), "cpu")
    out = {"rank": rank}

    def sharded(**kw):
        return ShardedEngine(model, params, mesh=mesh, **{**ENGINE, **kw})

    calls = collections.Counter()
    _count_collectives(calls)

    def drill(name, plan, reqs=None, **kw):
        """One fresh engine run under ``plan``: its boundaries, results,
        counters, flight dumps and provenance."""
        obs.flight_clear()
        obs.clear_decisions()
        eng = sharded(**kw)
        calls.clear()
        with faults.inject(plan) as fired:
            n, results = _drive(eng, reqs or requests())
        out[name] = {"boundaries": n, "results": results,
                     "collectives": dict(calls),
                     "fired": [f.fired for f in fired],
                     "dumps": [d["reason"] for d in obs.flight_dumps()],
                     "dump_ctx": [d["ctx"] for d in obs.flight_dumps()],
                     "explain": obs.explain(), **_summary(eng)}
        return eng

    # -- clean runs: one gather a boundary, silent -------------------------
    for layout in ("dense", "paged"):
        drill(f"clean_{layout}", [], kv_layout=layout, hosts=HOSTS)
    # run() itself, the API a user calls
    eng = sharded(hosts="auto")
    out["run"] = eng.run(requests(), seed=SEED)
    out["auto_hosts"] = eng.stats()["mesh"]["hosts"]

    # -- elastic_remesh on the 4 ranks -------------------------------------
    out["remesh"] = {desc: dict(zip(m.mesh_dim_names, m.shape))
                     for desc, m in (("data=16", elastic_remesh(
                         "data=16", device_type="cpu")),
                                     ("data=4", elastic_remesh(
                                         "data=4", device_type="cpu")))}
    out["remesh_tuple"] = tuple(elastic_remesh(
        (8,), ("data",), device_type="cpu").shape)
    # a shape below the world size: ranks 0-2, rank 3 outside the mesh
    three = elastic_remesh("data=3", device_type="cpu")
    out["remesh_three"] = (tuple(three.shape), three.get_coordinate())

    # -- host 1 dies mid-decode, journal and tuning cache ------------------
    # every rank journals to <path>.rank<rank>
    jpath = os.path.join(tmp, "loss.jsonl")
    tc = TuningCache(os.path.join(tmp, f"tc-{rank}.json"))
    drill("loss", "mesh.host_lost(host=1, after=3)", hosts=HOSTS,
          journal=jpath, tuning_cache=tc)
    out["loss"]["tuned_descriptors"] = sorted(
        {k.rsplit("|", 1)[-1] for k in tc._mem})
    out["loss"]["journal"] = _journal(f"{jpath}.rank{rank}")
    # the same loss in the paged layout
    drill("loss_paged", "mesh.host_lost(host=1, after=3)", hosts=HOSTS,
          kv_layout="paged")
    # ... and while rank 1's 12-token prompt is still prefilling: its
    # staging cache (dense) or pages (paged) move to rank 0
    for layout in ("dense", "paged"):
        drill(f"staged_{layout}", "mesh.host_lost(host=1, after=1)",
              hosts=HOSTS, kv_layout=layout, **STAGED)

    # -- the same loss with the groups taken for NCCL's: every gather gets
    # tensors on the engine's device.  Paged, request 0 ends at its second
    # token, so at the loss rank 0 owns fewer live pages than rank 1 (its
    # buffer is padded) and an evacuee re-admits into the freed slot 0
    short = requests()
    short[0].max_new_tokens = NCCL_SHORT
    for layout, reqs in (("dense", None), ("paged", short)):
        seen = []
        with exchange_as_nccl(seen):
            eng = drill(f"nccl_{layout}", "mesh.host_lost(host=1, after=3)",
                        reqs, hosts=HOSTS, kv_layout=layout)
        out[f"nccl_{layout}"].update(
            gathers=seen, device=eng.device.type,
            pool_bytes=(2 * eng.st.cache.k.numel()
                        * eng.st.cache.k.element_size()
                        if eng.st is not None else None))

    # -- one rank a host: 8 slots do not divide 3 positions, so the loss of
    # host 3 drops host 2 from the tail too (the reference's loop) -------
    drill("tail", "mesh.host_lost(host=3, after=2)", hosts=world)
    # ... and a second loss in that engine needs the ranks that left
    try:
        drill("second", "mesh.host_lost(host=3, after=2); "
              "mesh.host_lost(host=1, after=4)", hosts=world)
        out["second"]["error"] = None
    except RuntimeError as e:
        out["second"] = {"error": str(e)}

    # -- collective timeout: the presumed-dead host is the last alive ------
    drill("timeout", "collective.timeout(after=2)", hosts=HOSTS)
    # -- straggler escalation on host 0: the survivors are the tail half ---
    spath = os.path.join(tmp, "slow.jsonl")
    drill("slow", "mesh.host_slow(host=0, times=2, value=0.0)", hosts=HOSTS,
          host_slow_threshold=2, journal=spath)
    out["slow"]["journal"] = _journal(f"{spath}.rank{rank}")

    # -- a journal through a host loss, then the engine walks away ---------
    rpath = os.path.join(tmp, "replay.jsonl")
    eng = sharded(hosts=HOSTS, journal=rpath)
    with faults.inject("mesh.host_lost(host=1, after=1)"):
        _drive(eng, requests(), boundaries=3)
    out["replay_left"] = eng.left

    # -- serving faults on the sharded engine ------------------------------
    drill("faults", FAULTS)
    drill("chunk_error", CHUNK_ERROR)
    # -- a deadline on the mesh clock: every rank expires it alike ---------
    obs.flight_clear()
    eng = sharded()
    reqs = requests()
    reqs[3].deadline_s = 1e-6
    out["deadline"] = _drive(eng, reqs)[1]

    # -- the mesh from the process context, a second axis, other weights --
    from repro_torch.sharding import ctx
    ctx.set_mesh(mesh)
    try:
        out["ctx_mesh"] = ShardedEngine(model, params, **ENGINE).stats()[
            "mesh"]["descriptor"]
    finally:
        ctx.set_mesh(None)
    grid = make_mesh((2, 2), ("data", "model"), "cpu")
    eng = ShardedEngine(model, params, mesh=grid, **ENGINE)
    out["two_axes"] = {"results": _drive(eng, requests())[1],
                       **_summary(eng)}
    if rank == 1:
        params = {**params, "embed": params["embed"] + 1e-3}
    try:
        sharded()
        out["other_weights"] = None
    except ValueError as e:
        out["other_weights"] = str(e)

    # -- FailureDomains on the live mesh -----------------------------------
    dom = FailureDomains(mesh, hosts=HOSTS)
    out["domains"] = {"groups": dom.groups, "ranks": dom.ranks,
                      "slots_of_host": [dom.slots_of_host(h, 8)
                                        for h in range(HOSTS)]}
    return out
