"""Rank work of ``tests/test_torch_recurrent_tp_serve.py``: the recurrent
families' prefill and decode steps with the params split over ``model``
(``sharding.serving.ServingStep``) on gloo ranks of the CPU.  Imports only
``repro_torch`` (and torch, numpy): the parent computes the reference's
values with JAX and sends the params and prompts as numpy.

A case is ``(mesh shape (data, model), config fields, params in the
reference's layout, prompts (b, s), lengths or None, decode steps)``: the
rank places the params and a zero cache of the config's ``max_seq`` by
the rules, prefills its batch rows, then decodes greedily, at one
position for every row or, with ``lengths``, at each row's own.  It
returns its rows' logits of each step, the greedy tokens, its cache
piece after the prefill and after the last step (each leaf by its path),
and the collectives of each step by group.
"""
from __future__ import annotations

import torch

from _tp_train_ranks import mesh_of


def cache_leaves(cache, prefix: str = "") -> dict:
    """``{path: numpy}`` of a serving cache (NamedTuples and dicts)."""
    fields = getattr(cache, "_fields", None)
    if fields is not None:
        return {f"{prefix}{f}": getattr(cache, f).numpy().copy()
                for f in fields}
    out = {}
    for k, v in cache.items():
        out.update(cache_leaves(v, f"{prefix}{k}/"))
    return out


def serve_case(shape, cfg_kw, np_params, prompts, lengths, steps):
    from repro_torch.models.common import ModelConfig
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.transformer import Model
    from repro_torch.sharding.serving import ServingStep
    cfg = ModelConfig(**cfg_kw)
    model = Model(cfg)
    mesh = mesh_of(tuple(shape))
    b = prompts.shape[0]
    serve = ServingStep(model, mesh, b, cfg.max_seq)
    params = serve.shard_params(params_from_numpy(cfg, np_params,
                                                  device="cpu"))
    cache = serve.shard_cache(model.init_cache(b, cfg.max_seq, "cpu"))
    tokens = serve.rows(torch.as_tensor(prompts, dtype=torch.long))
    lens = None if lengths is None else serve.rows(
        torch.as_tensor(lengths, dtype=torch.long))
    groups = {"data": serve.place.group, "model": serve.place.model}

    def counts():
        return {k: dict(g.counts) for k, g in groups.items()}
    for g in groups.values():
        g.counts.clear()
    logits, cache = serve.prefill(params, tokens, cache, lengths=lens)
    out = {"logits": [logits.numpy()], "tokens": [], "kv": serve.kv,
           "state": serve.state, "counts": [counts()],
           "prefill_cache": cache_leaves(cache)}
    for i in range(steps):
        for g in groups.values():
            g.counts.clear()
        nxt = logits.argmax(-1)
        out["tokens"].append(nxt.numpy())
        pos = (prompts.shape[1] + i if lens is None else lens + i)
        logits, cache = serve.decode_step(params, nxt[:, None], cache, pos)
        out["logits"].append(logits.numpy())
        out["counts"].append(counts())
    out["cache"] = cache_leaves(cache)
    return out


def moves_case(cfg_kw, shape, batch):
    """The state moves alone: for each state leaf of a serving cache of
    ``batch`` rows, a random global leaf (the same on every rank), its
    rules piece moved into the mixer's piece and back, a unit (a layer,
    or a hybrid group) at a time.  Returns ``{leaf: (the mixer's piece is
    the global leaf's rows and heads of the rank, the piece moved back is
    the rules piece)}``."""
    from repro_torch.models.common import ModelConfig
    from repro_torch.models.transformer import Model
    from repro_torch.sharding import rules
    from repro_torch.sharding.collectives import (DataGroup, ModelGroup,
                                                  TensorParallel)
    cfg = ModelConfig(**cfg_kw)
    mesh = mesh_of(tuple(shape))
    data, model = DataGroup(mesh), ModelGroup(mesh)
    coord = dict(zip(rules.mesh_shape(mesh), mesh.get_coordinate()))
    meta = Model(cfg).init_cache(batch, cfg.max_seq, device="meta")
    state = rules.state_slice(cfg, mesh, meta, coord)
    tp = TensorParallel(model, {}, cfg, 1, state=state, data=data)
    gen = torch.Generator().manual_seed(5)
    out = {}
    for leaf, info in state.items():
        whole = torch.randn(info["shape"], generator=gen)
        local = rules.local_shard(whole, mesh, info["spec"], coord).clone()
        bdim = 1 if leaf.startswith("mamba/") else 0
        ok = [True, True]
        for i in range(whole.shape[0]):
            want = whole[i]
            if batch % data.size == 0:
                n = batch // data.size
                want = want.narrow(bdim, data.index * n, n)
            if tp.split_mixer and leaf == "mamba/conv":
                want = torch.cat([want[..., lo:hi] for lo, hi in
                                  tp.mamba_columns(cfg)["conv_w"]], -1)
            elif tp.split_mixer and leaf in ("wkv", "mamba/ssm"):
                h0, h1 = tp.mixer_heads
                want = want.narrow(bdim + 1, h0, h1 - h0)
            got = tp.state_in(leaf, local[i])
            ok[0] &= bool(torch.equal(got, want))
            back = torch.full_like(local[i], float("nan"))
            tp.state_out(leaf, got, back)
            ok[1] &= bool(torch.equal(back, local[i]))
        out[leaf] = tuple(ok)
    return out


def rank_work(rank, world, cases, moves):
    """Every serving case and every state-move case of this world size."""
    torch.set_num_threads(1)
    return {"serve": {name: serve_case(*case)
                      for name, case in cases.items()},
            "moves": {name: moves_case(*case)
                      for name, case in moves.items()}}
