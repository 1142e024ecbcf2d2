"""Rank work of ``tests/test_torch_tp_serve.py``: the port's prefill and
decode steps with the params split over ``model`` (``sharding.serving.
ServingStep``) on gloo ranks of the CPU, and one train step of a MoE
config whose experts ``model`` does not divide.  Imports only
``repro_torch`` (and torch, numpy): the parent computes the reference's
values with JAX and sends the params, prompts and states as numpy.

A serving case is ``(mesh shape (data, model), config fields, params in
the reference's layout, prompts (b, s[, K]), lengths or None, decode
steps)``: the rank places the params and a zero cache of the config's
``max_seq`` by the rules, prefills its batch rows, then decodes greedily
(each row's argmax, broadcast to every codebook), at one position for
every row or, with ``lengths``, at each row's own (a (b,) ``pos``).  It
returns its rows' logits of each step, the greedy tokens, its cache
slice, its KV slice and the model group's collectives of each step.
"""
from __future__ import annotations

import torch

from _tp_train_ranks import mesh_of, run_case as train_case


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
    counts = serve.place.model.counts
    counts.clear()
    logits, cache = serve.prefill(params, tokens, cache, lengths=lens)
    out = {"logits": [logits.numpy()], "tokens": [], "kv": serve.kv,
           "counts": [dict(counts)]}
    for i in range(steps):
        counts.clear()
        nxt = logits.argmax(-1)
        out["tokens"].append(nxt.numpy())
        tok = nxt[:, None]
        if cfg.n_codebooks:
            tok = tok[..., None].expand(-1, 1, cfg.n_codebooks)
        pos = (prompts.shape[1] + i if lens is None else lens + i)
        logits, cache = serve.decode_step(params, tok, cache, pos)
        out["logits"].append(logits.numpy())
        out["counts"].append(dict(counts))
    out["cache"] = (cache.k.numpy(), cache.v.numpy())
    return out


def rank_work(rank, world, serve_cases, train_cases):
    """Every serving case, then every train case, of this world size."""
    torch.set_num_threads(1)
    res = {"serve": {name: serve_case(*case)
                     for name, case in serve_cases.items()},
           "train": {}}
    for name, case in train_cases.items():
        res["train"][name] = train_case(*case)[0]
    return res
