"""Multi-pod dry run: every (architecture x input-shape x mesh) cell,
reckoned on the ``meta`` device with no process started.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --out experiments/dryrun_torch.json

The port of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell through XLA from ``ShapeDtypeStruct`` stand-ins on 256 or 512
forced host devices and reads XLA's memory and cost analysis.  The port
has no XLA.  Its analog builds the same cells on the ``meta`` device
(``launch/specs.py``), places them by the sharding rules
(``sharding/rules.py``) on the reference's meshes, given as descriptors
(16 x 16 ``data`` x ``model``, 2 x 16 x 16 ``pod`` x ``data`` x ``model``),
and writes the reference's record keys where it can fill them:
``status``, ``chips``, ``params``, ``active_params``, ``tokens_per_step``
and ``memory.argument_bytes``, the bytes one rank holds of the step's
arguments: the train state (params, moments, counters), or the params and
the KV cache, plus the inputs (int32, as the reference's), each leaf's
bytes over the product of the axes that split it.  ``memory`` also
breaks that down (``state_bytes`` or ``params_bytes`` and
``cache_bytes``, ``input_bytes``).

``roofline`` (the reference's ``hlo.analyze(...).row()`` keys): one
rank's step counted on the ``meta`` device (``analysis.hlo_counter``: its
op stream, the kernels' declared work, regions scaled by their trip
counts) with the process groups stood in for by counting ones
(``sharding.collectives.CountingMesh``: the collectives the port's step
issues, with no exchange), times the chips, against an NVIDIA H100's
rates (``analysis.hlo``).  The step is the train step (``model_flops``
the reference's 6 x active params x tokens), or a prefill or decode step
with the params and the cache placed by the rules (``sharding.serving.
ServingStep``; ``model_flops`` 2 x active params x tokens), every
family's: the recurrent families' count their state's moves between the
rules' layout and the mixers' pieces among the collectives, and a serving
row's ``collectives`` gives a rank's bytes a step of those moves
(``state_move_bytes``) beside the head's gather (``head_gather_bytes``).
No ``lower_s`` / ``compile_s`` and none of XLA's temp / output / code
bytes: there is no compile.
"""
from __future__ import annotations

import argparse
import json
import math
import os
from typing import Dict, List, Optional

from repro_torch.sharding import rules

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


def local_bytes(tree, spec_tree, mesh) -> int:
    """Bytes one rank holds of ``tree`` placed by ``spec_tree`` on
    ``mesh`` (a mapping of axis sizes, or a mesh)."""
    sizes = rules.mesh_shape(mesh)
    total: List[int] = []

    def one(spec, t):
        parts = 1
        for entry in spec:
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else tuple(entry))
            parts *= math.prod(sizes[a] for a in axes)
        total.append(t.numel() * t.element_size() // parts)
        return None
    rules.tree_map_specs(one, spec_tree, tree)
    return sum(total)


def _roofline(counter, sizes: Dict[str, int], model_flops: float) -> Dict:
    """The ``roofline`` row of one rank's count on a mesh of ``sizes``."""
    from repro_torch.analysis import hlo
    return hlo.from_counter(
        counter, chips=math.prod(sizes.values()), model_flops=model_flops,
        widest_axis=max(list(sizes.values()) + [
            math.prod(sizes[a] for a in rules.dp_axes(sizes))])).row()


def train_roofline(model, info: Dict, mesh, scale: bool = True,
                   state=None) -> Dict:
    """The ``roofline`` row of one rank's train step of ``model`` at
    ``info`` on ``mesh`` (axis sizes), counted on the ``meta`` device
    (module docstring; ``scale`` false counts every layer and time step
    in full).  ``state`` is the global train state on ``meta``
    (``specs.train_state_sds``), made here if not given."""
    import numpy as np

    from repro_torch.analysis import hlo_counter
    from repro_torch.launch import specs as S
    from repro_torch.sharding import ctx
    from repro_torch.sharding.collectives import CountingMesh
    from repro_torch.train.step import (make_train_step, shard_state,
                                        state_specs)
    cfg = model.cfg
    sizes = rules.mesh_shape(mesh)
    counting = CountingMesh(sizes)
    seq, batch = info["seq"], info["batch"]
    shape = (batch, seq) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
    data = {"tokens": np.zeros(shape, np.int64),
            "labels": np.zeros((batch, seq), np.int64)}
    if state is None:
        state = S.train_state_sds(model)
    state = shard_state(state, counting, state_specs(state, sizes, cfg))
    try:
        counter = hlo_counter.count(make_train_step(model, counting),
                                    state, data, scale=scale)[1]
    finally:
        ctx.set_mesh(None)
    return _roofline(counter, sizes,
                     6.0 * cfg.active_param_count() * batch * seq)


def serving_roofline(model, info: Dict, mesh, scale: bool = True) -> Dict:
    """The ``roofline`` row of one rank's prefill (``info["kind"] ==
    "prefill"``: ``batch`` prompts of ``seq`` tokens into an empty cache)
    or decode step (one token a row against a cache of ``seq`` positions,
    at its last) of ``model`` on ``mesh`` (axis sizes), its params and
    cache placed by the rules (``sharding.serving.ServingStep``), counted
    on the ``meta`` device: the reference's lowered ``prefill`` /
    ``decode_step`` with ``params_specs`` and ``cache_specs``."""
    import torch

    from repro_torch.analysis import hlo_counter
    from repro_torch.launch import specs as S
    from repro_torch.sharding.collectives import CountingMesh
    from repro_torch.sharding.serving import ServingStep
    cfg = model.cfg
    sizes = rules.mesh_shape(mesh)
    seq, batch = info["seq"], info["batch"]
    serve = ServingStep(model, CountingMesh(sizes), batch, seq)
    params = serve.shard_params(S.params_sds(model))
    cache = serve.shard_cache(S.cache_sds(model, "", info=info))
    prefill = info["kind"] == "prefill"
    shape = (batch, seq if prefill else 1) + (
        (cfg.n_codebooks,) if cfg.n_codebooks else ())
    tokens = serve.rows(torch.zeros(shape, dtype=torch.long,
                                    device="meta"))
    if prefill:
        counter = hlo_counter.count(serve.prefill, params, tokens, cache,
                                    scale=scale)[1]
    else:
        counter = hlo_counter.count(serve.decode_step, params, tokens, cache,
                                    seq - 1, scale=scale)[1]
    tokens_per_step = batch * (seq if prefill else 1)
    row = _roofline(counter, sizes,
                    2.0 * cfg.active_param_count() * tokens_per_step)
    # a rank's bytes a step of the collectives the record breaks out
    row["collectives"] = {f"{tag}_bytes": counter.coll_by_tag.get(tag, 0.0)
                          for tag in ("state_move", "head_gather")}
    return row


def reckon(cfg, info: Dict, mesh, roofline: bool = False) -> Dict:
    """The record of one cell: ``cfg`` at ``info`` (``{"seq", "batch",
    "kind"}``, as ``specs.SHAPES``) on ``mesh``; with ``roofline``, its
    ``roofline`` too (module docstring)."""
    from repro_torch.launch import specs as S
    from repro_torch.train.step import state_specs
    sizes = rules.mesh_shape(mesh)
    model = S.model_for(cfg, "", info=info)
    cfg = model.cfg
    data, data_spec = S.input_specs(cfg, "", sizes, info=info)
    memory = {"input_bytes": local_bytes(data, data_spec, sizes)}
    if info["kind"] == "train":
        state = S.train_state_sds(model)
        memory["state_bytes"] = local_bytes(
            state, state_specs(state, sizes, cfg), sizes)
        held = memory["state_bytes"]
        tokens = info["batch"] * info["seq"]
    else:
        params = S.params_sds(model)
        cache = S.cache_sds(model, "", info=info)
        memory["params_bytes"] = local_bytes(
            params, rules.params_specs(params, sizes, cfg), sizes)
        memory["cache_bytes"] = local_bytes(
            cache, rules.cache_specs(cfg, sizes, cache), sizes)
        held = memory["params_bytes"] + memory["cache_bytes"]
        tokens = info["batch"] * (info["seq"] if info["kind"] == "prefill"
                                  else 1)
    memory["argument_bytes"] = held + memory["input_bytes"]
    rec = {"status": "ok", "chips": math.prod(sizes.values()),
           "memory": memory, "tokens_per_step": tokens,
           "params": cfg.param_count(),
           "active_params": cfg.active_param_count()}
    if roofline:
        if info["kind"] == "train":
            rec["roofline"] = train_roofline(model, info, sizes, state=state)
        else:
            rec["roofline"] = serving_roofline(model, info, sizes)
    return rec


def lower_cell(arch: str, shape: str, multi_pod: bool) -> Dict:
    """One cell of the reference's grid (its signature): the config of
    ``arch`` at ``SHAPES[shape]`` on the production mesh."""
    from repro_torch.configs import config
    from repro_torch.launch import specs as S
    cfg = config(arch)
    ok, why = S.shape_applicable(cfg, shape)
    if not ok:
        return {"status": "skipped", "reason": why}
    return reckon(cfg, S.SHAPES[shape], MESHES["multi" if multi_pod
                                                else "single"],
                  roofline=True)


def main(argv: Optional[List[str]] = None) -> int:
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch.specs import SHAPES

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=None,
                    help="write every record to this JSON file")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    results: Dict = {}
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                key = f"{arch}|{shape}|{'multi' if mp else 'single'}"
                rec = lower_cell(arch, shape, mp)
                results[key] = rec
                extra = ""
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    extra = (f" argument_bytes/rank="
                             f"{rec['memory']['argument_bytes']:.4g}"
                             f" chips={rec['chips']}" + (
                                 f" flops={r['flops']:.3g}"
                                 f" coll={r['coll_bytes']:.3g}B"
                                 f" bottleneck={r['bottleneck']}"
                                 if "flops" in r else
                                 f" roofline: {r['error'][:80]}"))
                print(f"[dryrun] {key}: {rec['status']}{extra}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
