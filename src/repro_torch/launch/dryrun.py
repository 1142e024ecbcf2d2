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
``cache_bytes``, ``input_bytes``).  It writes no ``roofline``, no
``lower_s`` / ``compile_s`` and none of XLA's temp / output / code bytes:
the HLO analysis (``analysis/hlo.py``) is ROADMAP.md queue 1 item 8.
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


def reckon(cfg, info: Dict, mesh) -> Dict:
    """The record of one cell: ``cfg`` at ``info`` (``{"seq", "batch",
    "kind"}``, as ``specs.SHAPES``) on ``mesh``."""
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
    return {"status": "ok", "chips": math.prod(sizes.values()),
            "memory": memory, "tokens_per_step": tokens,
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count()}


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
                                                else "single"])


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
                    extra = (f" argument_bytes/rank="
                             f"{rec['memory']['argument_bytes']:.4g}"
                             f" chips={rec['chips']}")
                print(f"[dryrun] {key}: {rec['status']}{extra}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
