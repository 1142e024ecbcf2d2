#!/usr/bin/env python3
"""Serving throughput of this tree against another checkout, on one card.

    python3 tools/serve_against_parent.py [PARENT_DIR] [--unpack REV]
                                          [--rounds R] [--traced]

``PARENT_DIR`` (default ``build/parent``) is an unpacked tree of another
commit; ``--unpack REV`` makes it first with ``git archive REV | tar -x``
(where the checkout is a git repository).  ``R`` rounds (default 1) of
four processes, in the order parent, this, this, parent, each import
``repro_torch`` from their tree, build chip_smoke's qwen3-4b (full width,
bf16, random weights from seed 0) and serve chip_smoke's traffic:

- ``static``: phase 4's 4 requests through ``BatchedEngine`` (graph);
- ``graph`` / ``eager``: phase 4b's 8 requests through a dense
  ``ContinuousEngine`` with the decode chunk a CUDA graph / eager;

one warm-up run each, then three timed runs of each in turns, each timed
on the host clock and ended by a device sync (tok/s).  ``--traced`` adds
three runs of each with this tree's tracing on (``repro_torch.obs``; the
parent tree has none), in the same turns.

It prints one JSON line (also written to
``build/serve_against_parent/report.json``) with the card's name and power
limit, every run's tok/s per tree and the medians, and exits 1 if a
tree's runs of one engine differ in tokens or the trees' tokens differ.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
WORK = ROOT / "build" / "serve_against_parent"
ENGINES = ("static", "graph", "eager")


def _timed(engine, reqs, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = engine.run(reqs, **kw)
    torch.cuda.synchronize()
    return toks, sum(map(len, toks)) / (time.perf_counter() - t0)


def worker(src: str, out: str, traced: str) -> None:
    """Serve the three engines with the ``repro_torch`` under ``src``; save
    their tokens and tok/s."""
    sys.path.insert(0, src)
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.launch import serve
    from repro_torch.serve.engine import BatchedEngine
    obs = None
    if traced == "traced":
        from repro_torch import obs
    cfg, model, params = serve.build(cs.ARCH, seed=0)
    static_reqs = serve.make_requests(cfg.vocab, cs.PROMPT_LENS, cs.MAX_NEW,
                                      seed=1)
    static_reqs[1].temperature, static_reqs[1].top_k = 0.8, 50
    cont_reqs = cs.continuous_requests(cfg.vocab)
    engines = {
        "static": (BatchedEngine(
            model, params, max_seq=max(cs.PROMPT_LENS) + cs.MAX_NEW
            + cs.CHUNK, chunk=cs.CHUNK), static_reqs, {}),
        "graph": (cs.continuous_engine(model, params, "dense", True),
                  cont_reqs, {"seed": 5}),
        "eager": (cs.continuous_engine(model, params, "dense", False),
                  cont_reqs, {"seed": 5})}
    res = {name: {"tok_s": [], "tok_s_traced": []} for name in engines}
    for name, (engine, reqs, kw) in engines.items():
        res[name]["tokens"] = engine.run(reqs, **kw)          # warm-up
    modes = [False, True, True, False, False, True] if obs else [False] * 3
    for traced_run in modes:
        for name, (engine, reqs, kw) in engines.items():
            if traced_run:
                obs.clear_trace()
                obs.enable()
            try:
                toks, tok_s = _timed(engine, reqs, **kw)
            finally:
                if traced_run:
                    obs.disable()
            if toks != res[name]["tokens"]:
                raise AssertionError(f"{src} {name}: runs gave other tokens")
            res[name]["tok_s_traced" if traced_run else "tok_s"].append(tok_s)
    print(f"  {src}: " + json.dumps({n: {k: v for k, v in r.items()
                                         if k != "tokens"}
                                     for n, r in res.items()}), flush=True)
    torch.save(res, out)


def main(parent: Path, unpack: str | None, rounds: int,
         traced: bool) -> int:
    if unpack:
        parent.mkdir(parents=True, exist_ok=True)
        archive = subprocess.run(["git", "-C", str(ROOT), "archive", unpack],
                                 check=True, capture_output=True).stdout
        subprocess.run(["tar", "-x", "-C", str(parent)], input=archive,
                       check=True)
    if not torch.cuda.is_available():
        print("serve_against_parent: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    WORK.mkdir(parents=True, exist_ok=True)
    trees = {"parent": str(parent.resolve() / "src"),
             "this": str(ROOT / "src")}
    runs = {"parent": [], "this": []}
    for i, side in enumerate(("parent", "this", "this", "parent") * rounds):
        out = WORK / f"run{i}-{side}.pt"
        subprocess.run([sys.executable, __file__, "--worker", trees[side],
                        str(out), "traced" if traced and side == "this"
                        else "plain"], check=True, timeout=1200)
        runs[side].append(torch.load(out))
    report, ok = {"card": smi, "parent": str(parent)}, True
    for name in ENGINES:
        row = {}
        for side, rs in runs.items():
            row[side] = [x for r in rs for x in r[name]["tok_s"]]
            row[f"{side}_median"] = statistics.median(row[side])
            same = all(r[name]["tokens"] == rs[0][name]["tokens"] for r in rs)
            row[f"{side}_runs_equal"] = same
            ok &= same
        traced_runs = [x for r in runs["this"] for x in r[name]["tok_s_traced"]]
        if traced_runs:
            row["this_traced"] = traced_runs
            row["this_traced_median"] = statistics.median(traced_runs)
        row["trees_equal"] = (runs["parent"][0][name]["tokens"]
                              == runs["this"][0][name]["tokens"])
        row["this_over_parent"] = row["this_median"] / row["parent_median"]
        ok &= row["trees_equal"]
        report[name] = row
    line = json.dumps(report)
    (WORK / "report.json").write_text(line + "\n")
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(*sys.argv[2:5])
        sys.exit(0)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", nargs="?", type=Path,
                    default=ROOT / "build" / "parent")
    ap.add_argument("--unpack", metavar="REV")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--traced", action="store_true")
    args = ap.parse_args()
    sys.exit(main(args.parent, args.unpack, args.rounds, args.traced))
