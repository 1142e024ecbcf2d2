#!/usr/bin/env python3
"""K1 (RMSNorm) and the serving run against another checkout, on one card.

    python3 tools/k1_against_parent.py [PARENT_DIR] [--unpack REV]
                                       [--kernels-only] [--rounds R]

``PARENT_DIR`` (default ``build/parent``) is an unpacked tree of another
commit; ``--unpack REV`` makes it first with ``git archive REV | tar -x``
(where the checkout is a git repository).  ``R`` rounds (default 1) of
four processes, in the order parent, this, this, parent, each import
``repro_torch`` from their tree and

- run ``ops.rmsnorm`` on the same seeded bf16 inputs at the six main-path
  shapes of chip_smoke phase 3, timing each call on the card
  (chip_smoke's CUDA-graph replays, ``ms``) and from Python (``eager_ms``);
- serve chip_smoke phase 4's requests (qwen3-4b at full width, bf16, random
  weights from seed 0; one warm-up run, then three timed runs), each
  timed on the host clock and ended by a device sync (tok/s); not with
  ``--kernels-only``.

It prints one JSON line (also written to
``build/k1_against_parent/report.json``) with the card's name and power
limit, and exits 1 if a tree's two runs differ (outputs or tokens) or the
trees' K1 outputs differ beyond chip_smoke's bf16 tolerance.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
WORK = ROOT / "build" / "k1_against_parent"


def worker(src: str, inputs: str, out: str, serve_too: str) -> None:
    """Time K1 and one serving run with the ``repro_torch`` under ``src``;
    save the outputs, tokens and times."""
    sys.path.insert(0, src)
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serve.engine import BatchedEngine
    res = {"rmsnorm": {}}
    for key, (x, w) in torch.load(inputs).items():
        x, w = x.cuda(), w.cuda()
        got = ops.rmsnorm(x, w)
        torch.cuda.synchronize()
        res["rmsnorm"][key] = {
            "out": got.cpu(), "ms": cs.time_ms(lambda: ops.rmsnorm(x, w)),
            "eager_ms": cs.eager_ms(lambda: ops.rmsnorm(x, w))}
        print(f"  {src} rmsnorm {key}: {res['rmsnorm'][key]['ms']} ms, "
              f"eager {res['rmsnorm'][key]['eager_ms']} ms", flush=True)
    if serve_too != "serve":
        torch.save(res, out)
        return
    cfg, model, params = serve.build(cs.ARCH, seed=0)
    reqs = serve.make_requests(cfg.vocab, cs.PROMPT_LENS, cs.MAX_NEW, seed=1)
    reqs[1].temperature, reqs[1].top_k = 0.8, 50
    engine = BatchedEngine(model, params,
                           max_seq=max(cs.PROMPT_LENS) + cs.MAX_NEW + cs.CHUNK,
                           chunk=cs.CHUNK)
    first = engine.run(reqs)                  # warm-up
    tok_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = engine.run(reqs)
        torch.cuda.synchronize()
        tok_s.append(sum(len(t) for t in toks) / (time.perf_counter() - t0))
        if toks != first:
            raise AssertionError(f"{src}: two runs gave different tokens")
    res["serve"] = {"tokens": toks, "tok_s": tok_s}
    print(f"  {src} serve: {tok_s} tok/s", flush=True)
    torch.save(res, out)


def main(parent: Path, unpack: str | None, kernels_only: bool,
         rounds: int) -> int:
    if unpack:
        parent.mkdir(parents=True, exist_ok=True)
        archive = subprocess.run(["git", "-C", str(ROOT), "archive", unpack],
                                 check=True, capture_output=True).stdout
        subprocess.run(["tar", "-x", "-C", str(parent)], input=archive,
                       check=True)
    if not torch.cuda.is_available():
        print("k1_against_parent: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    WORK.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator().manual_seed(0)
    cases = {}
    for r, d in cs.rms_shapes(len(cs.PROMPT_LENS), max(cs.PROMPT_LENS)):
        x = torch.randn((r, d), generator=gen).to(torch.bfloat16)
        w = (1 + 0.1 * torch.randn((d,), generator=gen)).to(torch.bfloat16)
        cases[f"{r}x{d}"] = (x, w)
    torch.save(cases, WORK / "inputs.pt")
    trees = {"parent": str(parent.resolve() / "src"),
             "this": str(ROOT / "src")}
    runs = []
    for i, side in enumerate(("parent", "this", "this", "parent") * rounds):
        out = WORK / f"run{i}-{side}.pt"
        subprocess.run([sys.executable, __file__, "--worker", trees[side],
                        str(WORK / "inputs.pt"), str(out),
                        "kernels" if kernels_only else "serve"], check=True,
                       timeout=900)
        runs.append(torch.load(out))
    ps, ts = runs[0::4] + runs[3::4], runs[1::4] + runs[2::4]
    atol, rtol = cs.TOLS[torch.bfloat16]
    report, ok = {}, True
    for key in cases:
        a, b = ps[0]["rmsnorm"][key]["out"], ts[0]["rmsnorm"][key]["out"]
        err = (a.float() - b.float()).abs()
        within = bool((err <= atol + rtol * a.float().abs()).all())
        report[key] = {
            "parent_ms": [r["rmsnorm"][key]["ms"] for r in ps],
            "this_ms": [r["rmsnorm"][key]["ms"] for r in ts],
            "parent_eager_ms": [r["rmsnorm"][key]["eager_ms"] for r in ps],
            "this_eager_ms": [r["rmsnorm"][key]["eager_ms"] for r in ts],
            "max_abs_diff": err.max().item(), "within_tol": within,
            "parent_runs_equal": all(torch.equal(a, r["rmsnorm"][key]["out"])
                                     for r in ps),
            "this_runs_equal": all(torch.equal(b, r["rmsnorm"][key]["out"])
                                   for r in ts)}
        ok &= (within and report[key]["parent_runs_equal"]
               and report[key]["this_runs_equal"])
    serve_ = None
    if not kernels_only:
        sp, st = [r["serve"] for r in ps], [r["serve"] for r in ts]
        serve_ = {"parent_tok_s": [x for r in sp for x in r["tok_s"]],
                  "this_tok_s": [x for r in st for x in r["tok_s"]],
                  "parent_runs_equal": all(r["tokens"] == sp[0]["tokens"]
                                           for r in sp),
                  "this_runs_equal": all(r["tokens"] == st[0]["tokens"]
                                         for r in st),
                  "trees_equal": sp[0]["tokens"] == st[0]["tokens"]}
        ok &= serve_["parent_runs_equal"] and serve_["this_runs_equal"]
    line = json.dumps({"card": smi, "parent": str(parent),
                       "rmsnorm_bf16": report, "serve": serve_})
    (WORK / "report.json").write_text(line + "\n")
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(*sys.argv[2:6])
        sys.exit(0)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", nargs="?", type=Path,
                    default=ROOT / "build" / "parent")
    ap.add_argument("--unpack", metavar="REV")
    ap.add_argument("--kernels-only", action="store_true")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    sys.exit(main(args.parent, args.unpack, args.kernels_only, args.rounds))
