#!/usr/bin/env python3
"""K4's generated kernels against another checkout's generator, on one card.

    python3 tools/k4_against_parent.py PARENT_DIR

``PARENT_DIR`` is an unpacked tree of another commit, for example
``git archive <commit> | tar -x -C build/parent``.  For each DPIA program
of chip_smoke's phase 7 (the Fig. 7 sizes and qwen3-4b's shapes), the same
seeded inputs go through ``PARENT_DIR``'s generator and this tree's, each
in a process of its own, in the order parent, this, this, parent.  Each
run prints the program's device time (chip_smoke's CUDA-graph timing),
and each stage's alone where that generator has ``bind``, and keeps its
output; the script then holds the outputs of the two generators,
and of each generator's two runs, to ``torch.equal``.  It prints one JSON
line (also written to ``build/k4_against_parent/report.json``) with the
card's name and power limit, and exits 1 if any two outputs differ.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
WORK = ROOT / "build" / "k4_against_parent"


def worker(src: str, inputs: str, out: str) -> None:
    """Compile every program with the generator under ``src``, run it on
    the saved inputs and save each output with its device time."""
    sys.path.insert(0, src)
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.core.dpia import stage3_cuda
    from repro_torch.kernels import ops
    cases = torch.load(inputs)
    fns = {name: ops.program(kernel, **shape).check().lower().compile("cuda")
           for name, (kernel, shape, _) in cases.items()}
    stage3_cuda.build_all([fn._fn for fn in fns.values()])
    res = {}
    for name, (_, _, args) in cases.items():
        fn, args = fns[name], [a.cuda() for a in args]
        got = fn(*args)
        torch.cuda.synchronize()
        res[name] = {"out": got.cpu(),
                     "ms": chip_smoke.time_auto(lambda: fn(*args))}
        if hasattr(fn, "bind"):     # each stage alone, where it can be bound
            launchers, _ = fn.bind(*args)
            for launch in launchers:
                launch()
            res[name]["stage_ms"] = [chip_smoke.time_auto(launch)
                                     for launch in launchers]
        print(f"  {src} {name}: {res[name]['ms']} ms", flush=True)
    torch.save(res, out)


def main(parent: str) -> int:
    if not torch.cuda.is_available():
        print("k4_against_parent: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(1, str(ROOT / "src"))
    import chip_smoke
    from repro_torch.kernels import ops
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    WORK.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = {ops.program_name(k, **sh):
             (k, sh, [a.cpu() for a in chip_smoke._dpia_inputs(k, sh, gen)])
             for k, sh in chip_smoke.DPIA_CASES}
    torch.save(cases, WORK / "inputs.pt")
    trees = {"parent": str(Path(parent).resolve() / "src"),
             "this": str(ROOT / "src")}
    runs = []
    for i, side in enumerate(("parent", "this", "this", "parent")):
        out = WORK / f"run{i}-{side}.pt"
        subprocess.run([sys.executable, __file__, "--worker", trees[side],
                        str(WORK / "inputs.pt"), str(out)], check=True,
                       timeout=900)
        runs.append((side, torch.load(out)))
    (_, p1), (_, t1), (_, t2), (_, p2) = runs
    report = {}
    for name in cases:
        a, b = p1[name]["out"], t1[name]["out"]
        report[name] = {
            "parent_ms": [p1[name]["ms"], p2[name]["ms"]],
            "this_ms": [t1[name]["ms"], t2[name]["ms"]],
            "parent_stage_ms": [r[name].get("stage_ms") for r in (p1, p2)],
            "this_stage_ms": [r[name].get("stage_ms") for r in (t1, t2)],
            "equal": torch.equal(a, b),
            "max_abs_diff": (a - b).abs().max().item(),
            "parent_runs_equal": torch.equal(a, p2[name]["out"]),
            "this_runs_equal": torch.equal(b, t2[name]["out"])}
    line = json.dumps({"card": smi, "parent": str(parent),
                       "programs": report})
    (WORK / "report.json").write_text(line + "\n")
    print(line)
    ok = all(r["equal"] and r["parent_runs_equal"] and r["this_runs_equal"]
             for r in report.values())
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(*sys.argv[2:5])
    elif len(sys.argv) == 2:
        sys.exit(main(sys.argv[1]))
    else:
        sys.exit(__doc__)
