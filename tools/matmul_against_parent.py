#!/usr/bin/env python3
"""K2 (the hand-written matmul) alone on the card: chip_smoke.py's phase 6,
from this tree or another one.

    python3 tools/matmul_against_parent.py [TREE]

Imports ``chip_smoke`` and ``repro_torch`` from ``TREE`` (default: this
repository; another tree, e.g. a parent commit unpacked with ``git
archive <commit> | tar -x -C build/parent``, builds its own kernels under
its own ``build/``) and runs its ``phase_matmul``: each K2 case at
qwen3-4b's projection shapes and the ragged (37, 100, 75), in bf16 and
fp32, held against its plain version and timed (CUDA-graph replays)
beside its bound, the plain version and ``torch.matmul``, then the tile
width checks.  Prints one JSON line: the tree, the card's name and power
limit, the seconds the build took and every case.  Compare two trees
only within one machine, in turns (parent, this, this, parent), each in
its own process:

    for t in build/parent . . build/parent; do
        python3 tools/matmul_against_parent.py $t; done

Needs the card; exits 2 without one.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("matmul_against_parent: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(sys.argv[1] if len(sys.argv) > 1 else ROOT).resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import chip_smoke
    from repro_torch.kernels import _build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.build(["matmul", "matmul_wgmma"])
    build_s = time.perf_counter() - t0
    cases = chip_smoke.phase_matmul()
    torch.cuda.synchronize()
    print(json.dumps({"tree": str(tree), "card": card, "build_s": build_s,
                      "cases": cases}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
