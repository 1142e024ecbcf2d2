#!/usr/bin/env python3
"""K1's launch layouts timed against each other on one card: the check of
``rmsnorm.plan``'s rule.

    python3 tools/k1_plans.py

At each shape of chip_smoke phase 3 (the main path's six in bf16, phase
5's six in fp32), every layout the C entry point has an instance for that
holds the row in one pass -- ``packed`` / ``warp`` at 1, 2, 4 and 8 warps
a block, ``block`` at one and at four accesses a thread -- is launched on
the same seeded inputs, held against the plain version (chip_smoke's
tolerance) and timed by chip_smoke's CUDA-graph replays, in the order
listed and then in reverse; the layout ``plan`` picks is marked.  Prints
one JSON line per shape (also written to ``build/k1_plans/report.json``)
with the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def candidates(rows: int, d: int, dtype):
    """Every one-pass layout of 16-byte accesses over ``rows`` x ``d``."""
    from repro_torch.kernels import rmsnorm as rms
    per = 16 // (4 if dtype == torch.float32 else 2)
    n = d // per
    out = []
    if n <= rms.PACKED_MAX:
        tpr = 1 << (n - 1).bit_length()
        for warps in (1, 2, 4, 8):
            rpb = 32 // tpr * warps
            out.append(rms.Plan("packed", True, tpr, 1, rpb, rpb * tpr,
                                -(-rows // rpb)))
    if n <= 32 * rms.WARP_VPT[-1]:
        vpt = next(v for v in rms.WARP_VPT if 32 * v >= n)
        for warps in (1, 2, 4, 8):
            out.append(rms.Plan("warp", True, 32, vpt, warps, 32 * warps,
                                -(-rows // warps)))
    for vpt in (1, 4):
        t = 32 * -(-n // (32 * vpt))
        if 32 < t <= rms.BLOCK_MAX:
            out.append(rms.Plan("block", True, t, vpt, 1, t, rows))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_plans: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(1, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import rmsnorm as rms
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    fn = rms._entry()
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = ([(s, torch.bfloat16) for s in cs.rms_shapes(
                  len(cs.PROMPT_LENS), max(cs.PROMPT_LENS))]
              + [(s, torch.float32) for s in cs.rms_shapes(
                  len(cs.CPU_PROMPT_LENS), max(cs.CPU_PROMPT_LENS))])
    lines = []
    for (rows, d), dtype in shapes:
        x = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
        w = (1 + 0.1 * torch.randn((d,), generator=gen,
                                   device="cuda")).to(dtype)
        y = torch.empty_like(x)
        want = ref.rmsnorm(x, w)

        def call(p):
            def run():
                _build.check(fn(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                rows, d, 1e-6, int(dtype == torch.bfloat16),
                                p.vector, p.threads_per_row,
                                p.vectors_per_thread, p.threads, p.grid,
                                torch.cuda.current_stream().cuda_stream),
                             f"rmsnorm {p}")
            return run
        cands = candidates(rows, d, dtype)
        names = [f"{p.variant} tpr{p.threads_per_row} vpt"
                 f"{p.vectors_per_thread} rpb{p.rows_per_block} "
                 f"threads{p.threads}" for p in cands]
        ms = {n: [] for n in names}
        for p, name in zip(cands, names):
            y.fill_(float("nan"))
            call(p)()
            cs.check_close(y, want, dtype, f"rmsnorm {(rows, d)} {name}")
        order = list(zip(cands, names))
        for p, name in order + order[::-1]:
            ms[name].append(cs.time_ms(call(p)))
        pick = rms.plan(rows, d, dtype)
        line = {"shape": [rows, d], "dtype": str(dtype).split(".")[-1],
                "plan": names[cands.index(pick)] if pick in cands else
                str(pick), "ms": ms, "card": smi}
        print(json.dumps(line), flush=True)
        lines.append(line)
    out = ROOT / "build" / "k1_plans"
    out.mkdir(parents=True, exist_ok=True)
    (out / "report.json").write_text("\n".join(json.dumps(x) for x in lines)
                                     + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
