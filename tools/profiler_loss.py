#!/usr/bin/env python3
"""How many kernel records torch.profiler loses in a long serving run.

    python3 tools/profiler_loss.py [--layout dense|paged] [--rounds R]

Serves chip_smoke phase 4b's traffic (qwen3-4b at full width, bf16, random
weights from seed 0) through ``ContinuousEngine`` with the decode chunk a
CUDA graph, once to capture, then ``R`` rounds (default 1) of four runs
under ``torch.profiler``: device activity alone or with the host's, each
stopped right after the last device sync or after a 0.2 s tail.  Every run
replays the same graphs on the same inputs, so every run launches the
same kernels: each run's tokens are held equal to the first run's (the
script exits 1 otherwise), and a record count that differs between runs,
or a K1 count below the one counted on the host, is the profiler's loss.

One JSON line per run (the counted K1 launches, the K1 records and every
kernel record on the device), then one summary line with the card's name
and power limit.
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


def profiled(engine, reqs, acts, tail: float):
    from torch.autograd import DeviceType
    from torch.profiler import profile
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        results = engine.run_results(reqs, seed=5)
        torch.cuda.synchronize()
        time.sleep(tail)
    k1 = kernels = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kernels += e.count
            k1 += e.count if "rmsnorm_kernel" in e.key else 0
    return ([list(r.tokens) for r in results],
            {"k1_counted": ops.launch_counts()["rmsnorm"], "k1_records": k1,
             "kernel_records": kernels})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layout", choices=("dense", "paged"), default="paged")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    from torch.profiler import ProfilerActivity
    import chip_smoke as cs
    from repro_torch.launch import serve
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg, model, params = serve.build(cs.ARCH, seed=0)
    reqs = cs.continuous_requests(cfg.vocab)
    engine = cs.continuous_engine(model, params, args.layout, graph=True)
    engine.run(reqs, seed=5)                        # captures
    modes = {"device": [ProfilerActivity.CUDA],
             "device+host": [ProfilerActivity.CPU, ProfilerActivity.CUDA]}
    want, runs = None, []
    for r in range(args.rounds):
        for name, acts in modes.items():
            for tail in (0.0, 0.2):
                toks, rep = profiled(engine, reqs, acts, tail)
                want = want or toks
                if toks != want:
                    print(f"{name}, tail {tail}: other tokens than the first "
                          f"run's", file=sys.stderr)
                    return 1
                rep.update(round=r, activities=name, tail_s=tail)
                runs.append(rep)
                print(json.dumps(rep), flush=True)
    most = max(x["kernel_records"] for x in runs)
    print(json.dumps({
        "layout": args.layout, "runs": len(runs),
        "kernel_records_max": most,
        "kernel_records_missing": [most - x["kernel_records"] for x in runs],
        "k1_missing": [x["k1_counted"] - x["k1_records"] for x in runs],
        "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
