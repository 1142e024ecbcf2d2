#!/usr/bin/env python3
"""Where a full-width train step's time goes on the card.

    python3 tools/train_profile.py [--steps N] [--batch B] [--seq S]

qwen3-4b at full width (bf16, 36 layers, remat, weights from seed 0),
``SyntheticLM`` batches, base lr 3e-4, warmup 2, the step of
``train.step.make_train_step``.  After two warm steps it times ``N``
(default 3) steps, each from a device sync to the end of its update: on
the host clock and between CUDA events recorded around the call.  Then
it runs one more step under ``torch.profiler`` (device activity only)
and sums its kernels by group (K1 forward / backward, K3 forward /
backward, the matmuls: cuBLAS, ``nvjet_*`` on Hopper; the rest: the
optimizer's and the model's elementwise kernels, the loss, the
embedding) and by phase: before the guard's read of the loss and the
gradient norm (the step's one device-to-host copy: forward, backward,
global norm) and after it (the AdamW update).  Prints one JSON line
with the card's name and power limit.  Needs the card; exits 2 without
one.
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

GROUPS = (("k1_fwd", ("rmsnorm_kernel",)),
          ("k1_bwd", ("rmsnorm_bwd",)),
          ("k3_fwd", ("flash_fwd",)),
          ("k3_bwd", ("flash_bwd",)),
          ("matmul", ("nvjet", "gemm", "xmma", "cutlass", "sm90_",
                      "Kernel2")))


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def by_phase(events):
    """Device ms of the kernels before and after the step's last
    device-to-host copy (the guard's read), or None if the trace shows
    no such copy."""
    kernels, reads = [], []
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "DtoH" in e.name or "Device -> Pageable" in e.name:
            reads.append(e.time_range.start)
        elif "Memcpy" not in e.name and "Memset" not in e.name:
            kernels.append((e.time_range.start, e.time_range.elapsed_us()))
    if not reads:
        return None
    cut = max(reads)
    return {"grads_and_norm": sum(us for t, us in kernels if t < cut) / 1e3,
            "adamw": sum(us for t, us in kernels if t > cut) / 1e3}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_profile: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.transformer import Model
    from repro_torch.train.step import make_train_state, make_train_step
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    cfg = config("qwen3_4b")
    model = Model(cfg)
    state = make_train_state(model,
                             torch.Generator(device="cuda").manual_seed(0))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch))
    step = make_train_step(model, base_lr=3e-4, warmup=2,
                           total_steps=args.steps + 3)
    for i in range(2):
        state, _ = step(state, data.global_batch_at(i))
    wall, device = [], []
    for i in range(args.steps):
        batch = data.global_batch_at(2 + i)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        state, _ = step(state, batch)
        ev[1].record()
        ev[1].synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        device.append(ev[0].elapsed_time(ev[1]))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, data.global_batch_at(2 + args.steps))
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    groups, kernels = {}, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        groups[group_of(e.key)] = groups.get(group_of(e.key), 0) + us / 1e3
        kernels[e.key] = (us / 1e3, e.count)
    busy = sum(groups.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    print(json.dumps({
        "card": smi, "batch": args.batch, "seq": args.seq,
        "step_ms_median": statistics.median(wall),
        "step_event_ms_median": statistics.median(device),
        "step_ms": wall, "step_event_ms": device,
        "profiled_step_wall_ms": prof_wall, "device_busy_ms": busy,
        "device_busy_share": busy / prof_wall,
        "device_ms_by_phase": by_phase(prof.events()),
        "device_ms_by_group": groups,
        "top_kernels_ms_count": [[k[:90], ms, n] for k, (ms, n) in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
