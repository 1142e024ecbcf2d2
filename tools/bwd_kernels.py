#!/usr/bin/env python3
"""The backward kernels of K1 and K3 alone on the card: chip_smoke.py's
phase 13a, from this tree or another one.

    python3 tools/bwd_kernels.py [TREE]
    python3 tools/bwd_kernels.py --split

Imports ``chip_smoke`` and ``repro_torch`` from ``TREE`` (default: this
repository; another tree, e.g. a parent commit unpacked with ``git
archive <commit> | tar -x -C build/parent``, builds its own kernels under
its own ``build/``) and runs its ``phase_train_kernels``: each backward
kernel at the shapes one full-width train step gives it, held against its
plain version, launched twice for the same bits, and timed (CUDA-graph
replays) beside its bound, the plain version and the library's backward.
Prints one JSON line: the tree, the card's name and power limit, the
seconds the build took and every case.  Compare two trees only within one
machine, in turns (parent, this, this, parent), each in its own process.

``--split`` (this tree) looks inside the bf16 calls at 13a's shapes:
each kernel's device time (``torch.profiler``, the mean of 20 calls);
K1-bwd's rows kernel at other grids than the plan's (66 to 528 blocks)
at (2048, 2560); and K3-bwd against a copy of its source built beside it
with both grids in the order of their tiles (key / q tile on ``x``, head
on ``y``; the shipped kernels hand out the heaviest tiles of every head
first), the two in turns, held to the same bits.

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
REPS = 20
# K3-bwd's grids in tile order: (text in the source, its replacement)
TILE_ORDER = (
    ("const int kvh = blockIdx.x;", "const int kvh = blockIdx.y;"),
    ("const int k0 = blockIdx.y * kBwdTile;",
     "const int k0 = blockIdx.x * kBwdTile;"),
    ("const dim3 grid_kv(bkv, (sk + kBwdTile - 1) / kBwdTile);",
     "const dim3 grid_kv((sk + kBwdTile - 1) / kBwdTile, bkv);"),
    ("const int bh = blockIdx.x;\n  // the last q tiles cross the most kv "
     "tiles: hand them out first\n  const int q0 = (gridDim.y - 1 - "
     "blockIdx.y) * kBwdTile;",
     "const int bh = blockIdx.y;\n  const int q0 = blockIdx.x * kBwdTile;"),
    ("const dim3 grid_q(bh, (sq + kBwdTile - 1) / kBwdTile);",
     "const dim3 grid_q((sq + kBwdTile - 1) / kBwdTile, bh);"))


def device_ms(fn) -> dict:
    """Mean device ms of each kernel ``fn`` launches, over REPS calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / REPS / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def tile_order_library():
    """K3's source with the backward grids in tile order, built beside
    the shipped one; its ``repro_flash_attention_bwd``."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    text = (_build.CSRC / "flash_attention.cu").read_text()
    for old, new in TILE_ORDER:
        if text.count(old) != 1:
            raise AssertionError(f"tile order: {old!r} not found once")
        text = text.replace(old, new)
    src = _build.BUILD_DIR / "flash_attention_tile_order.cu"
    out = src.with_suffix(".so")
    _build.BUILD_DIR.mkdir(exist_ok=True)
    src.write_text(text)
    _build._compile([("flash_attention_tile_order", src, out,
                      _build.NVCC_FLAGS + ("-I", str(_build.CSRC)))])
    fn = ctypes.CDLL(str(out)).repro_flash_attention_bwd
    fn.argtypes = fa._BWD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def split(chip_smoke) -> dict:
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    gen = torch.Generator(device="cuda").manual_seed(13)
    bf16 = torch.bfloat16

    def randn(*shape, s=1.0):
        return (s * torch.randn(shape, generator=gen, device="cuda")).to(bf16)
    t = chip_smoke.TRAIN_BATCH * chip_smoke.TRAIN_SEQ
    out = {"kernels_ms": {}}
    rms_in = {}
    for rows, d in ((t, 2560), (t * 32, 128)):
        x, dy, w = randn(rows, d), randn(rows, d), 1 + randn(d, s=0.1)
        rms_in[(rows, d)] = (x, w, dy)
        out["kernels_ms"][f"rmsnorm_bwd {(rows, d)}"] = device_ms(
            lambda: rms._launch_bwd(x, w, dy, 1e-6))
    q, do = randn(128, 512, 128, s=0.5), randn(128, 512, 128)
    k, v = randn(32, 512, 128, s=0.5), randn(32, 512, 128)
    o, lse = fa._launch(q, k, v, causal=True, scale=None, q_offset=0,
                        with_lse=True)
    out["kernels_ms"]["flash_attention_bwd q (128, 512, 128)"] = device_ms(
        lambda: fa._launch_bwd(q, k, v, o, lse, do, causal=True, scale=None))

    # K1-bwd's rows kernel at other grids: the plan's layout, its blocks
    # replaced
    x, w, dy = rms_in[(t, 2560)]
    p = rms.bwd_plan(t, 2560, bf16)
    lib = _build.function("rmsnorm", "repro_rmsnorm_bwd", rms._BWD_ARGTYPES)
    grids = {}
    for blocks in (66, 132, 264, 528):
        dx, dw = torch.empty_like(x), torch.empty_like(w)
        part = torch.empty((blocks, 2560), device="cuda")

        def call():
            rc = lib(x.data_ptr(), w.data_ptr(), dy.data_ptr(),
                     dx.data_ptr(), dw.data_ptr(), part.data_ptr(), t, 2560,
                     1e-6, 1, p.vector, p.threads_per_row,
                     p.vectors_per_thread, blocks,
                     torch.cuda.current_stream().cuda_stream)
            _build.check(rc, "rmsnorm_bwd")
        grids[blocks] = chip_smoke.time_ms(call)
    out["rmsnorm_bwd (2048, 2560) ms by blocks"] = {
        "plan": p.blocks, **grids}

    # K3-bwd: shipped grid order against tile order, in turns
    other = tile_order_library()
    delta = torch.empty((128, 512), device="cuda")

    def tile_order():
        grads = [torch.empty_like(x) for x in (q, k, v)]
        rc = other(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   lse.data_ptr(), do.data_ptr(),
                   *[g.data_ptr() for g in grads], delta.data_ptr(), 1, 128,
                   32, 512, 512, 128, 128 ** -0.5, 1,
                   torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "flash_attention_bwd (tile order)")
        return grads

    def shipped():
        return fa._launch_bwd(q, k, v, o, lse, do, causal=True, scale=None)
    if not all(torch.equal(a, b) for a, b in zip(shipped(), tile_order())):
        raise AssertionError("tile order changed the bits")
    times = {"shipped": [], "tile_order": []}
    for name in ("shipped", "tile_order", "tile_order", "shipped"):
        times[name].append(chip_smoke.time_ms(
            shipped if name == "shipped" else tile_order))
    out["flash_attention_bwd (128, 512, 128) ms by grid order"] = times
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("bwd_kernels: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    do_split = "--split" in args
    args = [a for a in args if a != "--split"]
    tree = Path(args[0] if args else ROOT).resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import chip_smoke
    from repro_torch.kernels import _build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.build(["rmsnorm", "flash_attention"])
    build_s = time.perf_counter() - t0
    if do_split:
        rep = split(chip_smoke)
    else:
        rep = {"cases": chip_smoke.phase_train_kernels()}
    torch.cuda.synchronize()
    print(json.dumps({"tree": str(tree), "card": card, "build_s": build_s,
                      **rep}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
