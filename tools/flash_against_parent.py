#!/usr/bin/env python3
"""K3 (the hand-written flash attention forward) alone on the card: the
cases of chip_smoke.py's phase 3, from this tree or another one.

    python3 tools/flash_against_parent.py [TREE]
    python3 tools/flash_against_parent.py --layouts

Imports ``chip_smoke`` and ``repro_torch`` from ``TREE`` (default: this
repository; another tree, e.g. a parent commit unpacked with ``git
archive <commit> | tar -x -C build/parent``, builds its own kernels under
its own ``build/``) and runs each K3 case of phase 3 through that tree's
``ops.flash_attention``: bf16 at the serving prefill (S 200, 128, 100,
causal or not), the last-position query and phase 4b's first chunks
(batch 1, S 16 / 32 / 64 / 128); fp32 at the prefill, at those chunks
and at a batch-1 chunk with ``q_offset`` (the last 72 of 200).  Each is
held against the tree's plain version (chip_smoke's tolerance), timed
(CUDA-graph replays) beside SDPA's call on the same inputs, and, in fp32,
measured against a float64 attention beside the plain version.  The
inputs are made from a seed, the same in every tree.  Prints one JSON
line: the tree, the card's name and power limit, the seconds the build
took and every case.  Compare two trees only within one machine, in turns
(parent, this, this, parent), each in its own process:

    for t in build/parent . . build/parent; do
        python3 tools/flash_against_parent.py $t; done

``--layouts`` (this tree) builds copies of the source with the fp32
forward's K / V tiling replaced -- (keys a tile, tiles in flight) of (64,
2), (32, 2), (64, 1), (32, 1) -- and times each at the fp32 cases, the
copies in turns (forward order, then backward), each held to the plain
version.

Needs the card; exits 2 without one.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
# (sq, sk, causal, q_offset, batch, dtype name)
BF16_CASES = ([(s, s, c, 0, 4, "bfloat16") for s in (200, 128, 100)
               for c in (True, False)]
              + [(1, 200, True, 199, 4, "bfloat16")]
              + [(s, s, True, 0, 1, "bfloat16") for s in (16, 32, 64, 128)])
FP32_CASES = ([(200, 200, True, 0, 4, "float32")]
              + [(s, s, True, 0, 1, "float32") for s in (16, 32, 64, 128)]
              + [(72, 200, True, 128, 1, "float32")])
LAYOUTS = ((64, 2), (32, 2), (64, 1), (32, 1))
NH, NKV, HD = 32, 8, 128


def inputs(sq, sk, b, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = (0.5 * torch.randn((b * NH, sq, HD), generator=gen,
                           device="cuda")).to(dtype)
    k = (0.5 * torch.randn((b * NKV, sk, HD), generator=gen,
                           device="cuda")).to(dtype)
    v = torch.randn((b * NKV, sk, HD), generator=gen, device="cuda").to(dtype)
    return q, k, v


def attention_f64(q, k, v, causal, q_offset):
    group = q.shape[0] // k.shape[0]
    k64 = k.double().repeat_interleave(group, dim=0)
    v64 = v.double().repeat_interleave(group, dim=0)
    s = q.double() @ k64.transpose(1, 2) / HD ** 0.5
    if causal:
        rows = torch.arange(q.shape[1], device=q.device)[:, None]
        keys = torch.arange(k.shape[1], device=q.device)[None, :]
        s = s.masked_fill(keys > q_offset + rows, float("-inf"))
    return torch.softmax(s, dim=-1) @ v64


def sdpa(q, k, v, b, causal, q_offset):
    """SDPA on the same inputs in (b, heads, s, hd) layout: the yardstick
    chip_smoke times beside K3."""
    import torch.nn.functional as F
    sq, sk = q.shape[1], k.shape[1]
    is_causal = causal and sq == sk and q_offset == 0
    mask = None
    if causal and not is_causal and not (sq == 1 and q_offset == sk - 1):
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device="cuda").tril(q_offset)
    q4 = q.view(b, NH, sq, HD)
    k4, v4 = k.view(b, NKV, sk, HD), v.view(b, NKV, sk, HD)
    return lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask, is_causal=is_causal, enable_gqa=True)


def case(chip_smoke, call, spec, seed):
    """One case through ``call(q, k, v, causal, q_offset)``."""
    from repro_torch.kernels import ref
    sq, sk, causal, q_offset, b, dt = spec
    dtype = getattr(torch, dt)
    q, k, v = inputs(sq, sk, b, dtype, seed)
    got = call(q, k, v, causal, q_offset)
    want = ref.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    err = chip_smoke.check_close(got, want, dtype,
                                 f"flash_attention {spec}")
    out = {"q": [b * NH, sq, HD], "kv": [b * NKV, sk, HD], "causal": causal,
           "q_offset": q_offset, "dtype": dt, "max_abs_err": err,
           "ms": chip_smoke.time_ms(lambda: call(q, k, v, causal, q_offset)),
           "library_ms": chip_smoke.time_ms(sdpa(q, k, v, b, causal,
                                                 q_offset))}
    if dtype == torch.float32:
        exact = attention_f64(q, k, v, causal, q_offset)
        out["max_abs_err_f64"] = (got.double() - exact).abs().max().item()
        out["plain_max_abs_err_f64"] = (want.double() - exact).abs(
            ).max().item()
    return out


def tree_cases(chip_smoke):
    from repro_torch.kernels import ops

    def call(q, k, v, causal, q_offset):
        return ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    return [case(chip_smoke, call, spec, i)
            for i, spec in enumerate(BF16_CASES + FP32_CASES)]


def layout_libraries():
    """A copy of the source for each fp32 forward layout, built in one
    parallel nvcc batch; each one's ``repro_flash_attention``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    text = (_build.CSRC / "flash_attention.cu").read_text()
    jobs, fns = [], {}
    for bk, stages in LAYOUTS:
        new = text
        for name, value in (("kF32BK", bk), ("kF32Stages", stages)):
            new, n = re.subn(rf"constexpr int {name} = \d+;",
                             f"constexpr int {name} = {value};", new)
            if n != 1:
                raise AssertionError(f"layouts: {name} not found once")
        src = _build.BUILD_DIR / f"flash_attention_bk{bk}_s{stages}.cu"
        _build.BUILD_DIR.mkdir(exist_ok=True)
        src.write_text(new)
        jobs.append((src.stem, src, src.with_suffix(".so"),
                     _build.NVCC_FLAGS + ("-I", str(_build.CSRC))))
    _build._compile(jobs)
    for (bk, stages), (name, _, so, _) in zip(LAYOUTS, jobs):
        fn = ctypes.CDLL(str(so)).repro_flash_attention
        fn.argtypes = fa._ARGTYPES
        fn.restype = ctypes.c_int
        ptxas = _build.ptxas_report(so.with_suffix(".log").read_text(),
                                    r"flash_fwd_tf32ILi(\d+)E")
        fns[(bk, stages)] = (fn, ptxas.get(("128",), {}))
    return fns


def layouts(chip_smoke) -> dict:
    from repro_torch.kernels import _build
    fns = layout_libraries()

    def caller(fn):
        def call(q, k, v, causal, q_offset):
            bh, sq, d = q.shape
            o = torch.empty_like(q)
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    None, 0, bh, k.shape[0], sq, k.shape[1], d, d ** -0.5,
                    int(causal), q_offset,
                    torch.cuda.current_stream().cuda_stream)
            _build.check(rc, "flash_attention (layout copy)")
            return o
        return call
    order = list(LAYOUTS) + list(reversed(LAYOUTS))
    runs = {f"{bk}x{s}": [] for bk, s in LAYOUTS}
    for bk, s in order:
        runs[f"{bk}x{s}"].append(
            [case(chip_smoke, caller(fns[(bk, s)][0]), spec, i)["ms"]
             for i, spec in enumerate(FP32_CASES)])
    return {"cases": [list(c[:5]) for c in FP32_CASES],
            "ms_by_layout": runs,
            "ptxas_d128": {f"{bk}x{s}": fns[(bk, s)][1] for bk, s in LAYOUTS}}


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_against_parent: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    do_layouts = "--layouts" in args
    args = [a for a in args if a != "--layouts"]
    tree = Path(args[0] if args else ROOT).resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import chip_smoke
    from repro_torch.kernels import _build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.build(["flash_attention"])
    build_s = time.perf_counter() - t0
    rep = layouts(chip_smoke) if do_layouts else {
        "cases": tree_cases(chip_smoke)}
    torch.cuda.synchronize()
    print(json.dumps({"tree": str(tree), "card": card, "build_s": build_s,
                      **rep}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
