#!/usr/bin/env python3
"""The 3xTF32 split on the card: csrc/tc_sm80.cuh's ``split_tf32`` (hi by
``cvt.rna.tf32.f32``, lo by ``tf32_rna_no_nan``, the rounding done on the
bits) against the same split with the cvt for both halves.

    python3 tools/tf32_split.py

1. Bits: one kernel, built from the shipped header, rounds 2^20 random
   fp32 values (exponents 2^-100 to 2^100), the ties, Inf and NaNs
   (0x7fffffff, the card's 0/0, and others) to tf32 both ways:
   ``tf32_rna_no_nan`` must give ``cvt.rna``'s bits on every value that is
   not a NaN, and ``cvt.rna`` must give each NaN with its low 13 bits
   cleared (the rule tests/cuda_emu.h emulates).  The cvt's bits for the
   NaNs are reported.
2. Time: K2 ``tf32x3`` at the prefill projections (800, 2560, 4096 |
   9728) and K3-bwd ``tf32x3`` at chip_smoke 13a's fp32 shape, each built
   twice -- as shipped, and from a copy of its source whose
   ``split_tf32`` takes the cvt for lo too -- and timed in turns (shipped,
   cvt, cvt, shipped; CUDA-graph replays, chip_smoke's ``time_ms``); the
   two builds must give the same bits.

Prints one JSON line with the card's name and power limit.  Needs the
card; exits 2 without one.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
LO = """  lo = tf32_rna_no_nan(x - __uint_as_float(hi));"""
CVT_LO = """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));"""
NANS = [0x7FFFFFFF, 0xFFFFFFFF, 0x7FFFF000, 0xFFFFF000, 0x7FC00000,
        0x7F800001, 0xFF801000]
BITS = r"""
#include <cstdint>
#include <cuda_runtime.h>
#include "%s"
__global__ void both(const float* x, uint32_t* a, uint32_t* b, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t c;
  asm("cvt.rna.tf32.f32 %%0, %%1;" : "=r"(c) : "f"(x[i]));
  a[i] = tf32_rna_no_nan(x[i]);
  b[i] = c;
}
extern "C" int run(const float* x, uint32_t* a, uint32_t* b, int n) {
  both<<<(n + 255) / 256, 256>>>(x, a, b, n);
  return (int)cudaGetLastError();
}
"""


def build(work: Path):
    """The bits kernel (on the shipped header) and the cvt copies of K2
    and K3 (on a copy of the header whose lo takes the cvt), in one nvcc
    batch."""
    from repro_torch.kernels import _build
    header = (_build.CSRC / "tc_sm80.cuh").read_text()
    if header.count(LO) != 1:
        raise AssertionError("split_tf32's lo is not the expected one")
    cvt = work / "cvt"
    cvt.mkdir(parents=True, exist_ok=True)
    (cvt / "tc_sm80.cuh").write_text(header.replace(LO, CVT_LO))
    (work / "bits.cu").write_text(BITS % (_build.CSRC / "tc_sm80.cuh"))
    for name in ("matmul", "flash_attention"):
        (cvt / f"{name}.cu").write_text(
            (_build.CSRC / f"{name}.cu").read_text())
    flags = _build.NVCC_FLAGS + ("-I", str(cvt))
    _build._compile([("bits", work / "bits.cu", work / "bits.so",
                      _build.NVCC_FLAGS)]
                    + [(n, cvt / f"{n}.cu", cvt / f"{n}.so", flags)
                       for n in ("matmul", "flash_attention")])
    _build.build(["matmul", "flash_attention"])
    libs = {n: ctypes.CDLL(str(cvt / f"{n}.so"))
            for n in ("matmul", "flash_attention")}
    libs["bits"] = ctypes.CDLL(str(work / "bits.so"))
    return libs


def bits(lib) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = 1 << 20
    x = torch.randn(n, generator=gen, device="cuda") * torch.exp2(
        torch.randint(-100, 100, (n,), generator=gen, device="cuda").float())
    ties = torch.tensor([0x3F801000, 0xBF801000, 0x3F803000, 0x3F800FFF,
                         0x3FFFFFFF, 0x7F7FF000, 0x00001000, 0x7F800000,
                         0xFF800000] + NANS,
                        dtype=torch.int64).to(torch.int32)
    x[:len(ties)] = ties.view(torch.float32).cuda()
    x[len(ties)] = torch.zeros((), device="cuda") / 0.0   # the card's 0/0
    a = torch.empty(n, dtype=torch.int32, device="cuda")
    b = torch.empty_like(a)
    lib.run.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    if lib.run(x.data_ptr(), a.data_ptr(), b.data_ptr(), n) != 0:
        raise AssertionError("bits kernel: launch failed")
    torch.cuda.synchronize()
    nan = torch.isnan(x)
    differ = int((a != b)[~nan].sum())
    if differ:
        raise AssertionError(f"tf32_rna_no_nan and cvt.rna differ on "
                             f"{differ} of {int((~nan).sum())} values that "
                             f"are not NaN")
    xb = x.view(torch.int32)[nan]
    cvt = b[nan]
    if not torch.equal(cvt, xb & -0x2000):
        raise AssertionError("cvt.rna does not clear a NaN's low 13 bits "
                             "alone: tests/cuda_emu.h's rule is wrong")
    return {"values": n, "differ": differ, "nans": int(nan.sum()),
            "cvt_rna_of_nan": {hex(int(v) & 0xFFFFFFFF):
                               hex(int(c) & 0xFFFFFFFF)
                               for v, c in zip(xb.tolist(), cvt.tolist())}}


def timed(cs, name, shipped, cvt, check) -> dict:
    """shipped / cvt in turns (shipped, cvt, cvt, shipped); same bits."""
    a, b = shipped(), cvt()
    torch.cuda.synchronize()
    if not check(a, b):
        raise AssertionError(f"{name}: the cvt build changed the bits")
    ms = {"shipped": [], "cvt": []}
    for side in ("shipped", "cvt", "cvt", "shipped"):
        ms[side].append(cs.time_ms(shipped if side == "shipped" else cvt))
    return {"case": name, "ms": ms["shipped"], "cvt_lo_ms": ms["cvt"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("tf32_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    libs = build(_build.BUILD_DIR / "tf32_split")
    rep = {"card": card, "bits": bits(libs["bits"]), "cases": []}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    gen = torch.Generator(device="cuda").manual_seed(1)

    mm_cvt = libs["matmul"].repro_matmul
    mm_cvt.argtypes, mm_cvt.restype = mm._ARGTYPES, ctypes.c_int
    for m, k, n in ((800, 2560, 4096), (800, 2560, 9728)):
        s = k ** -0.25
        a = s * torch.randn((m, k), generator=gen, device="cuda")
        b = s * torch.randn((k, n), generator=gen, device="cuda")
        p = mm.plan(m, n, k, torch.float32)
        c = torch.empty((m, n), device="cuda")

        def cvt(a=a, b=b, c=c, m=m, n=n, k=k, p=p):
            _build.check(mm_cvt(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                None, m, n, k, 0, 0,
                                mm._VARIANT_CODES[p.variant], p.block_m,
                                p.block_n, p.split, stream()), "cvt matmul")
            return c
        rep["cases"].append(timed(cs, f"K2 {p.variant} {(m, k, n)}",
                                  lambda a=a, b=b: mm.matmul(a, b), cvt,
                                  torch.equal))

    q = 0.5 * torch.randn((128, 512, 128), generator=gen, device="cuda")
    k = 0.5 * torch.randn((32, 512, 128), generator=gen, device="cuda")
    v = torch.randn((32, 512, 128), generator=gen, device="cuda")
    do = torch.randn((128, 512, 128), generator=gen, device="cuda")
    o, lse = fa._launch(q, k, v, causal=True, scale=None, q_offset=0,
                        with_lse=True)
    fa_cvt = libs["flash_attention"].repro_flash_attention_bwd
    fa_cvt.argtypes, fa_cvt.restype = fa._BWD_ARGTYPES, ctypes.c_int
    grads = [torch.empty_like(t) for t in (q, k, v)]
    delta = torch.empty((128, 512), device="cuda")

    def bwd_cvt():
        _build.check(fa_cvt(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), lse.data_ptr(), do.data_ptr(),
                            *[g.data_ptr() for g in grads], delta.data_ptr(),
                            0, 128, 32, 512, 512, 128, 128 ** -0.5, 1,
                            stream()), "cvt flash_attention_bwd")
        return grads
    rep["cases"].append(timed(
        cs, "K3-bwd tf32x3 q (128, 512, 128), kv (32, 512, 128), causal",
        lambda: fa._launch_bwd(q, k, v, o, lse, do, causal=True, scale=None),
        bwd_cvt,
        lambda x, y: all(torch.equal(s, t) for s, t in zip(x, y))))
    print(json.dumps(rep), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
