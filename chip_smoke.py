#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA card and
check it end to end.

Run from the repository root on a machine with one H100:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no
result):

1. the card (``nvidia-smi`` name and power limit) and the versions of
   torch and CUDA;
2. build every kernel from the sources in this checkout (``nvcc`` for
   ``csrc/*.cu``, the CuTe source ``matmul_wgmma.cu`` with CUTLASS's
   include path) and print the seconds each build took and ptxas's
   register / shared-memory / spill report (for K1 one line: registers
   and spills of each instance of ``csrc/rmsnorm.cu``);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it: max abs error against a stated tolerance; the
   device time of one call (CUDA graph replays timed by CUDA events, L2
   warm) of the kernel, of the plain version and of the one PyTorch call
   that computes the same function (timed only; the port never calls it);
   the kernel's time per call made from Python, launch included
   (``eager_ms``); and the least time the card could take (bytes /
   3.35 TB/s or operations / peak rate, the larger); every case names the
   variant its dtype and shape take (K1: ``packed``, ``warp`` or
   ``block`` from ``rmsnorm.plan``, at the six main-path shapes in bf16,
   phase 4b's prefill rows (one request at each bucket) and phase 5's
   shapes in fp32; K3: ``mma`` for bf16, at phase 4's shapes and at phase
   4b's first prefill chunks, ``simt`` for fp32; K2: ``wgmma``, with split
   K below one wave, or ``simt``); and decode attention (plain PyTorch) at
   a decode step's shape, the card's bf16-read form against the upcast
   form, both timed;
4. the main path: ``repro_torch.launch.serve``'s code serving qwen3-4b at
   full width (36 layers, d_model 2560, bf16, random weights from a seed)
   to 4 requests (prompts up to 200 tokens, 32 new tokens each, one
   sampled at T=0.8 with top-k 50) through ``BatchedEngine``, its decode
   chunk replayed as a CUDA graph, with every kernel's launch count
   checked against the path's structure, replays included, K1's per
   variant (``packed`` for the 128-wide qk_norm rows, ``warp`` for the
   prefill's d_model rows, ``block`` for a decode step's four) and every
   K3 launch on ``mma``; a third run under ``torch.profiler`` holds the
   K1 and K3 kernels the card ran to the counted launches (short by at
   most the profiler's lost records, ``PROFILER_LOSS``);
4b. continuous serving on the same weights: ``ContinuousEngine`` with 4
   slots, chunk 8, prefill chunk 128, 8 requests (prompts 200 / 151 / 64
   / 23 / 180 / 40 / 97 / 12, so admissions happen mid-run and the 200-,
   180- and 151-token prompts prefill in two chunks; 32 new tokens each,
   one at T=0.8 with top-k 50), KV dense and paged, each with the chunk as
   a CUDA graph (after a warm run that captures, runs only replay) and
   eagerly, the four engines timed three times each in alternating order:
   tokens equal between graph and eager and between the layouts, zero
   re-captures after warm-up, exact K1 / K3 counts with replays counted
   in every run; tok/s with the graph and eager, time to first token at
   the 200-token prompt (median and range), peak memory and the captures
   printed; and the static engine on the same requests (its agreement in bf16 is
   printed: the two round different computations in bf16; phase 5 holds
   them equal in fp32);
5. full width against the CPU: 2 layers at full width in float32 (TF32 off
   for matmuls and cuDNN), the same weights on the card (kernels) and on
   the CPU (plain versions): last-position logits within a stated
   tolerance and identical greedy tokens, every K3 launch on ``simt``
   and no K1 launch on ``packed`` (fp32 rows of 128 are 32 vectors); and
   at all 36 layers in float32 on the card, the continuous engine (dense
   and paged, graphs) against the static engine on phase 4b's traffic:
   equal tokens, the sampled request included;
6. K2, the hand-written matmul, against its plain version at qwen3-4b's
   projection shapes and one ragged shape, in bf16 and fp32 (times as in
   phase 3, the library call being ``torch.matmul``), the variant of each
   asserted; and the tile-width check of ``matmul.plan``: both wgmma tile
   widths timed at the prefill projections;
7. K4, the DPIA pipeline on the card: for each of the paper's BLAS
   strategies at the Fig. 7 sizes and the transformer strategies at
   qwen3-4b's shapes, ``Program(expr, args).check().lower()
   .compile("cuda")`` against ``compile("torch")`` (the plain version) on
   the same CUDA tensors, with the launches per call and each stage's CUDA
   grid asserted against the strategy's top-level grid parfor extents; the
   generated kernels' time and each stage's alone (``stage_ms``), the
   plain version's (one call: it is a python loop), the one PyTorch
   call's, the bound and the bound under the strategy's grid (the
   operations' rate scaled by min(1, blocks / SMs) for the stage with the
   most blocks), the build seconds and ptxas's registers, shared memory and
   spills per stage;
8. Fig. 7 on the card: generated / library time for scal, asum, dot and
   gemv at both sizes (a reproduction, no claim);
9. the main path of the pipeline slice: ``ops.matmul(impl="cuda")`` at the
   projection shapes and every DPIA op through ``impl="dpia-cuda"`` at the
   shapes of phase 7, with K2's and K4's launch counts checked, per K2
   variant too; (b) the same DPIA ops as a user calls them by default
   (``impl="dpia-cuda"``, the tuner on, no measured record): the cuda row
   takes no analytic pick, so each runs phase 9's executor, bitwise, its
   eager time held to the ``autotune=False`` form's;
10. compiler services and obs (``repro_torch.compiler``, ``repro_torch.obs``):
   (a) the DPIA ops of phase 9 under ``compiler.options(backend=
   "dpia-cuda")`` with no ``impl=``: K4's launches the sum of their stages,
   outputs bitwise phase 9's; (b) ``ops.matmul`` under ``options(backend=
   "cuda")``: K2 with phase 9's variants, bitwise phase 9's outputs; (c) the
   executor cache: one build per program, hits after; (d) ``save_aot`` to a
   temporary directory, then a fresh Python process (this script with
   ``--aot-child DIR``) runs ``load_aot`` and the eleven programs: bitwise
   phase 9's outputs, zero ``compiler.lower`` / ``compiler.check`` spans,
   zero ``nvcc`` runs; its load time beside phase 2's cold staging and
   build; (e) right after phase 4b, on its weights: one continuous run
   (dense, graph) repeated with tracing on: phase 4b's tokens and launch
   counts, a Chrome trace that loads with ``json`` and holds
   ``serve.prefill_chunk`` / ``serve.decode_chunk`` spans, submit / admit /
   first_token / retire events in that order for each of the 8 requests,
   8 ``serve.ttft_s`` observations and ``serve.recompiles_after_warm`` 0;
   (f) phase 4's static engine, tok/s with obs disabled and with tracing
   on, three runs each in turns, medians beside the card's name and power
   limit; (g) the quickstart (``repro_torch.examples.quickstart``) on the
   card, its step 5 a measured tune on the card;
11. the autotuner on the card (``repro_torch.autotune``): (a) ``tune(kernel,
   backend="cuda", measure=True, verify=True, top_k=4)`` for scal, asum,
   dot at n = 2**22, rmsnorm (800, 2560), softmax (25600, 200) and matmul
   (1024, 2560, 2560), every picked candidate generated by K4 and the
   picks of all six built in one parallel nvcc batch first; for each
   kernel the candidates enumerated and measured (none dropped but for
   ``NotImplementedError`` or a verify miss), the analytic winner (the
   ``gpu`` preset) and the measured one, the winner's and the default's
   time as CUDA-graph replays, its bound, the ``torch`` call's time, and
   the winner against its plain version within phase 7's tolerance; (b)
   ``obs.audit_cache`` over that cache: whether the analytic ranking
   agrees with the card's, and each timed candidate's time beside the
   cost model's terms (what an ``h100`` preset would be fitted to); (c)
   the same calls again: all cache hits, no ``autotune.measure`` span, no
   nvcc run; (d) the ops under ``options(backend="dpia-cuda",
   autotune=True, tuning_cache=...)``: executor keys carrying the tuned
   params, outputs bitwise the winners', K4's launches the winners'
   stages, and the op table's tuner fallback fired zero times; (e) right
   after phase 4b, on its weights: ``ContinuousEngine(kv_layout="auto")``
   serves 4b's traffic in the layout ``autotune.pick_kv_layout`` picks,
   with 4b's exact K1 / K3 counts and its tokens bit for bit.  Phases 9
   and 10 run the op rows under ``options(autotune=False)``, at phase 7's
   programs.  Every tuning cache lives in a temporary directory
   (``REPRO_AUTOTUNE_CACHE`` points there for the whole run).

All generated programs and the ``csrc/`` kernels build in one parallel
batch in phase 2.  It then prints one ``{"kernels": [...]}`` line (K1, K2,
K3, one entry per generated K4 program of phase 7 and one per tuned
winner of phase 11), the card's name and power limit, and, last,
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,   # dense tensor-core rate
              torch.float32: 67e12}     # fp32 outside the tensor cores
ELEMENTWISE_FLOPS = 67e12        # fp32 on the CUDA cores

# Kernel against plain version on the card, |err| <= atol + rtol * |plain|.
# fp32: the same fp32 arithmetic in another summation order.  bf16: both
# round the same fp32 value to bf16, so a rounding flip costs one bf16 ulp
# (2**-8 relative).
TOLS = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2)}

# K2 against its plain version (phase 6): fp32 sums over K = 2560 in
# another order than cuBLAS (inputs scaled by K**-0.25, so |C| ~ 1); bf16
# output: one rounding of nearly the same fp32 value
MM_TOLS = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
MM_SHAPES = [(800, 2560, 4096), (800, 2560, 9728), (4, 2560, 4096),
             (37, 100, 75)]

# K4 programs (phase 7): kernel, shape.  Fig. 7 sizes
# (benchmarks/fig7_overhead.py:25-26) and qwen3-4b's shapes.
FIG7_N = (1 << 20, 1 << 22)
FIG7_GEMV = ((1024, 1024), (2048, 2048))
DPIA_CASES = ([("scal", dict(n=n)) for n in FIG7_N]
              + [("asum", dict(n=n)) for n in FIG7_N]
              + [("dot", dict(n=n)) for n in FIG7_N]
              + [("gemv", dict(m=m, n=n)) for m, n in FIG7_GEMV]
              + [("rmsnorm", dict(rows=800, d=2560, eps=1e-6)),
                 ("softmax", dict(rows=25600, d=200)),
                 ("matmul", dict(m=1024, k=2560, n=2560))])

# main path (phase 4)
ARCH = "qwen3_4b"
PROMPT_LENS = (200, 151, 64, 23)
MAX_NEW = 32
CHUNK = 8
# continuous serving (phase 4b): request 1 samples at T=0.8, top-k 50
CONT_PROMPT_LENS = (200, 151, 64, 23, 180, 40, 97, 12)
SLOTS = 4
PREFILL_CHUNK = 128
BLOCK = 16
CONT_ROUNDS = 3    # timed runs of each continuous engine, in turns
# full width against the CPU (phase 5): fp32 on both sides, TF32 off; the
# sums run in other orders over K = 2560 / 9728, so logits of order 1
# differ by ~1e-5
CPU_LAYERS = 2
CPU_PROMPT_LENS = (100, 37)
CPU_MAX_NEW = 6
LOGIT_TOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 20, trials: int = 7) -> float:
    """Device time of one call: the median over ``trials`` replays of a
    CUDA graph holding ``reps`` back-to-back calls, from CUDA events, after
    a warm-up.  Replaying a graph takes the host's launch cost out, so a
    kernel of a few microseconds is timed by its work on the card."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def eager_ms(fn, reps: int = 20, trials: int = 7) -> float:
    """Time of one call made from Python, launch included: the median over
    ``trials`` of the mean of ``reps`` back-to-back calls, from CUDA
    events.  For a kernel shorter than its launch this is the host's cost
    of a call, not the kernel's."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def check_close(got, want, dtype, what: str) -> float:
    atol, rtol = TOLS[dtype]
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements beyond "
                             f"atol {atol} + rtol {rtol}; max abs err "
                             f"{err.max().item()}")
    return err.max().item()


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    return smi


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.core.dpia import stage3_cuda
    from repro_torch.kernels import _build, ops
    t0 = time.perf_counter()      # Stage I/II, the SCIR check and codegen
    progs = {ops.program_name(k, **sh): ops.compiled(k, "cuda", **sh)._fn
             for k, sh in DPIA_CASES}
    stage_s = time.perf_counter() - t0
    plain = [n for n in _build.sources() if n not in _build.SOURCE_FLAGS]
    cute = sorted(_build.SOURCE_FLAGS)
    with ThreadPoolExecutor(3) as pool:      # every nvcc starts at once
        csrc = pool.submit(_build.build, plain)
        cute_f = pool.submit(_build.build, cute)
        gen = pool.submit(stage3_cuda.build_all, list(progs.values()))
        secs, cute_secs, gen_secs = (csrc.result(), cute_f.result(),
                                     gen.result())
    log(f"[2] staged {len(progs)} DPIA programs (Stage I/II, SCIR check, "
        f"CUDA codegen) in {stage_s:.3f} s")
    log(f"[2] nvcc built {plain} in {secs:.2f} s, the CuTe source(s) "
        f"{cute} in {cute_secs:.2f} s (flags beyond the common ones: "
        f"{ {n: ' '.join(_build.SOURCE_FLAGS[n]) for n in cute} }; CUTLASS "
        f"include path {_build.CUTLASS_INCLUDE}) and {len(progs)} generated "
        f"DPIA programs in {gen_secs:.2f} s, in parallel (0 means already "
        f"built)")
    for src in _build.sources():
        if src == "rmsnorm":
            continue
        kernel = None
        for line in _build.target(src).with_suffix(".log").read_text(
                ).splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line:
                log(f"    ptxas {src} {kernel}: {line.strip()}")
    # dynamic shared memory, which ptxas does not see: the sources report it
    import ctypes
    fa_smem = _build.library("flash_attention").repro_flash_attention_mma_smem
    mm_smem = _build.library("matmul_wgmma").repro_matmul_wgmma_smem
    fa_smem.argtypes = mm_smem.argtypes = [ctypes.c_int]
    log(f"[2] dynamic shared memory: flash_fwd_mma "
        f"{ {d: fa_smem(d) for d in (16, 32, 64, 128)} } B by head dim; "
        f"gemm_wgmma { {bn: mm_smem(bn) for bn in (128, 256)} } B by tile "
        f"width")
    k1 = k1_ptxas(_build.target("rmsnorm").with_suffix(".log").read_text())
    log("[2] ptxas rmsnorm [registers, spill stores, spill loads] by "
        "instance (dtype, elements an access, threads a row, accesses a "
        "thread): " + json.dumps(k1))
    return gen_secs, k1, stage_s


def k1_instance(p, dtype) -> str:
    """The name :func:`k1_ptxas` gives the kernel instance plan ``p``
    launches."""
    per = (16 // (4 if dtype == torch.float32 else 2)) if p.vector else 1
    tpr = 0 if p.variant == "block" else p.threads_per_row
    return (f"{'fp32' if dtype == torch.float32 else 'bf16'} n{per} "
            f"tpr{tpr} vpt{p.vectors_per_thread}")


def k1_ptxas(log_text: str) -> dict:
    """[registers, spill store bytes, spill load bytes] of every instance
    of ``rmsnorm_kernel<T, N, TPR, VPT>`` in a ``-Xptxas -v`` log."""
    from repro_torch.kernels import _build
    rep = _build.ptxas_report(log_text, r"rmsnorm_kernelI(f|13__nv_bfloat16)"
                                        r"Li(\d+)ELi(\d+)ELi(\d+)E")
    return {f"{'fp32' if t == 'f' else 'bf16'} n{n} tpr{tpr} vpt{vpt}":
            [r.get("registers"), r.get("spill_stores", 0),
             r.get("spill_loads", 0)]
            for (t, n, tpr, vpt), r in rep.items()}


def _rmsnorm_case(rows, d, dtype, gen, k1):
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rmsnorm as rms
    x = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
    w = (1 + 0.1 * torch.randn((d,), generator=gen,
                               device="cuda")).to(dtype)
    p = rms.plan(rows, d, dtype)
    ptx = k1.get(k1_instance(p, dtype))
    if ptx is None or ptx[1] or ptx[2]:
        raise AssertionError(f"rmsnorm {(rows, d)} {dtype}: ptxas "
                             f"[registers, spill stores, spill loads] of "
                             f"{k1_instance(p, dtype)}: {ptx}")
    before = rms.launches_by_variant[p.variant]
    err = check_close(ops.rmsnorm(x, w), ref.rmsnorm(x, w), dtype,
                      f"rmsnorm {(rows, d)} {dtype}")
    if rms.launches_by_variant[p.variant] != before + 1:
        raise AssertionError(f"rmsnorm {(rows, d)} {dtype}: {p.variant} was "
                             f"not launched")
    elt = x.element_size()
    b_ms, b_by = bound(2 * rows * d * elt + d * elt, 4 * rows * d,
                       ELEMENTWISE_FLOPS)
    return {"shape": [rows, d], "dtype": str(dtype).split(".")[-1],
            "variant": p.variant, "vector": p.vector,
            "threads_per_row": p.threads_per_row,
            "vectors_per_thread": p.vectors_per_thread,
            "rows_per_block": p.rows_per_block, "grid": p.grid,
            "ptxas": ptx,
            "max_abs_err": err, "tol": list(TOLS[dtype]),
            "ms": time_ms(lambda: ops.rmsnorm(x, w)),
            "eager_ms": eager_ms(lambda: ops.rmsnorm(x, w)),
            "plain_ms": time_ms(lambda: ref.rmsnorm(x, w)),
            "library_ms": time_ms(lambda: F.rms_norm(x, (d,), w, 1e-6)),
            "bound_ms": b_ms, "bound_by": b_by}


def _flash_case(sq, sk, causal, q_offset, gen, b=4, nh=32, nkv=8, hd=128,
                dtype=torch.bfloat16):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    q = (0.5 * torch.randn((b * nh, sq, hd), generator=gen,
                           device="cuda")).to(dtype)
    k = (0.5 * torch.randn((b * nkv, sk, hd), generator=gen,
                           device="cuda")).to(dtype)
    v = torch.randn((b * nkv, sk, hd), generator=gen,
                    device="cuda").to(dtype)
    kw = dict(causal=causal, q_offset=q_offset)
    err = check_close(ops.flash_attention(q, k, v, **kw),
                      ref.flash_attention(q, k, v, **kw), dtype,
                      f"flash_attention sq={sq} sk={sk} {kw}")
    # the library call: same function in (b, heads, s, hd) layout; causal
    # with q_offset = sk - sq is top-left aligned only when sq == sk, and a
    # single last-position query attends to every key
    lib_causal = causal and sq == sk
    if causal and not (sq == sk or (sq == 1 and q_offset == sk - 1)):
        raise ValueError("no library form for this causal offset")
    q4 = q.view(b, nh, sq, hd)
    k4, v4 = k.view(b, nkv, sk, hd), v.view(b, nkv, sk, hd)
    pairs = (sum(min(q_offset + r + 1, sk) for r in range(sq)) if causal
             else sq * sk)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    b_ms, b_by = bound(nbytes, 4 * b * nh * hd * pairs, PEAK_FLOPS[dtype])
    return {"q": [b * nh, sq, hd], "kv": [b * nkv, sk, hd],
            "causal": causal, "q_offset": q_offset,
            "variant": fa.variant(dtype),
            "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
            "tol": list(TOLS[dtype]),
            "ms": time_ms(lambda: ops.flash_attention(q, k, v, **kw)),
            "eager_ms": eager_ms(lambda: ops.flash_attention(q, k, v, **kw)),
            "plain_ms": time_ms(lambda: ref.flash_attention(q, k, v, **kw)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=lib_causal, enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": b_by}


def rms_shapes(b: int, s: int):
    """K1's shapes in one prefill of ``b`` x ``s`` tokens and one decode
    step of qwen3-4b: d_model rows, then the qk_norm's q and k rows."""
    return [(b * s, 2560), (b * s * 32, 128), (b * s * 8, 128),
            (b, 2560), (b * 32, 128), (b * 8, 128)]


def continuous_buckets():
    """Phase 4b's prefill calls, each a batch of 1 padded to its bucket:
    the buckets of every call (K1) and of the first chunks (K3; a
    continuation chunk attends through the plain masked attention)."""
    from repro_torch.serve.scheduler import pick_bucket, seq_buckets
    buckets = seq_buckets(PREFILL_CHUNK)      # the engine's min_bucket 16
    first = {pick_bucket(min(n, PREFILL_CHUNK), buckets)
             for n in CONT_PROMPT_LENS}
    return sorted(set(_prefill_rows(buckets))), sorted(first)


def phase_kernels(k1):
    gen = torch.Generator(device="cuda").manual_seed(0)
    every, first = continuous_buckets()
    # the main path's shapes in bf16 (phase 4, then phase 4b's prefill
    # rows: its decode steps have phase 4's), phase 5's in fp32
    rms = ([_rmsnorm_case(r, d, torch.bfloat16, gen, k1)
            for r, d in rms_shapes(len(PROMPT_LENS), max(PROMPT_LENS))]
           + [_rmsnorm_case(r, d, torch.bfloat16, gen, k1)
              for s in every for r, d in rms_shapes(1, s)[:3]]
           + [_rmsnorm_case(r, d, torch.float32, gen, k1)
              for r, d in rms_shapes(len(CPU_PROMPT_LENS),
                                     max(CPU_PROMPT_LENS))])
    s_main = max(PROMPT_LENS)
    fa = [_flash_case(s, s, causal, 0, gen)
          for s in (s_main, 128, 100) for causal in (True, False)]
    fa.append(_flash_case(1, s_main, True, s_main - 1, gen))
    # phase 4b's first prefill chunks: one request at each bucket
    fa += [_flash_case(s, s, True, 0, gen, b=1) for s in first]
    # the fp32 (simt) variant at the prefill shape: not redesigned, timed
    fa.append(_flash_case(s_main, s_main, True, 0, gen, dtype=torch.float32))
    for name, cases in (("rmsnorm", rms), ("flash_attention", fa)):
        for c in cases:
            log(f"[3] {name} " + json.dumps(c))
    log("[3] decode attention " + json.dumps(_decode_attention_case(gen)))
    return {"rmsnorm": rms, "flash_attention": fa}


def _decode_attention_case(gen):
    """Decode attention (plain PyTorch, no kernel of the port) at a decode
    step of phases 4 and 4b, one layer, bf16: the card's form (the cache
    read in bf16 by two fp32-out GEMMs) against the upcast form (the CPU's
    plain version) on the same card tensors, timed in turns in one call."""
    from repro_torch.configs import config
    from repro_torch.models import attention as attn
    cfg = config(ARCH)
    b, t = SLOTS, continuous_max_seq()
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    bf = torch.bfloat16
    q = (0.3 * torch.randn((b, 1, nh, hd), generator=gen,
                           device="cuda")).to(bf)
    k = (0.3 * torch.randn((b, t, nkv, hd), generator=gen,
                           device="cuda")).to(bf)
    v = torch.randn((b, t, nkv, hd), generator=gen, device="cuda").to(bf)
    pos = torch.tensor([t - 1, 150, 60, 20][:b], device="cuda")
    forms = {"card": lambda: attn._token_attention(cfg, q, k, v, pos, True),
             "upcast": lambda: attn._token_attention(cfg, q, k, v, pos, True,
                                                     upcast=True)}
    # the same products in another order; probabilities rounded to bf16
    err = check_close(forms["card"](), forms["upcast"](), bf,
                      "decode attention, card form against upcast form")
    ms = {"card": [], "upcast": []}
    for form in ("card", "upcast", "upcast", "card"):
        ms[form].append(time_ms(forms[form]))
    return {"q": [b, 1, nh, hd], "kv": [b, t, nkv, hd], "dtype": "bfloat16",
            "max_abs_err": err, "tol": list(TOLS[bf]),
            "ms_card": ms["card"], "ms_upcast": ms["upcast"],
            "layers": cfg.n_layers}


# torch.profiler's kernel records of a long run fall short of what ran,
# though every run launches the same kernels (tools/profiler_loss.py
# measures the loss on the card): a K1 or K3 count may be short by this
# share of the counted launches, plus one
PROFILER_LOSS = 1e-3


def device_checked(run, what: str):
    """``run()`` under torch.profiler, and the K1 and K3 kernels the card
    ran in it (by kernel name; a CUDA graph's replayed kernels are traced
    one by one) held to ``ops.launch_counts()`` read after the run: the
    host's counts, replays included, against the device's.  The profiler
    loses a few records of a long run (PROFILER_LOSS), so the device's
    count may fall short by that much and never exceed the host's.
    Returns ``run()``'s result and the device's counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
        time.sleep(0.2)     # the last kernels' records land in the window
    dev = {"rmsnorm": 0, "flash_attention": {"mma": 0, "simt": 0}}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        if "rmsnorm_kernel" in e.key:
            dev["rmsnorm"] += e.count
        elif "flash_fwd_mma" in e.key:
            dev["flash_attention"]["mma"] += e.count
        elif "flash_fwd" in e.key:
            dev["flash_attention"]["simt"] += e.count
    host = {"rmsnorm": ops.launch_counts()["rmsnorm"],
            "flash_attention": ops.launch_counts_by_variant()[
                "flash_attention"]}
    pairs = [(dev["rmsnorm"], host["rmsnorm"])] + [
        (dev["flash_attention"][v], host["flash_attention"][v])
        for v in ("mma", "simt")]
    if dev["rmsnorm"] == 0 or any(
            not 0 <= h - d <= PROFILER_LOSS * h + 1 for d, h in pairs):
        raise AssertionError(f"{what}: kernels on the card (torch.profiler) "
                             f"{dev} != the counted launches {host}")
    return out, dev


def phase_main_path(smi: str):
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serve.engine import BatchedEngine
    t0 = time.perf_counter()
    cfg, model, params = serve.build(ARCH, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _tensors(params))
    log(f"[4] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.dtype}, {n_params / 1e9:.3f} B params initialised on the "
        f"card in {time.perf_counter() - t0:.1f} s")
    reqs = serve.make_requests(cfg.vocab, PROMPT_LENS, MAX_NEW, seed=1)
    reqs[1].temperature, reqs[1].top_k = 0.8, 50
    engine = BatchedEngine(model, params,
                           max_seq=max(PROMPT_LENS) + MAX_NEW + CHUNK,
                           chunk=CHUNK)
    warm = engine.run(reqs)          # warm-up: cuBLAS, allocator, capture
    torch.cuda.synchronize()
    before = engine.stats()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    outs = engine.run(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    variants = ops.launch_counts_by_variant()
    after = engine.stats()
    prefills = after["prefills"] - before["prefills"]
    steps = after["decode_steps"] - before["decode_steps"]
    if after["captures"] != before["captures"] or after["captures"] != 1:
        raise AssertionError(f"captures {before['captures']} -> "
                             f"{after['captures']}: the measured run must "
                             f"only replay the one (batch, chunk, sampled) "
                             f"graph")
    per_pass = cfg.n_layers * (4 if cfg.qk_norm else 2) + 1
    want = {"flash_attention": cfg.n_layers * prefills,
            "rmsnorm": per_pass * (prefills + steps),
            "matmul": 0, "dpia_cuda": 0}
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want} for "
                             f"{prefills} prefill(s), {steps} decode steps")
    # K1: the qk_norm's 128-wide q and k rows (2 a layer) packed; the
    # d_model rows (2 a layer + the final norm) a warp each in the prefill
    # (4 x 200 rows), a block each in a decode step (4 rows: too few to
    # give every SM a warp)
    want_k1 = {"packed": 2 * cfg.n_layers * (prefills + steps),
               "warp": (2 * cfg.n_layers + 1) * prefills,
               "block": (2 * cfg.n_layers + 1) * steps}
    if variants["rmsnorm"] != want_k1:
        raise AssertionError(f"K1 variants {variants['rmsnorm']} != "
                             f"{want_k1}")
    if variants["flash_attention"] != {"mma": cfg.n_layers * prefills,
                                       "simt": 0}:
        raise AssertionError(f"K3 variants {variants['flash_attention']}: "
                             f"every bf16 prefill launch must take mma")
    if outs != warm:
        raise AssertionError("two runs of the same requests and seed gave "
                             "different tokens")
    for o in outs:
        if len(o) != MAX_NEW or not all(0 <= t < cfg.vocab for t in o):
            raise AssertionError(f"bad output {o}")
    n_tok = sum(len(o) for o in outs)
    log(f"[4] served {len(reqs)} requests (prompts {list(PROMPT_LENS)}, "
        f"{MAX_NEW} new each, request 1 at T=0.8 top-k 50): {n_tok} tokens "
        f"in {dt:.3f} s = {n_tok / dt:.1f} tok/s, 1 prefill + {steps} decode "
        f"steps in {after['chunks'] - before['chunks']} chunks, each a "
        f"replay of the graph {after['graph_keys']}; max memory "
        f"allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches {counts} (rmsnorm = {per_pass} x (prefills + steps), "
        f"flash = {cfg.n_layers} x prefills, variants "
        f"{variants['flash_attention']}, K1 variants "
        f"{variants['rmsnorm']}); card {smi}")
    for i, o in enumerate(outs):
        log(f"    request[{i}] ({PROMPT_LENS[i]} prompt tokens): {o[:10]}")
    ops.reset_launch_counts()
    prof_outs, dev = device_checked(lambda: engine.run(reqs), "phase 4")
    if prof_outs != outs or ops.launch_counts() != counts:
        raise AssertionError(f"phase 4 under the profiler: launches "
                             f"{ops.launch_counts()} != {counts}, or other "
                             f"tokens")
    counted = {"rmsnorm": counts["rmsnorm"],
               "flash_attention": variants["flash_attention"]}
    log(f"[4] a third run under torch.profiler: the card ran {dev} K1 / K3 "
        f"kernels against the counted launches with replays {counted}")
    return (counts, {k: variants[k] for k in ("rmsnorm", "flash_attention")},
            (cfg, model, params), (engine, reqs, outs))


def continuous_requests(vocab: int):
    """Phase 4b's traffic (and phase 5's, at 2 layers)."""
    from repro_torch.launch import serve
    reqs = serve.make_requests(vocab, CONT_PROMPT_LENS, MAX_NEW, seed=3)
    reqs[1].temperature, reqs[1].top_k = 0.8, 50
    return reqs


def continuous_max_seq() -> int:
    return -(-(max(CONT_PROMPT_LENS) + MAX_NEW + CHUNK) // BLOCK) * BLOCK


def continuous_engine(model, params, layout: str, graph: bool):
    from repro_torch.serve.engine import ContinuousEngine
    return ContinuousEngine(model, params, max_seq=continuous_max_seq(),
                            slots=SLOTS, chunk=CHUNK, kv_layout=layout,
                            block_size=BLOCK, prefill_chunk=PREFILL_CHUNK,
                            graph=graph)


def _prefill_rows(buckets):
    """The row count of each prefill call phase 4b's traffic makes: chunks
    of the largest bucket, the tail padded to the smallest that fits."""
    from repro_torch.serve.scheduler import pick_bucket
    rows = []
    for n in CONT_PROMPT_LENS:
        for start in range(0, n, buckets[-1]):
            rows.append(pick_bucket(min(n - start, buckets[-1]), buckets))
    return rows


def _continuous_run(engine, reqs, cfg):
    """One timed run of ``reqs``; the launch counts checked against the
    run's prefill calls, admissions and decode steps, replays included."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rms
    torch.cuda.synchronize()
    before = engine.stats()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = engine.run_results(reqs, seed=5)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, variants = ops.launch_counts(), ops.launch_counts_by_variant()
    after = engine.stats()
    prefills = after["prefills"] - before["prefills"]
    steps = after["decode_steps"] - before["decode_steps"]
    admits = after["scheduler"]["admits"] - before["scheduler"]["admits"]
    rows = _prefill_rows(engine.buckets)
    if prefills != len(rows) or admits != len(reqs):
        raise AssertionError(f"{prefills} prefill calls for {admits} "
                             f"admissions; want {len(rows)} for {len(reqs)}")
    per_pass = 4 * cfg.n_layers + 1
    want = {"flash_attention": cfg.n_layers * admits,
            "rmsnorm": per_pass * (prefills + steps),
            "matmul": 0, "dpia_cuda": 0}
    want_k1 = {"packed": 2 * cfg.n_layers * (prefills + steps),
               "warp": 0, "block": 0}
    for r in rows + [SLOTS] * steps:     # the d_model rows of each pass
        want_k1[rms.plan(r, cfg.d_model, torch.bfloat16).variant] += \
            2 * cfg.n_layers + 1
    if counts != want or variants["rmsnorm"] != want_k1 or \
            variants["flash_attention"] != {"mma": cfg.n_layers * admits,
                                            "simt": 0}:
        raise AssertionError(f"{engine.kv_layout}: launches {counts} != "
                             f"{want}, K1 {variants['rmsnorm']} != {want_k1}, "
                             f"K3 {variants['flash_attention']}")
    toks = [list(r.tokens) for r in results]
    for o in toks:
        if len(o) != MAX_NEW or not all(0 <= t < cfg.vocab for t in o):
            raise AssertionError(f"bad output {o}")
    return toks, {"tok_s": sum(map(len, toks)) / dt, "s": dt,
                  "ttft_200_s": results[0].ttft_s,
                  "max_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
                  "prefills": prefills, "steps": steps,
                  "chunks": after["chunks"] - before["chunks"],
                  "launches": counts, "k1_variants": variants["rmsnorm"]}


def phase_continuous(smi: str, cfg, model, params):
    """Four engines (dense / paged, graph / eager) on one traffic, in
    CONT_ROUNDS rounds of alternating order: every run's tokens equal, and
    the median and range of each engine's tok/s and TTFT."""
    from repro_torch.serve.engine import BatchedEngine
    reqs = continuous_requests(cfg.vocab)
    engines = {}
    for layout in ("dense", "paged"):
        graph = continuous_engine(model, params, layout, graph=True)
        graph.run(reqs, seed=5)           # warm-up: captures every key
        engines[(layout, "graph")] = graph
        engines[(layout, "eager")] = continuous_engine(model, params, layout,
                                                       graph=False)
    want, runs = None, {key: [] for key in engines}
    for r in range(CONT_ROUNDS):
        for key in (list(engines) if r % 2 == 0 else reversed(engines)):
            toks, rep = _continuous_run(engines[key], reqs, cfg)
            if want is None:
                want = toks
            elif toks != want:
                raise AssertionError(f"{key} round {r}: tokens {toks} != "
                                     f"{want} (graph, eager and the layouts "
                                     f"must agree)")
            runs[key].append(rep)
    report = {}
    for (layout, mode), reps in runs.items():
        st = engines[(layout, mode)].stats()
        if mode == "graph" and (st["recaptures_after_warm"]
                                or st["captures"] > 2):
            raise AssertionError(f"{layout}: {st['captures']} captures, "
                                 f"{st['recaptures_after_warm']} after "
                                 f"warm-up: {st['graph_keys']}")
        tok_s = [x["tok_s"] for x in reps]
        ttft = [x["ttft_200_s"] for x in reps]
        report[f"{layout} {mode}"] = {
            "tok_s_median": statistics.median(tok_s), "tok_s": tok_s,
            "ttft_200_s_median": statistics.median(ttft), "ttft_200_s": ttft,
            "max_memory_gib": max(x["max_memory_gib"] for x in reps),
            **{k: reps[0][k] for k in ("prefills", "steps", "chunks",
                                       "launches", "k1_variants")},
            **({"captures": st["captures"], "graph_keys": st["graph_keys"],
                "recaptures_after_warm": st["recaptures_after_warm"]}
               if mode == "graph" else {})}
        log(f"[4b] {layout} {mode}: " + json.dumps(report[f"{layout} {mode}"]))
    dense_graph = engines[("dense", "graph")]
    del engines
    static = BatchedEngine(model, params,
                           max_seq=max(CONT_PROMPT_LENS) + MAX_NEW + CHUNK,
                           chunk=CHUNK)
    static_toks = static.run(reqs, seed=5)
    agree = [next((j for j, (a, b) in enumerate(zip(c, s)) if a != b), None)
             for c, s in zip(want, static_toks)]
    del static
    torch.cuda.empty_cache()
    log(f"[4b] continuous vs static engine in bf16, first differing token "
        f"per request (None: all {MAX_NEW} equal): {agree}")
    for layout in ("dense", "paged"):
        g, e = report[f"{layout} graph"], report[f"{layout} eager"]
        log(f"[4b] {layout}, {CONT_ROUNDS} runs each, median [min, max]: "
            f"tok/s graph {g['tok_s_median']:.1f} [{min(g['tok_s']):.1f}, "
            f"{max(g['tok_s']):.1f}], eager {e['tok_s_median']:.1f} "
            f"[{min(e['tok_s']):.1f}, {max(e['tok_s']):.1f}]; ttft at the "
            f"200-token prompt graph {g['ttft_200_s_median']:.4f} s "
            f"[{min(g['ttft_200_s']):.4f}, {max(g['ttft_200_s']):.4f}], eager "
            f"{e['ttft_200_s_median']:.4f} s [{min(e['ttft_200_s']):.4f}, "
            f"{max(e['ttft_200_s']):.4f}]; max memory "
            f"{g['max_memory_gib']:.2f} GiB; captures {g['captures']} "
            f"{g['graph_keys']}; card {smi}")
    return report, (dense_graph, reqs, want)


def _tensors(node):
    if isinstance(node, torch.Tensor):
        yield node
    elif isinstance(node, dict):
        for v in node.values():
            yield from _tensors(v)
    elif isinstance(node, list):
        for v in node:
            yield from _tensors(v)


def _to(node, device):
    if isinstance(node, torch.Tensor):
        return node.to(device)
    if isinstance(node, dict):
        return {k: _to(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_to(v, device) for v in node]
    return node


def phase_against_cpu():
    from repro_torch.configs import config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Model
    from repro_torch.serve.engine import BatchedEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = config(ARCH, n_layers=CPU_LAYERS, dtype="float32", use_flash=True)
    model = Model(cfg)
    p_cpu = model.init_params(torch.Generator().manual_seed(0), "cpu")
    p_gpu = _to(p_cpu, "cuda")
    reqs = serve.make_requests(cfg.vocab, CPU_PROMPT_LENS, CPU_MAX_NEW,
                               seed=2)
    b, s = len(reqs), max(CPU_PROMPT_LENS)
    tokens = torch.zeros((b, s), dtype=torch.long)
    for i, r in enumerate(reqs):
        tokens[i, :len(r.prompt)] = r.prompt
    lengths = torch.tensor(CPU_PROMPT_LENS)
    ops.reset_launch_counts()
    logits = {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        with torch.inference_mode():
            cache = model.init_cache(b, s, device=dev)
            logits[dev], _ = model.prefill(params, tokens.to(dev), cache,
                                           lengths=lengths.to(dev))
    err = (logits["cuda"].cpu() - logits["cpu"]).abs().max().item()
    if not err <= LOGIT_TOL:
        raise AssertionError(f"full-width logits: card vs CPU max abs err "
                             f"{err} > {LOGIT_TOL}")
    max_seq = s + CPU_MAX_NEW + 2
    toks = {dev: BatchedEngine(model, params, max_seq=max_seq,
                               chunk=4).run(reqs)
            for dev, params in (("cpu", p_cpu), ("cuda", p_gpu))}
    if toks["cuda"] != toks["cpu"]:
        raise AssertionError(f"greedy tokens differ: card {toks['cuda']} "
                             f"cpu {toks['cpu']}")
    del p_gpu
    t_full = time.perf_counter()
    full_cfg = continuous_against_static()
    t_full = time.perf_counter() - t_full
    fa_variants = ops.launch_counts_by_variant()["flash_attention"]
    if fa_variants["mma"] != 0 or fa_variants["simt"] == 0:
        raise AssertionError(f"K3 variants {fa_variants}: every fp32 launch "
                             f"must take simt")
    k1_variants = ops.launch_counts_by_variant()["rmsnorm"]
    if k1_variants["packed"] or not (k1_variants["warp"]
                                     and k1_variants["block"]):
        raise AssertionError(f"K1 variants {k1_variants}: fp32 rows of 128 "
                             f"and the prefill's d_model rows take warp, "
                             f"the decode steps' d_model rows block")
    log(f"[5] {CPU_LAYERS} layers at full width, float32, TF32 off: "
        f"last-position logits card vs CPU max abs err {err:.3e} "
        f"(tol {LOGIT_TOL}, |logit| max "
        f"{logits['cpu'].abs().max().item():.2f}); greedy tokens equal "
        f"{toks['cuda']}; at all {full_cfg.n_layers} layers in float32, "
        f"continuous (dense, paged; graphs) = static on phase 4b's traffic "
        f"({t_full:.1f} s); K3 variants {fa_variants}; K1 variants "
        f"{k1_variants}; {time.perf_counter() - t0:.1f} s")


def continuous_against_static():
    """qwen3-4b at full depth in float32 (17.6 GB of weights), phase 4b's
    traffic through the continuous engine (dense and paged, graphs) and the
    static engine: equal tokens, the sampled request included.  In fp32 the
    engines' other batch shapes and summation orders do not flip a token;
    in bf16 they do (phase 4b prints where)."""
    from repro_torch.launch import serve
    from repro_torch.serve.engine import BatchedEngine
    cfg, model, params = serve.build(ARCH, seed=0, dtype="float32")
    reqs = continuous_requests(cfg.vocab)
    static = BatchedEngine(model, params,
                           max_seq=max(CONT_PROMPT_LENS) + MAX_NEW + CHUNK,
                           chunk=CHUNK).run(reqs, seed=5)
    for layout in ("dense", "paged"):
        cont = continuous_engine(model, params, layout, graph=True).run(
            reqs, seed=5)
        if cont != static:
            first = [next((j for j, (a, b) in enumerate(zip(c, s)) if a != b),
                          None) for c, s in zip(cont, static)]
            raise AssertionError(f"fp32, {cfg.n_layers} layers, {layout}: "
                                 f"continuous tokens != static tokens; first "
                                 f"differing token per request {first}")
    del params
    torch.cuda.empty_cache()
    return cfg


# ---------------------------------------------------------------------------
# the pipeline slice: K2 and K4
# ---------------------------------------------------------------------------

def time_auto(fn) -> float:
    """:func:`time_ms` with fewer replays for a call of many milliseconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = (time.perf_counter() - t0) * 1e3
    if once > 20:
        return time_ms(fn, reps=1, trials=3)
    if once > 2:
        return time_ms(fn, reps=3, trials=5)
    return time_ms(fn)


def eager_auto(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    if (time.perf_counter() - t0) * 1e3 > 20:
        return eager_ms(fn, reps=1, trials=3)
    return eager_ms(fn)


def _mm_variant(m, k, n, dtype) -> str:
    """The variant phase 6 and 9 hold each K2 case to: the bf16 projection
    shapes on the tensor cores, the ragged shape and fp32 on the SIMT
    kernel."""
    return "wgmma" if dtype == torch.bfloat16 and n % 8 == 0 else "simt"


def _matmul_case(m, k, n, dtype, gen):
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ref
    s = k ** -0.25
    a = (s * torch.randn((m, k), generator=gen, device="cuda")).to(dtype)
    b = (s * torch.randn((k, n), generator=gen, device="cuda")).to(dtype)
    p = mm.plan(m, n, k, dtype)
    if p.variant != _mm_variant(m, k, n, dtype):
        raise AssertionError(f"matmul {(m, k, n)} {dtype}: planned "
                             f"{p.variant}, want {_mm_variant(m, k, n, dtype)}")
    before = dict(mm.launches_by_variant)
    got, want = mm.matmul(a, b), ref.matmul(a, b)
    if mm.launches_by_variant[p.variant] != before[p.variant] + 1:
        raise AssertionError(f"matmul {(m, k, n)} {dtype}: {p.variant} was "
                             f"not launched")
    atol, rtol = MM_TOLS[dtype]
    err = (got.float() - want.float()).abs()
    if (err > atol + rtol * want.float().abs()).any():
        raise AssertionError(f"matmul {(m, k, n)} {dtype}: max abs err "
                             f"{err.max().item()} beyond atol {atol} + rtol "
                             f"{rtol}")
    elt = a.element_size()
    b_ms, b_by = bound((m * k + k * n + m * n) * elt, 2 * m * k * n,
                       PEAK_FLOPS[dtype])
    return {"shape": [m, k, n], "dtype": str(dtype).split(".")[-1],
            "variant": p.variant, "block_n": p.block_n, "split": p.split,
            "grid": list(p.grid), "max_abs_err": err.max().item(),
            "tol": [atol, rtol], "ms": time_ms(lambda: mm.matmul(a, b)),
            "eager_ms": eager_ms(lambda: mm.matmul(a, b)),
            "plain_ms": time_ms(lambda: ref.matmul(a, b)),
            "library_ms": time_ms(lambda: torch.matmul(a, b)),
            "bound_ms": b_ms, "bound_by": b_by}


def phase_matmul():
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [_matmul_case(m, k, n, dt, gen)
             for dt in (torch.bfloat16, torch.float32)
             for m, k, n in MM_SHAPES]
    for c in cases:
        log("[6] matmul " + json.dumps(c))
    for m, k, n in MM_SHAPES[:2]:
        log("[6] matmul tile width " + json.dumps(_tile_widths(m, k, n, gen)))
    return cases


def _tile_widths(m, k, n, gen):
    """Both wgmma tile widths at one shape, split 1, timed in turns (128,
    256, 256, 128), against the width ``matmul.plan`` picks: the check of
    its rule on this card."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import matmul as mm
    a = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    b = torch.randn((k, n), generator=gen, device="cuda").to(torch.bfloat16)
    c = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
    fn = mm._wgmma_entry()

    def call(bn):
        def run():                     # the stream a graph capture runs on
            _build.check(fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), None,
                            m, n, k, 1, bn, 1,
                            torch.cuda.current_stream().cuda_stream),
                         f"matmul wgmma block_n {bn}")
        return run
    ms = {128: [], 256: []}
    for bn in (128, 256, 256, 128):
        ms[bn].append(time_ms(call(bn)))
    return {"shape": [m, k, n], "ms_block_n_128": ms[128],
            "ms_block_n_256": ms[256],
            "plan_block_n": mm.plan(m, n, k, torch.bfloat16).block_n}


def grid_extents(cmd):
    """The extents of every top-level grid-level parfor nest of a hoisted
    command, in order: what the strategy says the card must launch."""
    from repro_torch.core.dpia import phrases as P
    from repro_torch.core.dpia.types import AccT, ExpT, Idx, VarT
    out = []

    def walk(p):
        if isinstance(p, P.SeqC):
            walk(p.c1)
            walk(p.c2)
        elif isinstance(p, P.New):
            walk(p.f(P.Var(P.fresh("h"), VarT(p.d))))
        elif isinstance(p, P.ParFor) and p.level.kind in ("grid", "par"):
            dims = []
            while isinstance(p, P.ParFor) and p.level.kind in ("grid", "par"):
                dims.append(p.n)
                p = p.f(P.Var(P.fresh("g"), ExpT(Idx(p.n))),
                        P.Var(P.fresh("o"), AccT(p.d)))
            out.append(tuple(dims))
    walk(cmd)
    return out


def _dpia_inputs(kernel, shape, gen):
    def r(*s, scale=1.0):
        return scale * torch.randn(s, generator=gen, device="cuda")
    if kernel == "scal":
        return (torch.tensor(2.5, device="cuda"), r(shape["n"]))
    if kernel == "asum":
        return (r(shape["n"]),)
    if kernel == "dot":
        return (r(shape["n"]), r(shape["n"]))
    if kernel == "gemv":
        return (r(shape["m"], shape["n"]), r(shape["n"]))
    if kernel == "rmsnorm":
        return (r(shape["rows"], shape["d"]), 1 + r(shape["d"], scale=0.1))
    if kernel == "softmax":
        return (r(shape["rows"], shape["d"]),)
    return (r(shape["m"], shape["k"], scale=0.1),
            r(shape["k"], shape["n"], scale=0.1))


def _dpia_library(kernel, args, shape):
    import torch.nn.functional as F
    if kernel == "scal":
        return lambda: args[1] * args[0]
    if kernel == "asum":
        return lambda: args[0].abs().sum()
    if kernel == "dot":
        return lambda: torch.dot(*args)
    if kernel == "gemv":
        return lambda: torch.mv(*args)
    if kernel == "rmsnorm":
        return lambda: F.rms_norm(args[0], (shape["d"],), args[1],
                                  shape["eps"])
    if kernel == "softmax":
        return lambda: torch.softmax(args[0], dim=-1)
    return lambda: torch.matmul(*args)


def _dpia_work(kernel, shape):
    """(bytes, fp32 operations) the function needs: each input read once,
    the output written once."""
    if kernel in ("scal", "asum", "dot"):
        n = shape["n"]
        ins = {"scal": n + 1, "asum": n, "dot": 2 * n}[kernel]
        outs = n if kernel == "scal" else 1
        return 4 * (ins + outs), {"scal": n, "asum": 2 * n, "dot": 2 * n}[kernel]
    if kernel == "gemv":
        m, n = shape["m"], shape["n"]
        return 4 * (m * n + n + m), 2 * m * n
    if kernel in ("rmsnorm", "softmax"):
        rows, d = shape["rows"], shape["d"]
        w = d if kernel == "rmsnorm" else 0
        return 4 * (2 * rows * d + w), (4 if kernel == "rmsnorm" else 5) * rows * d
    m, k, n = shape["m"], shape["k"], shape["n"]
    return 4 * (m * k + k * n + m * n), 2 * m * k * n


def _dpia_tol(kernel, args, want):
    """(atol, rtol) of the generated program against the plain version.
    scal: the same one multiply.  asum / dot: the same fp32 terms summed in
    another order (a block tree against torch's sum per block), so the
    error is held to 1e-5 of the sum of the terms' magnitudes.  The rest
    sum rows of 200 to 2560 fp32 terms in another order."""
    if kernel == "scal":
        return 0.0, 0.0
    if kernel == "asum":
        return 1e-5 * args[0].abs().sum().item(), 0.0
    if kernel == "dot":
        return 1e-5 * (args[0] * args[1]).abs().sum().item(), 0.0
    return {"gemv": (1e-4, 1e-4), "rmsnorm": (1e-5, 1e-5),
            "softmax": (1e-6, 1e-5), "matmul": (1e-4, 1e-4)}[kernel]


def _dpia_case(kernel, shape, gen, build_s):
    from repro_torch.core.dpia import hoist
    from repro_torch.core.dpia import phrases as P
    from repro_torch.kernels import ops
    prog = ops.program(kernel, **shape)          # Program(expr, argv)
    fn = prog.check().lower().compile("cuda")
    plain = prog.check().lower().compile("torch")
    args = _dpia_inputs(kernel, shape, gen)
    # strategy preservation: one CUDA grid per top-level grid parfor nest
    want_grids = grid_extents(hoist.hoist(prog.imperative, spaces=(P.HBM,)))
    got_grids = [s.grid for s in fn.stages if s.kind == "grid"]
    if got_grids != want_grids or any(s.grid != (1,) for s in fn.stages
                                      if s.kind != "grid"):
        raise AssertionError(f"{kernel} {shape}: stage grids "
                             f"{fn.plan.grids} against the strategy's "
                             f"{want_grids}")
    before = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    if fn.launches - before != len(fn.stages):
        raise AssertionError(f"{kernel}: {fn.launches - before} launches "
                             f"per call, want {len(fn.stages)}")
    t0 = time.perf_counter()
    want = plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    atol, rtol = _dpia_tol(kernel, args, want)
    err = (got - want).abs()
    if not torch.isfinite(got).all() or \
            (err > atol + rtol * want.abs()).any():
        raise AssertionError(f"{kernel} {shape}: generated against plain "
                             f"max abs err {err.max().item()} beyond atol "
                             f"{atol} + rtol {rtol}")
    nbytes, flops = _dpia_work(kernel, shape)
    b_ms, b_by = bound(nbytes, flops, ELEMENTWISE_FLOPS)
    # under the strategy's grid: its largest stage reaches at most that
    # many of the card's SMs
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = max(s.blocks for s in fn.stages)
    g_ms, g_by = bound(nbytes, flops,
                       ELEMENTWISE_FLOPS * min(1.0, blocks / sms))
    # each stage alone, on the buffers of one call that ran them all
    launchers, _ = fn.bind(*args)
    for launch in launchers:
        launch()
    stage_ms = [time_auto(launch) for launch in launchers]
    ptx = fn.ptxas()
    return {"program": ops.program_name(kernel, **shape), "kernel": kernel,
            "shape": shape, "stages": len(fn.stages),
            "grids": [list(g) for g in fn.plan.grids],
            "smem_bytes": [s.smem_bytes for s in fn.stages],
            "scratch_bytes": [s.scratch_bytes for s in fn.stages],
            "ptxas": [ptx.get(s.index, {}) for s in fn.stages],
            "build_s": build_s, "max_abs_err": err.max().item(),
            "tol": [atol, rtol],
            "ms": time_auto(lambda: fn(*args)), "stage_ms": stage_ms,
            "eager_ms": eager_auto(lambda: fn(*args)),
            "plain_ms": plain_ms, "plain_calls": 1,
            "library_ms": time_ms(_dpia_library(kernel, args, shape)),
            "bound_ms": b_ms, "bound_by": b_by}, {
                # derived, not measured: logged, kept out of the kernels line
                "bound_grid_ms": g_ms, "bound_grid_by": g_by, "sms": sms}


def phase_dpia(build_s):
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = []
    for k, sh in DPIA_CASES:
        c, under_grid = _dpia_case(k, sh, gen, build_s)
        log("[7] dpia " + json.dumps({**c, **under_grid}))
        cases.append(c)
    fig7 = {f"{c['kernel']}_{'x'.join(str(v) for v in c['shape'].values())}":
            c["ms"] / c["library_ms"] for c in cases
            if c["kernel"] in ("scal", "asum", "dot", "gemv")}
    log("[8] fig7 generated/library time " + json.dumps(fig7))
    return cases


def phase_pipeline_main_path():
    """The slice's main path through the entry points a user calls:
    ops.matmul(impl="cuda") at the projection shapes, every DPIA op with
    impl="dpia-cuda" at its default strategy (autotune off, so the
    programs are phase 7's); counts zeroed just before and read just
    after."""
    from repro_torch import compiler
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(3)
    mm_in = [(torch.randn((m, k), generator=gen, device="cuda")
              .to(torch.bfloat16),
              torch.randn((k, n), generator=gen, device="cuda")
              .to(torch.bfloat16)) for m, k, n in MM_SHAPES]
    dpia_in = [(k, sh, _dpia_inputs(k, sh, gen)) for k, sh in DPIA_CASES]
    calls = {"scal": lambda a, sh: ops.scal(*a, impl="dpia-cuda"),
             "asum": lambda a, sh: ops.asum(*a, impl="dpia-cuda"),
             "dot": lambda a, sh: ops.dot(*a, impl="dpia-cuda"),
             "gemv": lambda a, sh: ops.gemv(*a, impl="dpia-cuda"),
             "rmsnorm": lambda a, sh: ops.rmsnorm(*a, eps=sh["eps"],
                                                  impl="dpia-cuda"),
             "softmax": lambda a, sh: ops.softmax(*a, impl="dpia-cuda"),
             "matmul": lambda a, sh: ops.matmul(*a, impl="dpia-cuda")}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    outs = [ops.matmul(a, b, impl="cuda") for a, b in mm_in]
    with compiler.options(autotune=False):
        outs += [calls[k](a, sh) for k, sh, a in dpia_in]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    mm_variants = ops.launch_counts_by_variant()["matmul"]
    per_prog = {ops.program_name(k, **sh):
                ops.compiled(k, "cuda", **sh).launches for k, sh in DPIA_CASES}
    stages = sum(len(ops.compiled(k, "cuda", **sh).stages)
                 for k, sh in DPIA_CASES)
    plans = [mm.plan(m, n, k, torch.bfloat16) for m, k, n in MM_SHAPES]
    want = {"rmsnorm": 0, "matmul": sum(p.launches for p in plans),
            "flash_attention": 0, "dpia_cuda": stages}
    want_variants = {"wgmma": sum(p.variant == "wgmma" for p in plans),
                     "splitk_reduce": sum(p.split > 1 for p in plans),
                     "simt": sum(p.variant == "simt" for p in plans)}
    if [p.variant for p in plans] != [_mm_variant(m, k, n, torch.bfloat16)
                                      for m, k, n in MM_SHAPES]:
        raise AssertionError(f"pipeline main path: K2 plans {plans}")
    if counts != want or 0 in per_prog.values() \
            or mm_variants != want_variants or 0 in mm_variants.values():
        raise AssertionError(f"pipeline main path: launch counts {counts} != "
                             f"{want}, K2 variants {mm_variants} != "
                             f"{want_variants} (per program {per_prog})")
    for o in outs:
        if not torch.isfinite(o.float()).all():
            raise AssertionError("pipeline main path: a non-finite output")
    log(f"[9] pipeline main path: {len(MM_SHAPES)} K2 calls + "
        f"{len(DPIA_CASES)} dpia-cuda ops, launches {counts}, K2 variants "
        f"{mm_variants}, per generated program {per_prog}")
    return counts, mm_variants, per_prog, {
        "mm_in": mm_in, "dpia_in": dpia_in, "mm_out": outs[:len(mm_in)],
        "dpia_out": outs[len(mm_in):], "stages": stages}


def phase_default_options(p9):
    """[9b] the same DPIA ops as a user calls them by default: ``impl=
    "dpia-cuda"`` under the default options (the tuner on unless
    ``REPRO_AUTOTUNE=0``, this run's empty default cache).  The cuda row
    takes only measured params, so with no measured record each op runs
    phase 9's executor: no new executor staged, outputs bitwise phase 9's,
    and its time (eager, interleaved with phase 9's form) held to that
    form's."""
    from repro_torch import compiler
    from repro_torch.kernels import ops
    opts = compiler.current_options()
    keys = set(compiler.executor_cache().keys())

    def user(k, a, sh):
        return lambda: ops.rmsnorm(*a, eps=sh["eps"], impl="dpia-cuda") \
            if k == "rmsnorm" else getattr(ops, k)(*a, impl="dpia-cuda")

    def off(k, a, sh):
        def run():
            with compiler.options(autotune=False):
                return user(k, a, sh)()
        return run
    rows = {}
    for (k, sh, a), want in zip(p9["dpia_in"], p9["dpia_out"]):
        got = user(k, a, sh)()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"[9b] {k} {sh} under the default options "
                                 f"is not phase 9's output")
        t_def, t_off = [], []
        for _ in range(2):
            t_def.append(eager_auto(user(k, a, sh)))
            t_off.append(eager_auto(off(k, a, sh)))
        rows[ops.program_name(k, **sh)] = (min(t_def), min(t_off))
    staged = set(compiler.executor_cache().keys()) - keys
    slow = {n: t for n, t in rows.items() if t[0] > 1.5 * t[1] + 0.02}
    if staged or slow:
        raise AssertionError(f"[9b] default options: new executors "
                             f"{sorted(staged)}; slower than autotune=False "
                             f"(ms, ms): {slow}")
    log(f"[9b] {len(rows)} dpia-cuda ops under the default options "
        f"(autotune={opts.autotune}, no measured record): phase 9's "
        f"executors, outputs bitwise phase 9's; eager ms (default options, "
        f"autotune=False): " + json.dumps(rows))


# ---------------------------------------------------------------------------
# phase 10: compiler services and obs
# ---------------------------------------------------------------------------

def dpia_call(kernel, args, shape):
    """The DPIA op for ``kernel`` with no ``impl=``: the options in scope
    pick the row."""
    from repro_torch.kernels import ops
    if kernel == "rmsnorm":
        return ops.rmsnorm(*args, eps=shape["eps"])
    return getattr(ops, kernel)(*args)


def phase_traced_continuous(smi, cfg, engine, reqs, want, untraced):
    """[10e] one phase 4b run (dense, graph, warm) repeated with tracing
    on: the same tokens and launch counts, a loadable Chrome trace with the
    serving spans, each request's lifecycle in order, 8 TTFT observations
    and no re-capture."""
    from repro_torch import obs
    obs.metrics_reset()
    obs.clear_trace()
    obs.enable()
    try:
        toks, rep = _continuous_run(engine, reqs, cfg)
    finally:
        obs.disable()
    if toks != want:
        raise AssertionError("[10e] traced continuous run: tokens differ "
                             "from the untraced runs'")
    with tempfile.TemporaryDirectory() as d:
        path = obs.export_trace(os.path.join(d, "serve-trace.json"))
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    obs.clear_trace()
    spans = {}
    for e in events:
        if e["ph"] == "X":
            spans[e["name"]] = spans.get(e["name"], 0) + 1
    if not spans.get("serve.prefill_chunk") or \
            not spans.get("serve.decode_chunk"):
        raise AssertionError(f"[10e] trace spans {spans}: want "
                             f"serve.prefill_chunk and serve.decode_chunk")
    life = ("serve.submit", "serve.admit", "serve.first_token",
            "serve.retire")
    per_req = {}
    for e in sorted(events, key=lambda e: e["ts"]):
        if e["ph"] == "i" and e["name"] in life:
            per_req.setdefault(e["args"]["req_id"], []).append(e["name"])
    if len(per_req) != len(reqs) or any(names != list(life)
                                        for names in per_req.values()):
        raise AssertionError(f"[10e] lifecycle events per request "
                             f"{per_req}: want {list(life)} for each of "
                             f"{len(reqs)}")
    snap = obs.metrics_snapshot()
    recompiles = obs.counter("serve.recompiles_after_warm").value
    if snap["serve.ttft_s"]["count"] != len(reqs) or recompiles != 0 or \
            engine.stats()["recaptures_after_warm"] != 0:
        raise AssertionError(f"[10e] serve.ttft_s observations "
                             f"{snap['serve.ttft_s']['count']} (want "
                             f"{len(reqs)}), serve.recompiles_after_warm "
                             f"{recompiles} (want 0)")
    out = {"tok_s_traced": rep["tok_s"], "tok_s_untraced_median": untraced,
           "trace_events": len(events), "trace_bytes": size, "spans": spans,
           "ttft_s": {k: snap["serve.ttft_s"][k]
                      for k in ("count", "p50", "p95", "max")},
           "chunk_s": {k: snap["serve.chunk_s"][k]
                       for k in ("count", "p50", "p95", "max")},
           "recompiles_after_warm": recompiles}
    log("[10e] traced continuous run (dense, graph): " + json.dumps(out)
        + f"; card {smi}")
    return out


def phase_obs_cost(smi, engine, reqs, want):
    """[10f] phase 4's static engine: tok/s with obs disabled and with
    tracing on, three runs each in turns (off, on, on, off, off, on)."""
    from repro_torch import obs
    tok_s = {"disabled": [], "tracing": []}
    n_events = 0
    for traced in (False, True, True, False, False, True):
        obs.clear_trace()
        if traced:
            obs.enable()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = engine.run(reqs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            obs.disable()
        if outs != want:
            raise AssertionError("[10f] a run gave other tokens")
        n_events = max(n_events, len(obs.trace_events()))
        tok_s["tracing" if traced else "disabled"].append(
            sum(map(len, outs)) / dt)
    obs.clear_trace()
    out = {k: {"median": statistics.median(v), "runs": v}
           for k, v in tok_s.items()}
    out["trace_events_per_run"] = n_events
    log("[10f] static tok/s, obs disabled against tracing on, 3 runs each "
        f"in turns: {json.dumps(out)}; card {smi}")
    return out


def aot_child(directory: str) -> int:
    """``--aot-child DIR``: a fresh process loads the AOT store in DIR and
    runs the eleven programs on the inputs saved there; prints one JSON
    line (spans by name, nvcc runs, K4 launches, times)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import compiler, obs
    from repro_torch.kernels import _build, ops
    obs.enable()
    cache = compiler.executor_cache()
    t0 = time.perf_counter()
    loaded = cache.load_aot(directory)
    load_s = time.perf_counter() - t0
    inputs = torch.load(os.path.join(directory, "inputs.pt"))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with compiler.options(backend="dpia-cuda", autotune=False):
        outs = [dpia_call(k, a, sh) for (k, sh), a in zip(DPIA_CASES,
                                                          inputs)]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    torch.save(outs, os.path.join(directory, "outputs.pt"))
    names = [e["name"] for e in obs.trace_events()]
    print(json.dumps({
        "loaded": loaded, "load_s": load_s, "first_calls_s": first_s,
        "stats": cache.stats(), "nvcc_runs": _build.nvcc_runs,
        "launches": ops.launch_counts(),
        "trace_events": {n: names.count(n) for n in sorted(set(names))}}))
    return 0


def phase_services(smi, p9, stage_s, build_s):
    """[10a-d, g] the compiler's services on the card."""
    from repro_torch import compiler
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops
    n = len(DPIA_CASES)
    zero = {"rmsnorm": 0, "matmul": 0, "flash_attention": 0, "dpia_cuda": 0}
    # (a) the DPIA ops under an options scope, no impl=
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with compiler.options(backend="dpia-cuda", autotune=False):
        outs = [dpia_call(k, a, sh) for k, sh, a in p9["dpia_in"]]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if counts != {**zero, "dpia_cuda": p9["stages"]} or \
            any(not torch.equal(g, w) for g, w in zip(outs, p9["dpia_out"])):
        raise AssertionError(f"[10a] options(backend='dpia-cuda'): launches "
                             f"{counts}, want {p9['stages']} K4 stages, and "
                             f"phase 9's outputs bit for bit")
    # (b) matmul under options(backend="cuda"): K2 with phase 9's variants
    ops.reset_launch_counts()
    with compiler.options(backend="cuda"):
        mm_outs = [ops.matmul(a, b) for a, b in p9["mm_in"]]
    torch.cuda.synchronize()
    counts, variants = ops.launch_counts(), ops.launch_counts_by_variant()
    want_mm = sum(mm.plan(m, nn, k, torch.bfloat16).launches
                  for m, k, nn in MM_SHAPES)
    if counts != {**zero, "matmul": want_mm} or \
            variants["matmul"] != p9["mm_variants"] or \
            any(not torch.equal(g, w) for g, w in zip(mm_outs, p9["mm_out"])):
        raise AssertionError(f"[10b] options(backend='cuda'): launches "
                             f"{counts}, K2 variants {variants['matmul']} "
                             f"against phase 9's {p9['mm_variants']}")
    # (c) one build per program, hits after
    stats = compiler.executor_cache().stats()
    if stats["builds"] != n or stats["entries"] != n or \
            stats["aot_loads"] or stats["hits"] < 2 * n:
        raise AssertionError(f"[10c] executor cache {stats}: want {n} "
                             f"builds and entries, hits from phases 9 and "
                             f"10a")
    log(f"[10a-c] {n} DPIA ops under options(backend='dpia-cuda') = phase 9 "
        f"bit for bit, K4 launches {p9['stages']} (the stages); "
        f"{len(MM_SHAPES)} matmuls under options(backend='cuda'): K2 "
        f"variants {variants['matmul']} = phase 9's; executor cache {stats}")
    # (d) the AOT store, reloaded in a fresh process
    with tempfile.TemporaryDirectory() as d:
        written = compiler.executor_cache().save_aot(d)
        torch.save([list(a) for _, _, a in p9["dpia_in"]],
                   os.path.join(d, "inputs.pt"))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--aot-child", d], capture_output=True,
                              text=True, timeout=600)
        child_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"[10d] the AOT child failed:\n"
                                 f"{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        rep = json.loads(proc.stdout.strip().splitlines()[-1])
        outs = torch.load(os.path.join(d, "outputs.pt"))
    spans = rep["trace_events"]
    if written != n or rep["loaded"] != n or rep["nvcc_runs"] != 0 or \
            spans.get("compiler.lower", 0) or spans.get("compiler.check", 0) \
            or rep["launches"]["dpia_cuda"] != p9["stages"] or \
            any(not torch.equal(g, w) for g, w in zip(outs, p9["dpia_out"])):
        raise AssertionError(f"[10d] AOT reload: wrote {written}, child "
                             f"{rep}; want {n} loaded, zero lower / check "
                             f"spans and nvcc runs, phase 9's outputs bit "
                             f"for bit")
    aot = {"programs": n, "load_aot_s": rep["load_s"],
           "first_calls_s": rep["first_calls_s"], "child_process_s": child_s,
           "cold_stage_s": stage_s, "cold_nvcc_s": build_s,
           "trace_events": spans, "nvcc_runs": rep["nvcc_runs"]}
    log("[10d] AOT reload in a fresh process, bitwise phase 9: "
        + json.dumps(aot))
    # (g) the quickstart on the card
    from repro_torch.examples import quickstart
    t0 = time.perf_counter()
    qs = quickstart.main([])
    log(f"[10g] quickstart on the card: {json.dumps(qs)} "
        f"({time.perf_counter() - t0:.1f} s)")
    return aot


# ---------------------------------------------------------------------------
# phase 11: the tuner on the card
# ---------------------------------------------------------------------------

# the pipeline's sizes (phase 7's; gemv has no strategy space to tune)
TUNE_CASES = [("scal", dict(n=1 << 22)), ("asum", dict(n=1 << 22)),
              ("dot", dict(n=1 << 22)), ("rmsnorm", dict(rows=800, d=2560)),
              ("softmax", dict(rows=25600, d=200)),
              ("matmul", dict(m=1024, k=2560, n=2560))]
TUNE_TOP_K = 4
# the only reasons the tuner may drop a candidate
DROP_REASONS = {"unsupported", "verify"}


def _op_shape(kernel, shape):
    """The op layer's shape of a tuned kernel (rmsnorm's carries eps)."""
    return {**shape, "eps": 1e-6} if kernel == "rmsnorm" else dict(shape)


def _preset_inputs(record):
    """Each timed candidate's measured time beside the cost model's terms
    for it: what an ``h100`` preset would be fitted to."""
    from repro_torch.autotune import cost, space
    from repro_torch.obs.audit import _parse_params_key
    out = {}
    for pk, us in sorted(record["timings"].items()):
        cand = space.candidate_from_params(
            record["kernel"], _parse_params_key(pk), **record["shape"])
        est = cost.estimate(cand.build()[0])
        out[pk] = {"measured_us": us, **{k: float(v) for k, v in
                                          vars(est).items() if v}}
    return out


def phase_tune(smi: str, cache_path: str):
    """[11a-d] ``autotune.tune(backend="cuda", measure=True, verify=True)``
    at the pipeline's sizes, every measured candidate generated by K4 and
    timed on the card; the ranking audit; a second call served from the
    cache; the op table under the tuned options."""
    from repro_torch import autotune, compiler, obs
    from repro_torch.autotune import measure, space
    from repro_torch.compiler import executors
    from repro_torch.kernels import _build, ops
    t_phase = time.perf_counter()
    fallbacks = obs.counter("kernels.fallbacks").value
    # (a) every kernel's picks generated, then built in one nvcc batch
    nvcc0 = _build.nvcc_runs
    t0 = time.perf_counter()
    gens = [c.program().check().lower().compile("cuda")
            for k, sh in TUNE_CASES
            for c in autotune.api.measure_picks(k, top_k=TUNE_TOP_K,
                                                cache=cache_path, **sh)]
    stage_s = time.perf_counter() - t0
    nvcc_s = measure.build_candidates(gens)
    batch = {"programs": len(gens), "stage_s": stage_s, "nvcc_s": nvcc_s,
             "nvcc_runs": _build.nvcc_runs - nvcc0}
    log("[11a] the picked candidates of every kernel, generated and built "
        "in one parallel batch: " + json.dumps(batch))
    rows, winners = [], {}
    for kernel, shape in TUNE_CASES:
        dropped = {}
        t0 = time.perf_counter()
        res = autotune.tune(kernel, backend="cuda", measure=True, verify=True,
                            top_k=TUNE_TOP_K, cache=cache_path,
                            dropped=dropped, **shape)
        tune_s = time.perf_counter() - t0
        bad = {pk: r for pk, r in dropped.items() if r not in DROP_REASONS}
        if res.source != "measured" or bad or not res.timings:
            raise AssertionError(f"[11a] {kernel}: source {res.source}, "
                                 f"dropped {dropped}")
        ranked = measure.rank_by_cost(space.enumerate_space(kernel, **shape))
        default = space.default_params(kernel, **shape)
        win = space.candidate_from_params(kernel, res.params, **shape)
        wfn, args = measure.compile_candidate(win, "cuda")
        dfn, _ = measure.compile_candidate(
            space.candidate_from_params(kernel, default, **shape), "cuda")
        plain = win.program().check().lower().compile("torch")
        got = wfn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        atol, rtol = _dpia_tol(kernel, args, want)
        err = (got - want).abs()
        if not torch.isfinite(got).all() or \
                (err > atol + rtol * want.abs()).any():
            raise AssertionError(f"[11a] {kernel} winner {res.params}: "
                                 f"max abs err {err.max().item()} against "
                                 f"its plain version beyond atol {atol} + "
                                 f"rtol {rtol}")
        op_shape = _op_shape(kernel, shape)
        nbytes, flops = _dpia_work(kernel, op_shape)
        b_ms, b_by = bound(nbytes, flops, ELEMENTWISE_FLOPS)
        row = {"program": space.program_name(kernel, res.params, **op_shape),
               "kernel": kernel, "shape": shape, "params": res.params,
               "default": default,
               "analytic_winner": ranked[0][0].params_dict,
               "measured_winner": res.params,
               "enumerated": res.n_candidates, "measured": len(res.timings),
               "dropped": dropped, "timings_us": res.timings,
               "grids": [list(g) for g in wfn.plan.grids],
               "stages": len(wfn.stages), "tune_s": tune_s,
               "nvcc_s_batch": nvcc_s, "max_abs_err": err.max().item(),
               "tol": [atol, rtol],
               "ms": time_auto(lambda: wfn(*args)),
               "default_ms": time_auto(lambda: dfn(*args)),
               "eager_ms": eager_auto(lambda: wfn(*args)),
               "plain_ms": plain_ms, "plain_calls": 1,
               "library_ms": time_ms(_dpia_library(kernel, args, op_shape)),
               "bound_ms": b_ms, "bound_by": b_by}
        log("[11a] " + json.dumps(row))
        rows.append(row)
        winners[kernel] = (res, args, got)
    # (b) the ranking audit over that cache, under the card's preset
    tc = autotune.TuningCache(cache_path)
    findings = {f["kernel"]: f for f in obs.auditor().audit_cache(tc)}
    for kernel, _ in TUNE_CASES:
        if kernel not in findings:
            raise AssertionError(f"[11b] no ranking finding for {kernel}")
        key = winners[kernel][0].key
        log(f"[11b] {kernel}: analytic ranking (preset "
            f"{autotune.cost.default_platform()}) agrees with the card: "
            f"{findings[kernel]['agree']}; " + json.dumps(findings[kernel])
            + "; preset inputs " + json.dumps(_preset_inputs(tc.get(key))))
    # (c) the same calls again: cache hits, nothing measured or built
    obs.enable()
    obs.clear_trace()
    nvcc0 = _build.nvcc_runs
    try:
        hits = [autotune.tune(k, backend="cuda", measure=True, verify=True,
                              top_k=TUNE_TOP_K, cache=cache_path, **sh)
                for k, sh in TUNE_CASES]
        names = [e["name"] for e in obs.trace_events()]
    finally:
        obs.disable()
        obs.clear_trace()
    hit = {"sources": sorted({h.source for h in hits}),
           "measure_spans": names.count("autotune.measure"),
           "nvcc_runs": _build.nvcc_runs - nvcc0}
    if hit != {"sources": ["cache"], "measure_spans": 0, "nvcc_runs": 0} \
            or any(h.params != winners[k][0].params
                   for h, (k, _) in zip(hits, TUNE_CASES)):
        raise AssertionError(f"[11c] second tune calls: {hit}")
    log("[11c] second tune calls: " + json.dumps(hit))
    # (d) the op table under the tuned options: the winners, bit for bit
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with compiler.options(backend="dpia-cuda", autotune=True,
                          tuning_cache=cache_path):
        outs = {k: dpia_call(k, winners[k][1], _op_shape(k, sh))
                for k, sh in TUNE_CASES}
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    launches = {}
    for (kernel, shape), row in zip(TUNE_CASES, rows):
        res, _, got = winners[kernel]
        key = executors.make_key(kernel, _op_shape(kernel, shape), "cuda",
                                 params=res.params)
        fn = compiler.executor_cache().get(key)
        if fn is None or not torch.equal(outs[kernel], got):
            raise AssertionError(f"[11d] {kernel}: executor {key} "
                                 f"{'missing' if fn is None else 'found'}; "
                                 f"outputs bitwise the winner's: "
                                 f"{torch.equal(outs[kernel], got)}")
        launches[row["program"]] = fn.launches
    stages = sum(r["stages"] for r in rows)
    if counts != {"rmsnorm": 0, "matmul": 0, "flash_attention": 0,
                  "dpia_cuda": stages} or \
            launches != {r["program"]: r["stages"] for r in rows}:
        raise AssertionError(f"[11d] launches {counts}, per program "
                             f"{launches}; want {stages} K4 stages")
    fired = int(obs.counter("kernels.fallbacks").value - fallbacks)
    if fired:
        raise AssertionError(f"[11] the op table's tuner fallback fired "
                             f"{fired} times")
    log(f"[11d] the {len(TUNE_CASES)} ops under options(backend="
        f"'dpia-cuda', autotune=True, tuning_cache=...): executor keys "
        f"carry the tuned params, outputs bitwise the winners', launches "
        f"{counts} (per program {launches}), tuner fallbacks {fired}")
    for r in rows:
        r["launches"] = launches[r["program"]]
    log(f"[11] phase 11a-d {time.perf_counter() - t_phase:.1f} s (cold "
        f"nvcc included); card {smi}")
    return rows


def phase_tuned_serving(smi, cfg, model, params, reqs, want):
    """[11e] phase 4b's traffic through ``ContinuousEngine(kv_layout=
    "auto")``: the planner's layout, then a run after the warm-up with
    phase 4b's exact K1 / K3 counts and its tokens bit for bit."""
    from repro_torch import autotune
    engine = continuous_engine(model, params, "auto", graph=True)
    pick = autotune.pick_kv_layout(cfg, slots=SLOTS,
                                   max_seq=continuous_max_seq(),
                                   block_size=BLOCK)
    engine.run(reqs, seed=5)                 # warm-up: captures
    toks, rep = _continuous_run(engine, reqs, cfg)
    if engine.kv_layout != pick["layout"] or toks != want:
        raise AssertionError(f"[11e] layout {engine.kv_layout} (planner: "
                             f"{pick['layout']}); tokens equal phase 4b's: "
                             f"{toks == want}")
    log(f"[11e] kv_layout='auto' chose {pick['layout']} "
        + json.dumps(pick) + f"; tokens bitwise phase 4b's; {rep['tok_s']:.1f}"
        f" tok/s, launches {rep['launches']}, K1 {rep['k1_variants']}; "
        f"card {smi}")
    del engine
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------

KERNELS = [
    {"name": "rmsnorm", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
     "replaces": "src/repro/kernels/rmsnorm.py:36"},
    {"name": "flash_attention", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
     "replaces": "src/repro/kernels/flash_attention.py:90"},
    {"name": "matmul", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/matmul_wgmma.cu",
     "replaces": "src/repro/kernels/matmul.py:56"},
]
# the source of each variant of a kernel that has several
VARIANT_SOURCES = {
    "rmsnorm": {v: "src/repro_torch/kernels/csrc/rmsnorm.cu"
                for v in ("packed", "warp", "block")},
    "flash_attention": {
        "mma": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "simt": "src/repro_torch/kernels/csrc/flash_attention.cu"},
    "matmul": {"wgmma": "src/repro_torch/kernels/csrc/matmul_wgmma.cu",
               "splitk_reduce": "src/repro_torch/kernels/csrc/matmul_wgmma.cu",
               "simt": "src/repro_torch/kernels/csrc/matmul.cu"},
}
K4 = {"route": "cuda", "source": "src/repro_torch/core/dpia/stage3_cuda.py",
      "replaces": "src/repro/core/dpia/stage3_pallas.py:430"}
_HEAD_KEYS = ("ms", "eager_ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA card", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--aot-child"]:
        return aot_child(sys.argv[2])
    sys.path.insert(0, str(ROOT / "src"))
    # every tuning cache of this run lives in a temporary directory: the
    # default cache (REPRO_AUTOTUNE_CACHE, read by the AOT child and the
    # quickstart too) and phase 11's
    tune_dir = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(tune_dir,
                                                      "default.json")
    try:
        return _run_phases(os.path.join(tune_dir, "phase11.json"))
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)


def _run_phases(tune_cache: str) -> int:
    t_start = time.perf_counter()
    smi = phase_card()
    build_s, k1, stage_s = phase_build()
    cases = phase_kernels(k1)
    counts, variants, (cfg, model, params), static = phase_main_path(smi)
    report, (dense_graph, reqs, want) = phase_continuous(smi, cfg, model,
                                                         params)
    phase_traced_continuous(smi, cfg, dense_graph, reqs, want,
                            report["dense graph"]["tok_s_median"])
    phase_obs_cost(smi, *static)
    phase_tuned_serving(smi, cfg, model, params, reqs, want)
    del model, params, static, dense_graph
    torch.cuda.empty_cache()
    phase_against_cpu()
    cases["matmul"] = phase_matmul()
    dpia = phase_dpia(build_s)
    p_counts, mm_variants, per_prog, p9 = phase_pipeline_main_path()
    p9["mm_variants"] = mm_variants
    phase_default_options(p9)
    phase_services(smi, p9, stage_s, build_s)
    tuned = phase_tune(smi, tune_cache)
    counts = {**counts, "matmul": p_counts["matmul"]}
    variants["matmul"] = mm_variants
    # the headline case of each kernel is its first: the main path's
    # prefill shape in bf16 (K2: the (800, 2560) x (2560, 4096) projection);
    # every case is listed under "cases".  K4 has one entry per generated
    # program.
    line = []
    for k in KERNELS:
        cs = cases[k["name"]]
        head = cs[0]
        entry = {**k, "launches": counts[k["name"]],
                 "max_abs_err": max(c["max_abs_err"] for c in cs),
                 **{key: head[key] for key in _HEAD_KEYS},
                 "card": smi, "cases": cs}
        if k["name"] in variants:
            entry["variant"] = head["variant"]
            entry["variants"] = {
                v: {"source": src, "launches": variants[k["name"]][v]}
                for v, src in VARIANT_SOURCES[k["name"]].items()}
        line.append(entry)
    for c in dpia:
        line.append({"name": f"dpia_cuda:{c['program']}", **K4,
                     "launches": per_prog[c["program"]],
                     "max_abs_err": c["max_abs_err"],
                     **{key: c[key] for key in _HEAD_KEYS},
                     "card": smi, "cases": [c]})
    # and one per tuned winner (phase 11: its launches are 11d's)
    for c in tuned:
        line.append({"name": f"dpia_cuda:{c['program']}", **K4,
                     "launches": c["launches"],
                     "max_abs_err": c["max_abs_err"],
                     **{key: c[key] for key in _HEAD_KEYS},
                     "card": smi, "cases": [c]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
