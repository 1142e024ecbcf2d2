#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA card and
check it end to end.

Run from the repository root on a machine with one H100:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no
result):

1. the card (``nvidia-smi`` name and power limit) and the versions of
   torch, CUDA and Triton;
2. build every kernel from the sources in this checkout (``nvcc`` for
   ``csrc/*.cu``, Triton's JIT for the Triton kernels) and print the
   seconds it took and ptxas's register / spill report;
3. each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it: max abs error against a stated tolerance; the
   device time of one call (CUDA graph replays timed by CUDA events, L2
   warm) of the kernel, of the plain version and of the one PyTorch call
   that computes the same function (timed only; the port never calls it);
   the kernel's time per call made from Python, launch included
   (``eager_ms``); and the least time the card could take (bytes /
   3.35 TB/s or operations / peak rate, the larger);
4. the main path: ``repro_torch.launch.serve``'s code serving qwen3-4b at
   full width (36 layers, d_model 2560, bf16, random weights from a seed)
   to 4 requests (prompts up to 200 tokens, 32 new tokens each, one
   sampled at T=0.8 with top-k 50), with every kernel's launch count
   checked against the path's structure;
5. full width against the CPU: 2 layers at full width in float32 (TF32 off
   for matmuls and cuDNN), the same weights on the card (kernels) and on
   the CPU (plain versions): last-position logits within a stated
   tolerance and identical greedy tokens;
6. K2, the hand-written matmul, against its plain version at qwen3-4b's
   projection shapes and one ragged shape, in bf16 and fp32 (times as in
   phase 3, the library call being ``torch.matmul``);
7. K4, the DPIA pipeline on the card: for each of the paper's BLAS
   strategies at the Fig. 7 sizes and the transformer strategies at
   qwen3-4b's shapes, ``Program(expr, args).check().lower()
   .compile("cuda")`` against ``compile("torch")`` (the plain version) on
   the same CUDA tensors, with the launches per call and each stage's CUDA
   grid asserted against the strategy's top-level grid parfor extents; the
   generated kernels' time, the plain version's (one call: it is a python
   loop), the one PyTorch call's, the build seconds and ptxas's registers,
   shared memory and spills per stage;
8. Fig. 7 on the card: generated / library time for scal, asum, dot and
   gemv at both sizes (a reproduction, no claim);
9. the main path of the pipeline slice: ``ops.matmul(impl="cuda")`` at the
   projection shapes and every DPIA op through ``impl="dpia-cuda"`` at the
   shapes of phase 7, with K2's and K4's launch counts checked.

All generated programs and the ``csrc/`` kernels build in one parallel
batch in phase 2.  It then prints one ``{"kernels": [...]}`` line (K1, K2,
K3 and one entry per generated K4 program), the card's name and power
limit, and, last, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
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
    from repro_torch.kernels import _build
    triton = _build.import_triton()
    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, Triton {triton.__version__}, "
        f"{torch.cuda.device_count()} device(s)")
    return smi


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.core.dpia import stage3_cuda
    from repro_torch.kernels import _build, ops
    progs = {ops.program_name(k, **sh): ops.compiled(k, "cuda", **sh)._fn
             for k, sh in DPIA_CASES}
    with ThreadPoolExecutor(2) as pool:      # every nvcc starts at once
        csrc = pool.submit(_build.build)
        gen = pool.submit(stage3_cuda.build_all, list(progs.values()))
        secs, gen_secs = csrc.result(), gen.result()
    log(f"[2] nvcc built {_build.sources()} in {secs:.2f} s and "
        f"{len(progs)} generated DPIA programs in {gen_secs:.2f} s, in "
        f"parallel (0 means already built)")
    for src in _build.sources():
        for line in _build.target(src).with_suffix(".log").read_text(
                ).splitlines():
            if "registers" in line or "spill" in line:
                log(f"    ptxas {src}: {line.strip()}")
    # Triton compiles one variant per (dtype, block): the main path's
    t0 = time.perf_counter()
    for dt in (torch.bfloat16, torch.float32):
        for d in (2560, 128):
            ops.rmsnorm(torch.ones((2, d), dtype=dt, device="cuda"),
                        torch.ones((d,), dtype=dt, device="cuda"))
    torch.cuda.synchronize()
    log(f"[2] Triton compiled rmsnorm variants in "
        f"{time.perf_counter() - t0:.2f} s")
    return gen_secs


def _rmsnorm_case(rows, d, dtype, gen):
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    x = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
    w = (1 + 0.1 * torch.randn((d,), generator=gen,
                               device="cuda")).to(dtype)
    err = check_close(ops.rmsnorm(x, w), ref.rmsnorm(x, w), dtype,
                      f"rmsnorm {(rows, d)} {dtype}")
    elt = x.element_size()
    b_ms, b_by = bound(2 * rows * d * elt + d * elt, 4 * rows * d,
                       ELEMENTWISE_FLOPS)
    return {"shape": [rows, d], "dtype": str(dtype).split(".")[-1],
            "max_abs_err": err, "tol": list(TOLS[dtype]),
            "ms": time_ms(lambda: ops.rmsnorm(x, w)),
            "eager_ms": eager_ms(lambda: ops.rmsnorm(x, w)),
            "plain_ms": time_ms(lambda: ref.rmsnorm(x, w)),
            "library_ms": time_ms(lambda: F.rms_norm(x, (d,), w, 1e-6)),
            "bound_ms": b_ms, "bound_by": b_by}


def _flash_case(sq, sk, causal, q_offset, gen, b=4, nh=32, nkv=8, hd=128,
                dtype=torch.bfloat16):
    import torch.nn.functional as F
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
            "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
            "tol": list(TOLS[dtype]),
            "ms": time_ms(lambda: ops.flash_attention(q, k, v, **kw)),
            "eager_ms": eager_ms(lambda: ops.flash_attention(q, k, v, **kw)),
            "plain_ms": time_ms(lambda: ref.flash_attention(q, k, v, **kw)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=lib_causal, enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": b_by}


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    b = len(PROMPT_LENS)
    rows = b * max(PROMPT_LENS)                       # prefill b*s tokens
    rms_shapes = [(rows, 2560), (rows * 32, 128), (rows * 8, 128),
                  (b, 2560), (b * 32, 128), (b * 8, 128)]   # + decode
    rms = [_rmsnorm_case(r, d, dt, gen)
           for dt in (torch.bfloat16, torch.float32) for r, d in rms_shapes]
    s_main = max(PROMPT_LENS)
    fa = [_flash_case(s, s, causal, 0, gen)
          for s in (s_main, 128, 100) for causal in (True, False)]
    fa.append(_flash_case(1, s_main, True, s_main - 1, gen))
    for name, cases in (("rmsnorm", rms), ("flash_attention", fa)):
        for c in cases:
            log(f"[3] {name} " + json.dumps(c))
    return {"rmsnorm": rms, "flash_attention": fa}


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
    warm = engine.run(reqs)                  # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    before = engine.stats()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    outs = engine.run(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    after = engine.stats()
    prefills = after["prefills"] - before["prefills"]
    steps = after["decode_steps"] - before["decode_steps"]
    per_pass = cfg.n_layers * (4 if cfg.qk_norm else 2) + 1
    want = {"flash_attention": cfg.n_layers * prefills,
            "rmsnorm": per_pass * (prefills + steps),
            "matmul": 0, "dpia_cuda": 0}
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want} for "
                             f"{prefills} prefill(s), {steps} decode steps")
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
        f"steps in {after['chunks'] - before['chunks']} chunks; max memory "
        f"allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches {counts} (rmsnorm = {per_pass} x (prefills + steps), "
        f"flash = {cfg.n_layers} x prefills); card {smi}")
    for i, o in enumerate(outs):
        log(f"    request[{i}] ({PROMPT_LENS[i]} prompt tokens): {o[:10]}")
    del engine, params, model
    torch.cuda.empty_cache()
    return counts


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
    log(f"[5] {CPU_LAYERS} layers at full width, float32, TF32 off: "
        f"last-position logits card vs CPU max abs err {err:.3e} "
        f"(tol {LOGIT_TOL}, |logit| max "
        f"{logits['cpu'].abs().max().item():.2f}); greedy tokens equal "
        f"{toks['cuda']}; {time.perf_counter() - t0:.1f} s")


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


def _matmul_case(m, k, n, dtype, gen):
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ref
    s = k ** -0.25
    a = (s * torch.randn((m, k), generator=gen, device="cuda")).to(dtype)
    b = (s * torch.randn((k, n), generator=gen, device="cuda")).to(dtype)
    got, want = mm.matmul(a, b), ref.matmul(a, b)
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
            "max_abs_err": err.max().item(), "tol": [atol, rtol],
            "ms": time_ms(lambda: mm.matmul(a, b)),
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
    return cases


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
    ptx = fn.ptxas()
    return {"program": ops.program_name(kernel, **shape), "kernel": kernel,
            "shape": shape, "stages": len(fn.stages),
            "grids": [list(g) for g in fn.plan.grids],
            "smem_bytes": [s.smem_bytes for s in fn.stages],
            "scratch_bytes": [s.scratch_bytes for s in fn.stages],
            "ptxas": [ptx.get(s.index, {}) for s in fn.stages],
            "build_s": build_s, "max_abs_err": err.max().item(),
            "tol": [atol, rtol],
            "ms": time_auto(lambda: fn(*args)),
            "eager_ms": eager_auto(lambda: fn(*args)),
            "plain_ms": plain_ms, "plain_calls": 1,
            "library_ms": time_ms(_dpia_library(kernel, args, shape)),
            "bound_ms": b_ms, "bound_by": b_by}


def phase_dpia(build_s):
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [_dpia_case(k, sh, gen, build_s) for k, sh in DPIA_CASES]
    for c in cases:
        log("[7] dpia " + json.dumps(c))
    fig7 = {f"{c['kernel']}_{'x'.join(str(v) for v in c['shape'].values())}":
            c["ms"] / c["library_ms"] for c in cases
            if c["kernel"] in ("scal", "asum", "dot", "gemv")}
    log("[8] fig7 generated/library time " + json.dumps(fig7))
    return cases


def phase_pipeline_main_path():
    """The slice's main path through the entry points a user calls:
    ops.matmul(impl="cuda") at the projection shapes, every DPIA op with
    impl="dpia-cuda"; counts zeroed just before and read just after."""
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
    outs += [calls[k](a, sh) for k, sh, a in dpia_in]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    per_prog = {ops.program_name(k, **sh):
                ops.compiled(k, "cuda", **sh).launches for k, sh in DPIA_CASES}
    stages = sum(len(ops.compiled(k, "cuda", **sh).stages)
                 for k, sh in DPIA_CASES)
    want = {"rmsnorm": 0, "matmul": len(MM_SHAPES), "flash_attention": 0,
            "dpia_cuda": stages}
    if counts != want or 0 in per_prog.values():
        raise AssertionError(f"pipeline main path: launch counts {counts} != "
                             f"{want} (per program {per_prog})")
    for o in outs:
        if not torch.isfinite(o.float()).all():
            raise AssertionError("pipeline main path: a non-finite output")
    log(f"[9] pipeline main path: {len(MM_SHAPES)} K2 calls + "
        f"{len(DPIA_CASES)} dpia-cuda ops, launches {counts}, per generated "
        f"program {per_prog}")
    return counts, per_prog


# ---------------------------------------------------------------------------

KERNELS = [
    {"name": "rmsnorm", "route": "triton",
     "source": "src/repro_torch/kernels/rmsnorm.py",
     "replaces": "src/repro/kernels/rmsnorm.py:36"},
    {"name": "flash_attention", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
     "replaces": "src/repro/kernels/flash_attention.py:90"},
    {"name": "matmul", "route": "cuda",
     "source": "src/repro_torch/kernels/csrc/matmul.cu",
     "replaces": "src/repro/kernels/matmul.py:56"},
]
K4 = {"route": "cuda", "source": "src/repro_torch/core/dpia/stage3_cuda.py",
      "replaces": "src/repro/core/dpia/stage3_pallas.py:430"}
_HEAD_KEYS = ("ms", "eager_ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()
    smi = phase_card()
    build_s = phase_build()
    cases = phase_kernels()
    counts = phase_main_path(smi)
    phase_against_cpu()
    cases["matmul"] = phase_matmul()
    dpia = phase_dpia(build_s)
    p_counts, per_prog = phase_pipeline_main_path()
    counts = {**counts, "matmul": p_counts["matmul"]}
    # the headline case of each kernel is its first: the main path's
    # prefill shape in bf16 (K2: the (800, 2560) x (2560, 4096) projection);
    # every case is listed under "cases".  K4 has one entry per generated
    # program.
    line = []
    for k in KERNELS:
        cs = cases[k["name"]]
        head = cs[0]
        line.append({**k, "launches": counts[k["name"]],
                     "max_abs_err": max(c["max_abs_err"] for c in cs),
                     **{key: head[key] for key in _HEAD_KEYS},
                     "card": smi, "cases": cs})
    for c in dpia:
        line.append({"name": f"dpia_cuda:{c['program']}", **K4,
                     "launches": per_prog[c["program"]],
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
