"""The port's CUDA sources run on the CPU under an emulation of the CUDA
subset they use (tests/cuda_emu.h, compiled with the host's g++): K4's
generated programs against the torch Stage III, K1 (csrc/rmsnorm.cu: every
variant, in both dtypes and both access widths), K2's skinny, tf32x3 and
mma regimes (csrc/matmul.cu) and K3 (csrc/flash_attention.cu: the bf16
tensor-core kernels, the fp32 SIMT forward and the fp32 3xTF32 backward)
against their plain versions, and each emulated tensor-core primitive of
csrc/tc_sm80.cuh (ldmatrix, mma.sync in bf16 and tf32, cvt.rna.tf32,
cp.async) against numpy.

This checks what the generated and hand-written C++ computes (index
arithmetic, fragment layouts, barriers, block reductions, masking) without
a card; it says nothing of speed or of what nvcc accepts, which
tests/test_torch_cuda.py checks on the card.  K2's wgmma + TMA kernel
(csrc/matmul_wgmma.cu) has no CPU emulation: it is tested on the card
only.  Each block runs as one host thread per CUDA thread, so the shapes
are small.
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.compiler import Program
from repro_torch.core.dpia import phrases as P
from repro_torch.core.dpia import stage3_cuda
from repro_torch.core.dpia.types import Arr, Idx, Num
from repro_torch.kernels import _build
from repro_torch.kernels import dpia_blas as B
from repro_torch.kernels import ref

HERE = Path(__file__).resolve().parent


@pytest.fixture(scope="module")
def gxx(tmp_path_factory):
    path = shutil.which("g++")
    if path is None:
        pytest.skip("needs g++ (C++20) to emulate the CUDA sources")
    out = tmp_path_factory.mktemp("emu")

    def compile_(name: str, source: str) -> ctypes.CDLL:
        cpp, so = out / f"{name}.cpp", out / f"{name}.so"
        cpp.write_text(source)
        subprocess.run([path, "-std=c++20", "-O1", "-shared", "-fPIC",
                        "-pthread", "-I", str(HERE), "-o", str(so), str(cpp)],
                       check=True, capture_output=True, timeout=300)
        return ctypes.CDLL(str(so))
    return compile_


def _emulated(source: str) -> str:
    """A CUDA source rewritten for tests/cuda_emu.h: the CUDA headers and
    tc_sm80.cuh (whose primitives the emulation defines) dropped, dynamic
    shared memory pointed at the emulator's, static ``__shared__`` arrays of
    any element type made function statics (one block runs at a time), and
    every ``<<<...>>>`` launch made an ``emu_launch``."""
    source = re.sub(r'#include (<cuda_(runtime|bf16)\.h>|"tc_sm80\.cuh")\n',
                    "", source)
    source = '#include "cuda_emu.h"\n' + source
    source = source.replace("extern __shared__ float smem[];",
                            "float* smem = g_smem;")
    source = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?"
                    r"unsigned char (\w+)\[\];",
                    r"unsigned char* \1 = "
                    r"reinterpret_cast<unsigned char*>(g_smem);", source)
    source = re.sub(r"__shared__ (?:__align__\(\d+\) )?([\w:]+) (\w+)\[",
                    r"static \1 \2[", source)
    return re.sub(r"([\w<>, ]+?)<<<(dim3\([^)]*\)|\w+), ([^,]+), [^>]*?>>>"
                  r"\((.*?)\);",
                  r"emu_launch(\2, \3, [&]{ \1(\4); });", source, flags=re.S)


STRATEGIES = {
    "scal": (lambda: B.strategy_scal(2048, block=512), [(), (2048,)]),
    "asum": (lambda: B.strategy_asum(2048, block=256), [(2048,)]),
    "dot": (lambda: B.strategy_dot(2048, block=256), [(2048,), (2048,)]),
    "gemv": (lambda: B.strategy_gemv(16, 40, row_block=4), [(16, 40), (40,)]),
    "rmsnorm": (lambda: B.strategy_rmsnorm(8, 300, row_block=4),
                [(8, 300), (300,)]),
    "softmax": (lambda: B.strategy_softmax(8, 20, row_block=4), [(8, 20)]),
    "matmul": (lambda: B.strategy_matmul(8, 12, 6, bm=4, bk=4),
               [(8, 12), (12, 6)]),
    # a bm x n accumulator above the shared-memory budget: global scratch
    "matmul_scratch": (lambda: B.strategy_matmul(8, 8, 8192, bm=8, bk=8),
                       [(8, 8), (8, 8192)]),
    # dotBlock (n,k).(k,m) ragged everywhere: n = 130 and m = 150 against
    # the 8 x 8 register tile and the 128-row / 128-column panels (a second
    # panel of 2 rows, of 22 columns), k = 37 against the copies' 256
    # threads
    "matmul_ragged": (lambda: B.strategy_matmul(130, 74, 150, bm=130, bk=37),
                      [(130, 74), (74, 150)]),
    # a 192 KB accumulator in shared memory leaves the dotBlock's tiles
    # room for k chunks of 76 of 100: narrower panels, a ragged last chunk
    "matmul_shrunk": (lambda: B.strategy_matmul(8, 100, 6000, bm=8, bk=100),
                      [(8, 100), (100, 6000)]),
    "naive_matmul": (lambda: B.naive_matmul(4, 3, 5), [(4, 3), (3, 5)]),
    "naive_asum": (lambda: B.naive_asum(16), [(16,)]),
}


def _run(lib, fn, args, prefix=""):
    """Launch every stage of a generated program on CPU buffers (entry
    points ``<prefix>launch_stage<k>``)."""
    plan = fn.plan
    outs = [torch.zeros(s) for _, s in stage3_cuda.leaves(fn.out.t.d)]
    host = [torch.zeros(s) for _, d in plan.host
            for _, s in stage3_cuda.leaves(d)]
    scratch = torch.full((max(1, plan.scratch_bytes // 4),), float("nan"))
    ptrs = ([a.data_ptr() for a in args] + [t.data_ptr() for t in outs + host]
            + [scratch.data_ptr(), None])
    for st in plan.stages:
        launch = getattr(lib, f"{prefix}launch_stage{st.index}")
        launch.argtypes = [ctypes.c_void_p] * len(ptrs)
        launch.restype = ctypes.c_int
        assert launch(*ptrs) == 0
    return outs[0]


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_generated_program_matches_torch_stage3(gxx, rng, name):
    build, shapes = STRATEGIES[name]
    prog = Program.from_builder(build, name=name).check().lower()
    fn = prog.compile("cuda")
    args = [torch.tensor(rng.randn(*s), dtype=torch.float32).reshape(-1)
            .clone() for s in shapes]
    want = prog.compile("torch")(*[a.reshape(s) for a, s in zip(args, shapes)])
    got = _run(gxx(name, _emulated(fn.source)), fn._fn, args)
    np.testing.assert_allclose(got.reshape(want.shape).numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_hoisted_temporary_and_self_reading_assignment(gxx, rng):
    """The paper's section 6.4 example (an HBM temporary hoisted to the
    host) and an assignment reading its own destination transposed, which
    the generator stages through a temporary."""
    xs = P.var_exp("xs", Arr(64, Num()))
    out = P.var_acc("out", Arr(16, Num()))
    cmd = P.ParFor(16, Num(), out, lambda i, o: P.New(
        Arr(4, Num()), lambda tmp: P.SeqC(
            P.For(4, lambda j: P.Assign(P.IdxAcc(P.AccPart(tmp), j),
                                        P.IdxE(P.IdxE(P.Split(4, xs), i), j))),
            P.Assign(o, P.FullReduce("add", P.ExpPart(tmp)))), space=P.HBM),
        level=P.GRID(0))
    fn = Program.from_imperative(cmd, [xs], out).check().compile("cuda")
    assert fn.plan.host and fn.plan.grids == [(16,)]
    a = torch.tensor(rng.randn(64), dtype=torch.float32)
    got = _run(gxx("hoist", _emulated(fn.source)), fn._fn, [a])
    np.testing.assert_allclose(got.numpy(), a.reshape(16, 4).sum(1).numpy(),
                               rtol=1e-5, atol=1e-5)

    A = P.var_exp("A", Arr(4, Arr(4, Num())))
    out = P.var_acc("out", Arr(4, Arr(4, Num())))
    cmd = P.New(Arr(4, Arr(4, Num())), lambda v: P.SeqC(P.SeqC(
        P.Assign(P.AccPart(v), A),
        P.Assign(P.AccPart(v), P.Transpose(P.ExpPart(v)))),
        P.Assign(out, P.ExpPart(v))), space=P.REG)
    fn = Program.from_imperative(cmd, [A], out).check().compile("cuda")
    a = torch.tensor(rng.randn(16), dtype=torch.float32)
    got = _run(gxx("clash", _emulated(fn.source)), fn._fn, [a])
    np.testing.assert_array_equal(got.numpy(), a.reshape(4, 4).T.numpy())


def test_thread0_and_block_wide_statements_alternate(gxx, rng):
    """Thread 0 reads elements other threads wrote and the block reads what
    thread 0 wrote, in turn and across a loop's iterations: each needs the
    barrier the generator places.  ``s`` has one element but a block-wide
    statement reads it, so it lives in shared memory, not a register."""
    xs = P.var_exp("xs", Arr(64, Num()))
    out = P.var_acc("out", Arr(64, Num()))
    last = P.Lit(63, Idx(64))

    def steps(s, v):        # v := xs; s := v[63]; 3 x (v -= s; s += v[63])
        return P.SeqC(P.SeqC(
            P.Assign(P.AccPart(v), xs),
            P.Assign(P.AccPart(s), P.IdxE(P.ExpPart(v), last))),
            P.For(3, lambda r: P.SeqC(
                P.Assign(P.AccPart(v), P.sub(P.ExpPart(v), P.ExpPart(s))),
                P.Assign(P.AccPart(s), P.add(P.ExpPart(s), P.IdxE(
                    P.ExpPart(v), last))))))
    cmd = P.New(Num(), lambda s: P.New(Arr(64, Num()), lambda v: P.SeqC(
        steps(s, v), P.Assign(out, P.ExpPart(v))), space=P.VMEM), space=P.REG)
    prog = Program.from_imperative(cmd, [xs], out).check()
    fn = prog.compile("cuda")
    body = fn.source[fn.source.index("dpia_stage0("):]
    # s: written by thread 0 in shared memory, no register
    assert re.search(r"if \(threadIdx\.x == 0\) \{\s+\(smem \+ \d+\)\[0\] = ",
                     body)
    assert not re.search(r"float v\d+ = 0\.0f;", body)
    a = torch.tensor(rng.randn(64), dtype=torch.float32)
    want = prog.compile("torch")(a)
    lib = gxx("alternate", _emulated(fn.source))
    for _ in range(20):             # a missing barrier loses a race at times
        got = _run(lib, fn._fn, [a])
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# K4 over the tuner's strategy spaces: every distinct derivation and grid
# ---------------------------------------------------------------------------

# the autotuner's kernels at small shapes: each candidate of each space
SPACE_SHAPES = {"scal": {"n": 4096}, "asum": {"n": 4096}, "dot": {"n": 4096},
                "rmsnorm": {"rows": 16, "d": 256},
                "softmax": {"rows": 16, "d": 64},
                "matmul": {"m": 64, "k": 64, "n": 64}}


def _space_programs(kernel):
    """(label, staged Program, generated program) of each candidate of
    ``kernel``'s space whose (derivation, grids) no earlier one has."""
    from repro_torch.autotune import space
    out, seen = [], set()
    for cand in space.enumerate_space(kernel, **SPACE_SHAPES[kernel]):
        prog = cand.program().check().lower()
        gen = prog.compile("cuda")._fn
        doc = cand.trace_doc() or {"steps": []}
        key = (tuple((s["rule"], tuple(sorted(s["params"].items())))
                     for s in doc["steps"]), tuple(gen.plan.grids))
        if key not in seen:
            seen.add(key)
            out.append((cand.params_key(), prog, gen))
    return out


def _emulated_batch(sources):
    """Several generated programs in one translation unit for
    tests/cuda_emu.h: program ``i`` in ``namespace c<i>`` with its entry
    points renamed ``c<i>_launch_stage<k>``."""
    parts = ['#include "cuda_emu.h"\n#include <math.h>\n']
    for i, src in enumerate(sources):
        body = _emulated(src).replace('#include "cuda_emu.h"\n', "")
        body = body.replace("#include <math.h>\n", "")
        body = body.replace("launch_stage", f"c{i}_launch_stage")
        parts.append(f"namespace c{i} {{\n{body}\n}}  // namespace c{i}\n")
    return "".join(parts)


@pytest.fixture(scope="module")
def space_libs(tmp_path_factory):
    """Each kernel's space as one library, the six g++ builds started
    together."""
    path = shutil.which("g++")
    if path is None:
        pytest.skip("needs g++ (C++20) to emulate the CUDA sources")
    out = tmp_path_factory.mktemp("emu_space")
    progs, procs = {}, {}
    for kernel in SPACE_SHAPES:
        progs[kernel] = _space_programs(kernel)
        cpp, so = out / f"{kernel}.cpp", out / f"{kernel}.so"
        cpp.write_text(_emulated_batch([g.source for _, _, g
                                        in progs[kernel]]))
        procs[kernel] = (so, subprocess.Popen(
            [path, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
             "-I", str(HERE), "-o", str(so), str(cpp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for kernel, (so, proc) in procs.items():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log[-3000:]
        libs[kernel] = ctypes.CDLL(str(so))
    return {k: (libs[k], progs[k]) for k in SPACE_SHAPES}


def _space_inputs(kernel, rng):
    shape = SPACE_SHAPES[kernel]

    def r(*s):
        return torch.tensor(rng.randn(*s), dtype=torch.float32)
    if kernel == "scal":
        return [r(1).reshape(()), r(shape["n"])]
    if kernel in ("asum", "dot"):
        return [r(shape["n"]) for _ in range(1 if kernel == "asum" else 2)]
    if kernel in ("rmsnorm", "softmax"):
        x = [r(shape["rows"], shape["d"])]
        return x + ([r(shape["d"])] if kernel == "rmsnorm" else [])
    return [r(shape["m"], shape["k"]), r(shape["k"], shape["n"])]


@pytest.mark.parametrize("kernel", sorted(SPACE_SHAPES))
def test_space_candidates_match_torch_stage3(space_libs, rng, kernel):
    """Each distinct (derivation, grid) of the kernel's space, as K4
    generates it (vectorize(128) under scal, ``leaf="seq"`` blocked
    reductions, row blocks 1-16, bm / bk 32-64), against the torch Stage
    III on the same inputs (fp32 in other orders: 1e-5)."""
    lib, progs = space_libs[kernel]
    assert len(progs) > 2
    args = _space_inputs(kernel, rng)
    for i, (label, prog, gen) in enumerate(progs):
        want = prog.compile("torch")(*args)
        got = _run(lib, gen, [a.reshape(-1).clone() for a in args],
                   prefix=f"c{i}_")
        np.testing.assert_allclose(got.reshape(want.shape).numpy(),
                                   want.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=f"{kernel} {label}")


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def k2(gxx):
    from repro_torch.kernels import matmul as mm
    lib = gxx("k2_matmul", _emulated((_build.CSRC / "matmul.cu").read_text()))
    fn = lib.repro_matmul
    fn.argtypes = mm._ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _k2_run(k2, a, b, out_dtype, tile=None):
    """One emulated ``repro_matmul`` as ``matmul._launch`` makes it, into an
    output that starts as NaN: ``(c, plan)``.  A bf16 shape the plan gives
    to wgmma (not in this source) runs the source's bf16 regime, ``mma``,
    which takes any bf16 shape; ``tile`` overrides a tf32x3 tile (square:
    rows and columns)."""
    from repro_torch.kernels import matmul as mm
    (m, k), n = a.shape, b.shape[1]
    p = mm.plan(m, n, k, a.dtype)
    if p.variant == "wgmma":
        p = mm.Plan("mma", (-(-n // 64), -(-m // 64), 1), 1, 0, 64, 64)
    if tile is not None:
        p = p._replace(block_m=tile, block_n=tile)
    c = torch.full((m, n), float("nan"), dtype=out_dtype)
    work = torch.full((max(1, p.workspace_bytes // 4),), float("nan"))
    codes = {torch.float32: 0, torch.bfloat16: 1}
    assert k2(a.data_ptr(), b.data_ptr(), c.data_ptr(),
              work.data_ptr() if p.split > 1 else None, m, n, k,
              codes[a.dtype], codes[out_dtype], mm._VARIANT_CODES[p.variant],
              p.block_m, p.block_n, p.split, None) == 0
    return c, p


def _k2_inputs(m, k, n, dtype):
    g = torch.Generator().manual_seed(m * 1000 + n)
    a = torch.randn((m, k), generator=g).to(dtype)
    b = torch.randn((k, n), generator=g).to(dtype)
    return a, b


# (m, k, n): the skinny regime with K split (3 x 1100 x 75: 16 parts of 69
# rows, B read one element at a time; 16 x 700 x 256: 8 parts of 88 rows
# over chunks of 256, 16 rows, 16-byte loads), tf32x3 (fp32) with ragged
# edges (130 x 20 x 129: 128 x 128 tiles; 37 x 100 x 75: 64 x 64 tiles, B's
# rows by 4-byte copies; 40 x 45 x 132: A's), and K = 0
MM_SOURCE_CASES = [(37, 100, 75), (130, 20, 129), (4, 64, 200), (5, 0, 3),
                   (3, 1100, 75), (16, 700, 256), (40, 45, 132)]
# the regime each case takes in fp32 and in bf16
MM_SOURCE_REGIMES = {
    (37, 100, 75): ("tf32x3", "mma"), (130, 20, 129): ("tf32x3", "mma"),
    (4, 64, 200): ("skinny", "mma"), (5, 0, 3): ("skinny", "mma"),
    (3, 1100, 75): ("skinny", "mma"), (16, 700, 256): ("skinny", "mma"),
    (40, 45, 132): ("tf32x3", "mma")}


@pytest.mark.parametrize("m,k,n", MM_SOURCE_CASES)
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_matmul_source_matches_plain(k2, m, k, n, dtype, out_dtype):
    """K2's regimes, masked ragged edges and splits, in every dtype pair:
    fp32 sums in another order, in 3xTF32 for tf32x3 (1e-4); a bf16
    output may round one ulp apart (2**-8 relative)."""
    a, b = _k2_inputs(m, k, n, dtype)
    c, p = _k2_run(k2, a, b, out_dtype)
    assert p.variant == MM_SOURCE_REGIMES[(m, k, n)][dtype == torch.bfloat16]
    if dtype == torch.float32 and (m, k, n) in ((3, 1100, 75),
                                                (16, 700, 256)):
        assert p.split == (16 if m == 3 else 8)
    tol = 1e-4 if out_dtype == torch.float32 else 1e-2
    torch.testing.assert_close(c.float(), ref.matmul(a, b, out_dtype=out_dtype)
                               .float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("block_n", [64, 128])
def test_matmul_tf32x3_source_at_both_tile_widths(k2, block_n):
    """Both tf32x3 tiles, 64 x 64 (the plan's for M <= 64) and 128 x 128,
    at one shape ragged in every dimension, against the plain version
    (1e-4)."""
    a, b = _k2_inputs(150, 37, 200, torch.float32)
    c, p = _k2_run(k2, a, b, torch.float32, tile=block_n)
    assert p.variant == "tf32x3" and (p.block_m, p.block_n) == (block_n,
                                                                block_n)
    torch.testing.assert_close(c, ref.matmul(a, b), rtol=1e-4, atol=1e-4)


# 0x7fffffff: the NaN the card's fp32 arithmetic makes (0/0, Inf - Inf),
# whose mantissa a rounding by adding 0x1000 would carry into the sign
CUDA_NAN = 0x7FFFFFFF


def _cuda_nan():
    return torch.tensor([CUDA_NAN], dtype=torch.int64).to(
        torch.int32).view(torch.float32)[0]


@pytest.mark.parametrize("m,k,n", [(37, 100, 75), (130, 20, 129)])
def test_matmul_tf32x3_source_keeps_nan(k2, m, k, n):
    """A NaN in A (row 3) and in B (column 7), both 0x7fffffff: the
    output's NaNs are the plain version's, row 3 and column 7, at both
    tiles; 3xTF32 turns no NaN into a finite value."""
    a, b = _k2_inputs(m, k, n, torch.float32)
    a[3, k // 2] = _cuda_nan()
    b[k - 1, 7] = _cuda_nan()
    c, p = _k2_run(k2, a, b, torch.float32)
    assert p.variant == "tf32x3"
    want = ref.matmul(a, b)
    assert torch.isnan(want[3]).all() and torch.isnan(want[:, 7]).all()
    assert torch.equal(torch.isnan(c), torch.isnan(want))
    fin = ~torch.isnan(want)
    torch.testing.assert_close(c[fin], want[fin], rtol=1e-4, atol=1e-4)


def test_matmul_skinny_source_split_is_bitwise_repeatable(k2):
    """The skinny regime's partials meet in a fixed order (warps, then
    parts): two runs give the same bits."""
    a, b = _k2_inputs(16, 700, 256, torch.float32)
    (x, p), (y, _) = (_k2_run(k2, a, b, torch.float32) for _ in range(2))
    assert p.variant == "skinny" and p.split > 1
    assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the tensor-core primitives (csrc/tc_sm80.cuh) and K3
# ---------------------------------------------------------------------------

PRIMITIVES = r"""
#include "cuda_emu.h"
// one warp; matrix i of the x4 loads is the 8 x 8 quadrant of a 16 x 16
// b16 tile at rows 8 (i % 2), columns 8 (i / 2)
extern "C" void ldm(const uint16_t* tile, uint32_t* plain, uint32_t* trans) {
  emu_launch(dim3(1), 32, [&] {
    const int lane = threadIdx.x, i = lane / 8, r = lane % 8;
    const uint16_t* p = tile + (8 * (i % 2) + r) * 16 + 8 * (i / 2);
    ldmatrix_x4(plain + 4 * lane, p);
    ldmatrix_x4_trans(trans + 4 * lane, p);
  });
}
extern "C" void mma(const uint32_t* a, const uint32_t* b, float* d) {
  emu_launch(dim3(1), 32, [&] {
    const int l = threadIdx.x;
    mma_16816_bf16(d + 4 * l, a + 4 * l, b + 2 * l);
  });
}
extern "C" void cpa(const char* src, char* dst, int n, const int* bytes) {
  emu_launch(dim3(1), 32, [&] {
    for (int c = threadIdx.x; c < n; c += 32)
      cp_async_16(dst + 16 * c, src + 16 * c, bytes[c]);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  });
}
extern "C" uint32_t pack(float lo, float hi) { return pack_bf16x2(lo, hi); }
extern "C" void tf32(const float* x, uint32_t* hi, uint32_t* lo, int n) {
  for (int i = 0; i < n; ++i) split_tf32(x[i], hi[i], lo[i]);
}
// one warp: d += A.B by mma.m16n8k8 tf32 (threes = 0) or by the 3xTF32
// triple from fp32 fragments split in the lanes (threes = 1)
extern "C" void mma8(const uint32_t* a, const uint32_t* b, float* d,
                     int threes) {
  emu_launch(dim3(1), 32, [&] {
    const int l = threadIdx.x;
    if (!threes) { mma_1688_tf32(d + 4 * l, a + 4 * l, b + 2 * l); return; }
    uint32_t ah[4], al[4], bh[2], bl[2];
    for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(a[4 * l + i]), ah[i], al[i]);
    for (int i = 0; i < 2; ++i) split_tf32(__uint_as_float(b[2 * l + i]), bh[i], bl[i]);
    mma_1688_3xtf32(d + 4 * l, ah, al, bh, bl);
  });
}
"""


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 values (already bf16-representable) as their bf16 bits."""
    return (np.ascontiguousarray(x, np.float32).view(np.uint32) >> 16
            ).astype(np.uint32)


def _pair(lo, hi):
    """Two bf16 bit patterns in one register, ``lo`` in the low half."""
    return lo | hi << 16


@pytest.fixture(scope="module")
def prims(gxx):
    return gxx("tc_primitives", PRIMITIVES)


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def test_emulated_ldmatrix_layouts(prims):
    """ldmatrix.x4 (and .trans): lane l's register i holds row l // 4,
    columns 2 (l % 4) and 2 (l % 4) + 1 of matrix i (of its transpose)."""
    tile = np.arange(256, dtype=np.uint16).reshape(16, 16)
    plain = np.zeros((32, 4), np.uint32)
    trans = np.zeros((32, 4), np.uint32)
    prims.ldm(_ptr(tile), _ptr(plain), _ptr(trans))
    for lane in range(32):
        g, c = lane // 4, 2 * (lane % 4)
        for i in range(4):
            q = tile[8 * (i % 2):8 * (i % 2) + 8, 8 * (i // 2):8 * (i // 2) + 8]
            q = q.astype(np.uint32)
            assert plain[lane, i] == _pair(q[g, c], q[g, c + 1])
            assert trans[lane, i] == _pair(q[c, g], q[c + 1, g])


def test_emulated_mma_16816_matches_numpy(prims, rng):
    """mma.m16n8k16 on fragments laid out as the PTX ISA documents them
    (A row major, B k-down, C / D by rows g and g + 8): D = A.B + C."""
    def bf16(*s):
        return torch.tensor(rng.randn(*s), dtype=torch.float32).to(
            torch.bfloat16).float().numpy()
    A, B, C = bf16(16, 16), bf16(16, 8), bf16(16, 8)
    a = np.zeros((32, 4), np.uint32)
    b = np.zeros((32, 2), np.uint32)
    d = np.zeros((32, 4), np.float32)
    Ab, Bb = _bf16_bits(A), _bf16_bits(B)
    for lane in range(32):
        g, c = lane // 4, 2 * (lane % 4)
        for i, (r, k) in enumerate([(g, c), (g + 8, c), (g, c + 8),
                                    (g + 8, c + 8)]):
            a[lane, i] = _pair(Ab[r, k], Ab[r, k + 1])
        b[lane] = [_pair(Bb[c, g], Bb[c + 1, g]),
                   _pair(Bb[c + 8, g], Bb[c + 9, g])]
        d[lane] = [C[g, c], C[g, c + 1], C[g + 8, c], C[g + 8, c + 1]]
    prims.mma(_ptr(a), _ptr(b), _ptr(d))
    want = A.astype(np.float64) @ B + C
    for lane in range(32):
        g, c = lane // 4, 2 * (lane % 4)
        np.testing.assert_allclose(
            d[lane], [want[g, c], want[g, c + 1], want[g + 8, c],
                      want[g + 8, c + 1]], rtol=1e-6, atol=1e-6)


def test_emulated_cp_async_copies_or_zero_fills(prims, rng):
    src = rng.randint(1, 255, size=(40, 16)).astype(np.uint8)
    dst = np.full((40, 16), 7, np.uint8)
    nbytes = np.where(np.arange(40) % 3 == 0, 0, 16).astype(np.int32)
    prims.cpa(_ptr(src), _ptr(dst), 40, _ptr(nbytes))
    want = np.where((nbytes == 16)[:, None], src, 0)
    np.testing.assert_array_equal(dst, want)


@pytest.mark.parametrize("lo,hi", [(1.0, -2.5), (1.00390625, 3.0e-3),
                                   (1.01171875, -65504.0), (0.0, 1e30)])
def test_emulated_pack_bf16x2_rounds_like_torch(prims, lo, hi):
    prims.pack.restype = ctypes.c_uint32
    prims.pack.argtypes = [ctypes.c_float, ctypes.c_float]
    bits = torch.tensor([lo, hi]).to(torch.bfloat16).view(torch.int16)
    want = [int(x) & 0xffff for x in bits]
    assert prims.pack(lo, hi) == _pair(want[0], want[1])


def _tf32_rna(x: float) -> float:
    """x rounded to tf32 (11 significant bits), to nearest with ties away
    from zero, in float64: independent of the bit trick under test."""
    m, e = np.frexp(np.float64(x))               # |m| in [0.5, 1)
    scaled = np.ldexp(m, 11)
    r = np.sign(scaled) * np.floor(np.abs(scaled) + 0.5)
    return float(np.ldexp(r, int(e) - 11))


def _split(prims, x):
    x = np.ascontiguousarray(x, np.float32)
    hi = np.zeros(x.shape, np.uint32)
    lo = np.zeros(x.shape, np.uint32)
    prims.tf32(_ptr(x), _ptr(hi), _ptr(lo), x.size)
    return hi, lo


def test_emulated_cvt_rna_tf32_rounds_to_nearest_ties_away(prims, rng):
    """cvt.rna.tf32.f32 bit for bit: the low 13 bits cleared, ties (low
    bits exactly 0x1000) away from zero for either sign, a carry into the
    exponent, NaN and Inf kept; random normal values against a float64
    rounding to 11 significant bits."""
    cases = {0x3F801000: 0x3F802000, 0xBF801000: 0xBF802000,   # ties
             0x3F802FFF: 0x3F802000, 0x3F803000: 0x3F804000,   # below; tie
             0x3F800FFF: 0x3F800000, 0xBF800FFF: 0xBF800000,   # below
             0x3F801001: 0x3F802000, 0xC0001001: 0xC0002000,   # above
             0x3FFFFFFF: 0x40000000, 0x7F800000: 0x7F800000,   # carry; Inf
             0xFF800000: 0xFF800000, 0x00000000: 0x00000000}
    bits = np.array(list(cases), np.uint32)
    hi, _ = _split(prims, bits.view(np.float32))
    assert [hex(h) for h in hi] == [hex(v) for v in cases.values()]
    nan, _ = _split(prims, np.array([np.nan], np.float32))
    assert np.isnan(nan.view(np.float32)[0])
    x = (rng.randn(2000) * np.exp2(rng.randint(-60, 60, 2000))).astype(
        np.float32)
    hi, _ = _split(prims, x)
    assert not (hi & 0x1FFF).any()
    np.testing.assert_array_equal(hi.view(np.float32).astype(np.float64),
                                  [_tf32_rna(v) for v in x])


def test_emulated_cvt_rna_tf32_of_a_nan_clears_the_low_bits(prims):
    """hi of a NaN is cvt.rna's (as the card gives it): the NaN with its low
    13 bits cleared, so 0x7fffffff (the card's 0/0) and the NaNs of the
    highest mantissas, whose rounding by an add would carry into the sign,
    stay NaN; only a payload wholly in the low 13 bits becomes Inf.  Inf
    gives hi = Inf."""
    nans = np.array([CUDA_NAN, 0xFFFFFFFF, 0x7FFFF000, 0xFFFFF000,
                     0x7FC00000, 0x7F800001, 0xFF801000], np.uint32)
    hi, _ = _split(prims, nans.view(np.float32))
    assert [hex(h) for h in hi] == [hex(v & 0xFFFFE000) for v in nans]
    assert np.isnan(hi[:5].view(np.float32)).all()
    inf = np.array([np.inf, -np.inf], np.float32)
    hi, _ = _split(prims, inf)
    np.testing.assert_array_equal(hi.view(np.float32), inf)


def test_emulated_split_tf32_hi_plus_lo_is_x_to_2_pow_minus_22(prims, rng):
    """hi + lo recovers x to 2**-22 relative (both halves tf32: low 13
    bits clear); hi alone only to 2**-11."""
    x = (rng.randn(5000) * np.exp2(rng.randint(-40, 40, 5000))).astype(
        np.float32)
    hi, lo = _split(prims, x)
    assert not ((hi | lo) & 0x1FFF).any()
    h = hi.view(np.float32).astype(np.float64)
    l_ = lo.view(np.float32).astype(np.float64)
    err = np.abs(x.astype(np.float64) - h - l_) / np.abs(x)
    assert err.max() <= 2.0 ** -22
    assert (np.abs(x - h) / np.abs(x)).max() > 2.0 ** -14


def _tf32_fragments(A, B, C):
    """m16n8k8 tf32 fragments of A (16 x 8), B (8 x 8, k down) and C (16 x
    8) as the PTX ISA lays them out: a0 (g, t), a1 (g+8, t), a2 (g, t+4),
    a3 (g+8, t+4); b0 (k t, n g), b1 (k t+4, n g); C as m16n8k16's."""
    a = np.zeros((32, 4), np.uint32)
    b = np.zeros((32, 2), np.uint32)
    d = np.zeros((32, 4), np.float32)
    Ab = np.ascontiguousarray(A, np.float32).view(np.uint32)
    Bb = np.ascontiguousarray(B, np.float32).view(np.uint32)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        a[lane] = [Ab[g, t], Ab[g + 8, t], Ab[g, t + 4], Ab[g + 8, t + 4]]
        b[lane] = [Bb[t, g], Bb[t + 4, g]]
        d[lane] = [C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t],
                   C[g + 8, 2 * t + 1]]
    return a, b, d


def _c_fragment(d):
    """The 16 x 8 matrix a C / D fragment holds."""
    out = np.zeros((16, 8), np.float64)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        out[g, 2 * t], out[g, 2 * t + 1] = d[lane, 0], d[lane, 1]
        out[g + 8, 2 * t], out[g + 8, 2 * t + 1] = d[lane, 2], d[lane, 3]
    return out


def test_emulated_mma_1688_tf32_matches_numpy(prims, rng):
    """mma.m16n8k8 tf32 on fragments laid out as the PTX ISA documents
    them: D = A.B + C (tf32 inputs: the products are exact in fp32)."""
    def tf32(*s):
        return np.vectorize(_tf32_rna)(rng.randn(*s)).astype(np.float32)
    A, B, C = tf32(16, 8), tf32(8, 8), tf32(16, 8)
    a, b, d = _tf32_fragments(A, B, C)
    prims.mma8(_ptr(a), _ptr(b), _ptr(d), 0)
    np.testing.assert_allclose(_c_fragment(d),
                               A.astype(np.float64) @ B + C, rtol=1e-6,
                               atol=1e-6)


def test_emulated_3xtf32_keeps_fp32_level_error(prims, rng):
    """fp32 operands through the 3xTF32 triple: within a few 2**-22 of
    sum |a b| of the float64 product, where one tf32 product is ~1000 x
    further off."""
    A = rng.randn(16, 8).astype(np.float32)
    B = rng.randn(8, 8).astype(np.float32)
    want = A.astype(np.float64) @ B
    scale = np.abs(A).astype(np.float64) @ np.abs(B)
    a, b, d = _tf32_fragments(A, B, np.zeros((16, 8), np.float32))
    prims.mma8(_ptr(a), _ptr(b), _ptr(d), 1)
    assert (np.abs(_c_fragment(d) - want) / scale).max() <= 4 * 2.0 ** -22
    d1 = np.zeros((32, 4), np.float32)
    prims.mma8(_ptr(a), _ptr(b), _ptr(d1), 0)      # hi bits only: tf32
    assert (np.abs(_c_fragment(d1) - want) / scale).max() > 2.0 ** -14


def test_emulated_c_fragment_is_an_a_fragment_under_permuted_k(prims, rng):
    """A C fragment of X (16 x 8) reused as an A fragment, a = {c0, c2, c1,
    c3} (slot t is column 2t, slot t + 4 column 2t + 1), times B loaded
    in the same order (b0 from row 2t, b1 from row 2t + 1) is X.Y; B in
    the natural order (rows t, t + 4) is not."""
    def tf32(*s):
        return np.vectorize(_tf32_rna)(rng.randn(*s)).astype(np.float32)
    X, Y = tf32(16, 8), tf32(8, 8)
    _, _, c = _tf32_fragments(np.zeros((16, 8)), np.zeros((8, 8)), X)
    cb = c.view(np.uint32)
    a = np.ascontiguousarray(cb[:, [0, 2, 1, 3]])
    Yb = Y.view(np.uint32)
    want = X.astype(np.float64) @ Y
    for permuted in (True, False):
        b = np.zeros((32, 2), np.uint32)
        for lane in range(32):
            g, t = lane // 4, lane % 4
            b[lane] = ([Yb[2 * t, g], Yb[2 * t + 1, g]] if permuted
                       else [Yb[t, g], Yb[t + 4, g]])
        d = np.zeros((32, 4), np.float32)
        prims.mma8(_ptr(a), _ptr(b), _ptr(d), 0)
        close = np.allclose(_c_fragment(d), want, rtol=1e-6, atol=1e-6)
        assert close == permuted


@pytest.fixture(scope="module")
def k3_lib(gxx):
    return gxx("k3_flash", _emulated((_build.CSRC / "flash_attention.cu")
                                     .read_text()))


@pytest.fixture(scope="module")
def k3(k3_lib):
    from repro_torch.kernels import flash_attention as fa
    fn = k3_lib.repro_flash_attention
    fn.argtypes = fa._ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@pytest.fixture(scope="module")
def k3_bwd(k3_lib):
    from repro_torch.kernels import flash_attention as fa
    fn = k3_lib.repro_flash_attention_bwd
    fn.argtypes = fa._BWD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


# K3 under emulation against its plain version.  fp32 (the SIMT kernel):
# the same fp32 arithmetic in another order.  bf16 (the mma kernel): P
# rounded to bf16 before P.V adds at most 2**-9 relative per term, under
# the output's own bf16 rounding (2**-8).
K3_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
K3_CASES = ([(2, 1, s, s, d, causal, 0) for s in (1, 37, 70)
             for d in (16, 64) for causal in (True, False)]
            + [(4, 2, 5, 70, 64, True, 65), (2, 2, 66, 3, 32, False, 0)])


@pytest.mark.parametrize("bh,bkv,sq,sk,d,causal,q_offset", K3_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_source_matches_plain(k3, bh, bkv, sq, sk, d, causal,
                                              q_offset, dtype):
    g = torch.Generator().manual_seed(sq * 100 + d)
    q = (0.5 * torch.randn((bh, sq, d), generator=g)).to(dtype)
    k = (0.5 * torch.randn((bkv, sk, d), generator=g)).to(dtype)
    v = torch.randn((bkv, sk, d), generator=g).to(dtype)
    o = torch.full((bh, sq, d), float("nan"), dtype=dtype)
    code = {torch.float32: 0, torch.bfloat16: 1}[dtype]
    assert k3(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None,
              code, bh, bkv, sq, sk, d, 1.0 / d ** 0.5, int(causal),
              q_offset, None) == 0
    want = ref.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    tol = K3_TOL[dtype]
    torch.testing.assert_close(o.float(), want.float(), rtol=tol, atol=tol)


def _k3_inputs(bh, bkv, sq, sk, d, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    q = (0.5 * torch.randn((bh, sq, d), generator=g)).to(dtype)
    k = (0.5 * torch.randn((bkv, sk, d), generator=g)).to(dtype)
    v = torch.randn((bkv, sk, d), generator=g).to(dtype)
    return q, k, v, g


# the row log-sum-exp both variants write when asked: fp32 against the
# plain version's, from the same inputs (bf16: the same bf16 inputs; the
# kernel's exp2 in the log2 domain and another order of sums)
@pytest.mark.parametrize("bh,bkv,sq,sk,d,causal,q_offset",
                         [(2, 1, 37, 37, 16, True, 0),
                          (4, 2, 70, 70, 64, False, 0),
                          (4, 2, 5, 70, 32, True, 65)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_source_writes_lse(k3, bh, bkv, sq, sk, d, causal,
                                           q_offset, dtype):
    q, k, v, _ = _k3_inputs(bh, bkv, sq, sk, d, dtype, sq + d)
    o = torch.full((bh, sq, d), float("nan"), dtype=dtype)
    lse = torch.full((bh, sq), float("nan"))
    code = {torch.float32: 0, torch.bfloat16: 1}[dtype]
    assert k3(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              lse.data_ptr(), code, bh, bkv, sq, sk, d, 1.0 / d ** 0.5,
              int(causal), q_offset, None) == 0
    want_o, want_lse = ref.flash_attention(q, k, v, causal=causal,
                                           q_offset=q_offset, return_lse=True)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    tol = K3_TOL[dtype]
    torch.testing.assert_close(o.float(), want_o.float(), rtol=tol, atol=tol)


# K3's backward under emulation against its plain version, from the plain
# forward's output and lse.  fp32 (the tf32x3 kernels): fp32 sums in
# another order (over up to 130 keys and a GQA group), each product in
# 3xTF32 (within about 3 x 2**-22 relative of fp32's).
# bf16 (the mma kernels): S, dP and every sum in fp32 from the same bf16
# inputs; P rounded to bf16 before dV's product and dS before dK's and
# dQ's add at most 2**-9 relative to each term, under the gradients' own
# rounding (2**-8 relative) of values of order 1.
K3_BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# (bh, bkv, s, d, causal): one tile; three 64-tiles with a ragged edge
# (130); a GQA group of 4 at D = 128; non-causal over two tiles
K3_BWD_CASES = [(2, 1, 37, 16, True), (4, 2, 70, 32, True),
                (2, 2, 33, 64, False), (2, 1, 5, 128, True),
                (4, 1, 64, 16, True), (2, 1, 130, 32, True),
                (4, 1, 70, 128, True), (2, 1, 100, 16, False)]


def _k3_bwd_run(k3_bwd, bh, bkv, s, d, causal, dtype, nan_in=None):
    """One emulated ``repro_flash_attention_bwd`` from the plain forward's
    output and lse, outputs starting as NaN: ``(grads, inputs)``.
    ``nan_in`` ("q" or "do") puts 0x7fffffff at one element of that
    input (q's before the forward)."""
    q, k, v, g = _k3_inputs(bh, bkv, s, s, d, dtype, 3 * s + d)
    if nan_in == "q":
        q[1, s // 2, 3] = _cuda_nan()
    o, lse = ref.flash_attention(q, k, v, causal=causal, return_lse=True)
    do = torch.randn((bh, s, d), generator=g).to(dtype)
    if nan_in == "do":
        do[0, s // 3, 5] = _cuda_nan()
    outs = [torch.full(t.shape, float("nan"), dtype=dtype) for t in (q, k, v)]
    delta = torch.full((bh, s), float("nan"))
    code = {torch.float32: 0, torch.bfloat16: 1}[dtype]
    assert k3_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), do.data_ptr(),
                  *[t.data_ptr() for t in outs], delta.data_ptr(), code, bh,
                  bkv, s, s, d, 1.0 / d ** 0.5, int(causal), None) == 0
    return outs, (q, k, v, o, lse, do)


@pytest.mark.parametrize("bh,bkv,s,d,causal", K3_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_source_matches_plain(k3_bwd, bh, bkv, s, d,
                                                  causal, dtype):
    outs, inputs = _k3_bwd_run(k3_bwd, bh, bkv, s, d, causal, dtype)
    want = ref.flash_attention_bwd(*inputs, causal=causal)
    tol = K3_BWD_TOL[dtype]
    for name, got, w in zip(("dq", "dk", "dv"), outs, want):
        assert torch.isfinite(got.float()).all(), f"{name} never written"
        torch.testing.assert_close(got.float(), w.float(), rtol=tol, atol=tol,
                                   msg=lambda m: f"{name}: {m}")


def test_flash_attention_bwd_mma_source_is_bitwise_repeatable(k3_bwd):
    """No atomics, sums in a fixed order: two runs of the bf16 kernels
    (three tiles, a ragged edge, a GQA group of 2) give the same bits."""
    a, _ = _k3_bwd_run(k3_bwd, 4, 2, 150, 32, True, torch.bfloat16)
    b, _ = _k3_bwd_run(k3_bwd, 4, 2, 150, 32, True, torch.bfloat16)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_attention_bwd_tf32x3_source_is_bitwise_repeatable(k3_bwd):
    """The fp32 (3xTF32) kernels likewise: no atomics, every sum in a fixed
    order, so two runs give the same bits."""
    a, _ = _k3_bwd_run(k3_bwd, 4, 2, 150, 32, True, torch.float32)
    b, _ = _k3_bwd_run(k3_bwd, 4, 2, 150, 32, True, torch.float32)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("nan_in", ["do", "q"])
def test_flash_attention_bwd_tf32x3_source_keeps_nan(k3_bwd, nan_in):
    """A NaN (0x7fffffff) in dO or in q reaches D, dP and dS, which the fp32
    kernels split to 3xTF32 (dS^T as a C fragment reused as an A
    fragment): dQ, dK and dV are NaN where the plain version's are
    (non-causal, so that neither skips a masked tile), and agree with it
    elsewhere."""
    outs, inputs = _k3_bwd_run(k3_bwd, 2, 1, 70, 32, False, torch.float32,
                               nan_in=nan_in)
    want = ref.flash_attention_bwd(*inputs, causal=False)
    for name, got, w in zip(("dq", "dk", "dv"), outs, want):
        assert torch.isnan(w).any(), name
        assert torch.equal(torch.isnan(got), torch.isnan(w)), name
        fin = ~torch.isnan(w)
        tol = K3_BWD_TOL[torch.float32]
        torch.testing.assert_close(got[fin], w[fin], rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# K1 (csrc/rmsnorm.cu): every variant, both dtypes, both access widths
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def k1(gxx):
    from repro_torch.kernels import rmsnorm as rms
    lib = gxx("k1_rmsnorm", _emulated((_build.CSRC / "rmsnorm.cu")
                                      .read_text()))
    fn = lib.repro_rmsnorm
    fn.argtypes = rms._ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _k1_run(k1, x, w, eps=1e-6):
    """One launch of the emulated K1 as ``rmsnorm._launch`` makes it, into
    an output that starts as NaN; returns the output and the plan."""
    from repro_torch.kernels import rmsnorm as rms
    d = x.shape[-1]
    rows = x.numel() // d
    y = torch.full(x.shape, float("nan"), dtype=x.dtype)
    p = rms.plan(rows, d, x.dtype,
                 aligned=not (x.data_ptr() | w.data_ptr()) & 15)
    assert k1(x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d, eps,
              int(x.dtype == torch.bfloat16), p.vector, p.threads_per_row,
              p.vectors_per_thread, p.threads, p.grid, None) == 0
    return y, p


def _assert_k1_close(got, want):
    """bf16: within one bf16 ulp of the plain version (the row sums run in
    another order, which may flip one rounding); fp32: 1e-6 relative."""
    assert torch.isfinite(got.float()).all(), "an element was never written"
    if want.dtype == torch.bfloat16:
        want = want.float()
        ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want)[1] - 8)
        err = (got.float() - want).abs()
        assert (err <= ulp).all(), f"max err {err.max()} beyond one ulp"
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


# (rows, d): packed (1, 1), (37, 64), (9, 24) -- lanes of a group masked
# off --, (3, 128) and (37, 128) (rows past the last full block); warp
# (140, 2560) and (140, 100) (bf16: one element an access); fewer rows
# than SMs, a block a row: (5, 2560) and (2, 100) (bf16: one element an
# access; fp32: 25 accesses, a warp); long rows (2, 9000) and a row read
# twice (1, 20000)
K1_SHAPES = [(1, 1), (3, 128), (37, 128), (37, 64), (9, 24), (140, 2560),
             (140, 100), (5, 2560), (2, 100), (2, 9000), (1, 20000)]
K1_VARIANTS = {torch.bfloat16: ["packed", "packed", "packed", "packed",
                                "packed", "warp", "warp", "block", "block",
                                "block", "block"],
               torch.float32: ["packed", "warp", "warp", "packed", "packed",
                               "warp", "warp", "block", "warp", "block",
                               "block"]}


@pytest.mark.parametrize("shape", K1_SHAPES,
                         ids=[f"{r}x{d}" for r, d in K1_SHAPES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_source_matches_plain(k1, shape, dtype):
    """Each variant's lane groups, masks and reductions against the plain
    version; the planned variant as K1_VARIANTS says."""
    variant = K1_VARIANTS[dtype][K1_SHAPES.index(shape)]
    g = torch.Generator().manual_seed(shape[0] * 10007 + shape[1])
    x = torch.randn(shape, generator=g).to(dtype)
    w = (1 + 0.5 * torch.randn(shape[-1], generator=g)).to(dtype)
    got, p = _k1_run(k1, x, w)
    assert p.variant == variant
    assert p.vector == ((shape[-1] * x.element_size()) % 16 == 0)
    _assert_k1_close(got, ref.rmsnorm(x, w))


@pytest.mark.parametrize("rows,variant", [(37, "block"), (140, "warp")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_source_misaligned_view_takes_scalar_accesses(k1, dtype, rows,
                                                              variant):
    """Rows cut from a flat buffer one element in: no 16-byte accesses,
    the same values."""
    g = torch.Generator().manual_seed(5)
    flat = torch.randn(1 + rows * 128, generator=g).to(dtype)
    x = flat[1:].view(rows, 128)
    w = (1 + 0.5 * torch.randn(128, generator=g)).to(dtype)
    got, p = _k1_run(k1, x, w)
    assert not p.vector and p.variant == variant
    _assert_k1_close(got, ref.rmsnorm(x, w))


def test_rmsnorm_source_is_bitwise_repeatable(k1):
    """A fixed order of additions: two runs give the same bits."""
    g = torch.Generator().manual_seed(6)
    x = torch.randn(3, 9000, generator=g)
    w = torch.randn(9000, generator=g)
    a, _ = _k1_run(k1, x, w)
    b, _ = _k1_run(k1, x, w)
    assert torch.equal(a, b)


@pytest.fixture(scope="module")
def k1_bwd(gxx):
    from repro_torch.kernels import rmsnorm as rms
    lib = gxx("k1_rmsnorm_bwd", _emulated((_build.CSRC / "rmsnorm.cu")
                                          .read_text()))
    fn = lib.repro_rmsnorm_bwd
    fn.argtypes = rms._BWD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _k1_bwd_run(k1_bwd, x, w, dy, eps=1e-6):
    """One emulated ``repro_rmsnorm_bwd`` as ``rmsnorm._launch_bwd`` makes
    it, outputs starting as NaN: ``(dx, dw)`` and the plan."""
    from repro_torch.kernels import rmsnorm as rms
    d = x.shape[-1]
    rows = x.numel() // d
    dx = torch.full(x.shape, float("nan"), dtype=x.dtype)
    dw = torch.full((d,), float("nan"), dtype=x.dtype)
    ptrs = x.data_ptr() | w.data_ptr() | dy.data_ptr() | dx.data_ptr()
    p = rms.bwd_plan(rows, d, x.dtype, aligned=not ptrs & 15)
    partial = torch.full((p.blocks, d), float("nan"))
    assert k1_bwd(x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                  dw.data_ptr(), partial.data_ptr(), rows, d, eps,
                  int(x.dtype == torch.bfloat16), p.vector,
                  p.threads_per_row, p.vectors_per_thread, p.blocks,
                  None) == 0
    return (dx, dw), p


def _assert_k1_bwd_close(got, want, rows):
    """fp32: the same arithmetic in another order (dw sums up to 4300
    rows).  bf16: each gradient is one rounding of nearly the same fp32
    value (2**-8 relative), dw's row sums growing with the rows."""
    (dx, dw), (want_dx, want_dw) = got, want
    tol = 1e-5 if dx.dtype == torch.float32 else 1e-2
    assert torch.isfinite(dx.float()).all() and torch.isfinite(dw.float()).all()
    torch.testing.assert_close(dx.float(), want_dx.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(dw.float(), want_dw.float(), rtol=tol,
                               atol=tol * rows ** 0.5)


# K1's backward against its plain version, with the layout bwd_plan()
# gives (threads a row, accesses a thread; bf16 / fp32): lanes masked off
# (24: 4 / 8 lanes; 100: one element an access in bf16, 32 x 4), a d_model
# row (2560: 32 x 10 / 64 x 10, two warps' sums through shared memory),
# two rows a warp (128 bf16: 16 lanes), one row, several blocks of
# several passes each (4300 x 8: 1 / 2 lanes a row, 17 / 34 blocks; 600 x
# 2560: 75 / 132 blocks), rows of 128 / 256 threads (9000) and one
# element an access past 2560 (9001: 256 x 40).
K1_BWD_SHAPES = [(1, 1), (3, 24), (37, 128), (5, 2560), (140, 100),
                 (4300, 8), (600, 2560), (2, 9000), (2, 9001)]


@pytest.mark.parametrize("shape", K1_BWD_SHAPES,
                         ids=[f"{r}x{d}" for r, d in K1_BWD_SHAPES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_source_matches_plain(k1_bwd, shape, dtype):
    g = torch.Generator().manual_seed(shape[0] * 31 + shape[1])
    x = torch.randn(shape, generator=g).to(dtype)
    w = (1 + 0.5 * torch.randn(shape[-1], generator=g)).to(dtype)
    dy = torch.randn(shape, generator=g).to(dtype)
    got, p = _k1_bwd_run(k1_bwd, x, w, dy)
    assert p.vector == ((shape[-1] * x.element_size()) % 16 == 0)
    _assert_k1_bwd_close(got, ref.rmsnorm_bwd(x, w, dy), shape[0])


@pytest.mark.parametrize("rows,d", [(37, 128), (140, 2560)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_source_misaligned_view_takes_scalar_accesses(
        k1_bwd, dtype, rows, d):
    """Rows cut from a flat buffer one element in: one element an access
    (d_model: 256 threads x 10), the same values."""
    g = torch.Generator().manual_seed(9)
    flat = torch.randn(2, 1 + rows * d, generator=g).to(dtype)
    x, dy = flat[0, 1:].view(rows, d), flat[1, 1:].view(rows, d)
    w = (1 + 0.5 * torch.randn(d, generator=g)).to(dtype)
    got, p = _k1_bwd_run(k1_bwd, x, w, dy)
    assert not p.vector
    _assert_k1_bwd_close(got, ref.rmsnorm_bwd(x, w, dy), rows)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_source_is_bitwise_repeatable(k1_bwd, dtype):
    """dw is a fixed-order column sum over several blocks of several
    passes: two runs give the same bits."""
    g = torch.Generator().manual_seed(8)
    x, dy = (torch.randn(600, 96, generator=g).to(dtype) for _ in range(2))
    w = torch.randn(96, generator=g).to(dtype)
    (a, p), (b, _) = (_k1_bwd_run(k1_bwd, x, w, dy) for _ in range(2))
    assert p.blocks > 1
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("shape", [(37, 128), (140, 2560), (5, 2560),
                                   (2, 9000)])
def test_rmsnorm_source_rounds_in_the_reference_order(k1, shape):
    """Integer rows sum exactly in any order, so the kernel's bf16 output
    equals the plain version bit for bit: the row is rounded to bf16
    before ``* w``; rounding only the product would differ."""
    g = torch.Generator().manual_seed(7)
    x = torch.randint(-4, 5, shape, generator=g).to(torch.bfloat16)
    w = (3 * torch.randn(shape[-1], generator=g)).to(torch.bfloat16)
    got, _ = _k1_run(k1, x, w)
    want = ref.rmsnorm(x, w)
    assert torch.equal(got, want)
    x32 = x.float()
    fused = (x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-6)
             * w.float()).to(torch.bfloat16)
    assert not torch.equal(got, fused)
