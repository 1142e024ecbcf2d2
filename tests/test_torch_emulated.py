"""The port's CUDA sources run on the CPU under an emulation of the CUDA
subset they use (tests/cuda_emu.h, compiled with the host's g++): K4's
generated programs against the torch Stage III, K1 (csrc/rmsnorm.cu: every
variant, in both dtypes and both access widths), K2's SIMT kernel
(csrc/matmul.cu) and both K3 kernels (csrc/flash_attention.cu: the bf16
tensor-core path and the fp32 SIMT path) against their plain versions, and
each emulated tensor-core primitive of csrc/tc_sm80.cuh (ldmatrix, mma.sync,
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
    lib = gxx("k2_matmul", _emulated((_build.CSRC / "matmul.cu").read_text()))
    fn = lib.repro_matmul
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.parametrize("m,k,n", [(37, 100, 75), (130, 20, 129), (4, 64, 200),
                                   (5, 0, 3)])
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_matmul_source_matches_plain(k2, m, k, n, dtype, out_dtype):
    """K2's masked ragged edges, in every dtype pair: fp32 sums in another
    order (1e-4); a bf16 output may round one ulp apart (2**-8 relative)."""
    g = torch.Generator().manual_seed(m * 1000 + n)
    a = torch.randn((m, k), generator=g).to(dtype)
    b = torch.randn((k, n), generator=g).to(dtype)
    c = torch.full((m, n), float("nan"), dtype=out_dtype)
    codes = {torch.float32: 0, torch.bfloat16: 1}
    assert k2(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
              codes[dtype], codes[out_dtype], None) == 0
    tol = 1e-4 if out_dtype == torch.float32 else 1e-2
    torch.testing.assert_close(c.float(), ref.matmul(a, b, out_dtype=out_dtype)
                               .float(), rtol=tol, atol=tol)


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


@pytest.fixture(scope="module")
def k3(gxx):
    lib = gxx("k3_flash", _emulated((_build.CSRC / "flash_attention.cu")
                                    .read_text()))
    fn = lib.repro_flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
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
    assert k3(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), code,
              bh, bkv, sq, sk, d, 1.0 / d ** 0.5, int(causal), q_offset,
              None) == 0
    want = ref.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    tol = K3_TOL[dtype]
    torch.testing.assert_close(o.float(), want.float(), rtol=tol, atol=tol)


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
