"""K4's generated programs on the CPU under tests/cuda_emu.h (the CUDA
subset they use, compiled with the host's g++), against the torch Stage
III: the op table's strategies, a hoisted temporary and a self-reading
assignment, thread-0 / block-wide statements in turn, and every distinct
(derivation, grid) of the tuner's spaces.

This checks what the generated C++ computes (index arithmetic, barriers,
block reductions, masking) without a card; it says nothing of speed or of
what nvcc accepts, which tests/test_torch_cuda.py checks on the card.
"""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from _emulation import HERE, _emulated, gxx  # noqa: F401
from repro_torch.compiler import Program
from repro_torch.core.dpia import phrases as P
from repro_torch.core.dpia import stage3_cuda
from repro_torch.core.dpia.types import Arr, Idx, Num
from repro_torch.kernels import dpia_blas as B

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
