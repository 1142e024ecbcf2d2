"""The port's CUDA sources run on the CPU under an emulation of the CUDA
subset they use (tests/cuda_emu.h, compiled with the host's g++): K4's
generated programs against the torch Stage III, K2 against its plain
version.

This checks what the generated and hand-written C++ computes (index
arithmetic, barriers, block reductions, masking) without a card; it says
nothing of speed or of what nvcc accepts, which tests/test_torch_cuda.py
checks on the card.  Each block runs as 256 host threads, so the shapes are
small.
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
from repro_torch.core.dpia.types import Arr, Num
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
    """A CUDA source rewritten for tests/cuda_emu.h."""
    source = re.sub(r"#include <cuda_(runtime|bf16)\.h>\n", "", source)
    source = '#include "cuda_emu.h"\n' + source
    source = source.replace("extern __shared__ float smem[];",
                            "float* smem = g_smem;")
    source = re.sub(r"__shared__ float (\w+)\[", r"static float \1[", source)
    return re.sub(r"([\w<>, ]+?)<<<(dim3\([^)]*\)|\w+), (\w+), [^>]*?>>>"
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
    "naive_matmul": (lambda: B.naive_matmul(4, 3, 5), [(4, 3), (3, 5)]),
    "naive_asum": (lambda: B.naive_asum(16), [(16,)]),
}


def _run(lib, fn, args):
    """Launch every stage of a generated program on CPU buffers."""
    plan = fn.plan
    outs = [torch.zeros(s) for _, s in stage3_cuda.leaves(fn.out.t.d)]
    host = [torch.zeros(s) for _, d in plan.host
            for _, s in stage3_cuda.leaves(d)]
    scratch = torch.full((max(1, plan.scratch_bytes // 4),), float("nan"))
    ptrs = ([a.data_ptr() for a in args] + [t.data_ptr() for t in outs + host]
            + [scratch.data_ptr(), None])
    for st in plan.stages:
        launch = getattr(lib, f"launch_stage{st.index}")
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
