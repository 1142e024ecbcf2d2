"""K4, the DPIA CUDA generator (repro_torch.core.dpia.stage3_cuda), on the
CPU: code generation needs no nvcc and no card.

The plan of every dpia_blas strategy has one stage per top-level grid
parfor nest, with its extents as the CUDA grid: the same kernels, on the
same grids, as the reference's Pallas generator launches (counted by
wrapping its ``_run_kernel_stage``).  The source is deterministic; what
the generator does not emit raises; and on CPU tensors the "cuda" backend
computes the torch Stage III's result and launches nothing.
tests/test_torch_cuda.py runs the generated kernels on the card.
"""
import numpy as np
import pytest
import torch

from repro import compiler as jcompiler
from repro.core.dpia import stage3_pallas
from repro.kernels import dpia_blas as jblas
from repro_torch.compiler import Program
from repro_torch.core.dpia import hoist
from repro_torch.core.dpia import phrases as P
from repro_torch.core.dpia import stage3_cuda
from repro_torch.core.dpia.types import AccT, Arr, ExpT, Idx, Num, VarT
from repro_torch.kernels import _build
from repro_torch.kernels import dpia_blas as tblas

STRATEGIES = {
    "scal": lambda B: B.strategy_scal(4096, block=512),
    "asum": lambda B: B.strategy_asum(4096, block=512),
    "dot": lambda B: B.strategy_dot(4096, block=512),
    "gemv": lambda B: B.strategy_gemv(256, 64),
    "rmsnorm": lambda B: B.strategy_rmsnorm(32, 64, row_block=8),
    "softmax": lambda B: B.strategy_softmax(32, 48, row_block=8),
    "matmul": lambda B: B.strategy_matmul(64, 32, 48, bm=16, bk=8),
}



def _shape(d):
    """Leading array shape of a data type of either package."""
    out = []
    while type(d).__name__ == "Arr":
        out.append(d.n)
        d = d.elem
    return tuple(out)


def grid_nests(cmd):
    """Extents of the top-level grid parfor nests of a hoisted command."""
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


def _pallas_grids(name, rng, monkeypatch):
    """The grids the reference's Pallas generator launches (interpret)."""
    grids = []
    real = stage3_pallas._run_kernel_stage

    def counting(pf, env, store, interpret):
        grids.append(tuple(stage3_pallas._collect_grid(pf)[0]))
        return real(pf, env, store, interpret)

    monkeypatch.setattr(stage3_pallas, "_run_kernel_stage", counting)
    expr, argv = STRATEGIES[name](jblas)
    fn = jcompiler.Program(expr, argv).check().lower().compile(
        "pallas", jit=False, interpret=True)
    fn(*[np.asarray(a) for a in _inputs(argv, rng)])
    return grids


def _inputs(argv, rng):
    return [np.float32(rng.randn()) if not _shape(v.t.d)
            else rng.randn(*_shape(v.t.d)).astype(np.float32) for v in argv]


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_plan_has_one_grid_stage_per_grid_parfor(rng, monkeypatch, name):
    prog = Program.from_builder(lambda: STRATEGIES[name](tblas), name=name)
    fn = prog.check().lower().compile("cuda")
    want = grid_nests(hoist.hoist(prog.imperative, spaces=(P.HBM,)))
    grid_stages = [s for s in fn.stages if s.kind == "grid"]
    assert [s.grid for s in grid_stages] == want
    assert want == _pallas_grids(name, rng, monkeypatch)
    # the rest are single blocks: the strategy's sequential combine
    assert all(s.grid == (1,) for s in fn.stages if s.kind == "single")
    assert len(fn.stages) == len(want) + (name in ("asum", "dot"))
    assert all(s.threads == stage3_cuda.THREADS for s in fn.stages)


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_source_is_deterministic_with_one_kernel_per_stage(name):
    fns = [Program.from_builder(lambda: STRATEGIES[name](tblas), name=name)
           .check().lower().compile("cuda") for _ in range(2)]
    assert fns[0].source == fns[1].source
    assert _build.generated_target(name, fns[0].source) == \
        _build.generated_target(name, fns[1].source)
    src = fns[0].source
    assert src.count("__global__") == len(fns[0].stages)
    assert src.count('extern "C" int launch_stage') == len(fns[0].stages)
    for st in fns[0].stages:
        gx, gy, gz = (list(st.grid) + [1, 1])[:3]
        assert f"dim3({gx}, {gy}, {gz})" in src


def test_generated_target_lives_under_build_dpia():
    t = _build.generated_target("scal_64", "// text")
    assert t.parent == _build.BUILD_DIR / "dpia" and t.suffix == ".so"
    assert t.name.startswith("scal_64-")
    assert t != _build.generated_target("scal_64", "// other text")


def test_large_accumulator_goes_to_global_scratch():
    """strategy_matmul keeps a bm x n fp32 accumulator per block: at
    qwen3-4b's (1024, 2560, 2560) it fits no shared memory."""
    fn = Program.from_builder(
        lambda: tblas.strategy_matmul(1024, 2560, 2560), name="mm"
    ).check().lower().compile("cuda")
    (st,) = fn.stages
    assert st.grid == (8,)
    assert st.smem_bytes <= stage3_cuda.SMEM_BUDGET
    # the accumulator and the dotBlock result, 128 x 2560 floats each
    assert st.scratch_bytes_per_block == 2 * 128 * 2560 * 4
    assert fn.plan.scratch_bytes == 8 * 2 * 128 * 2560 * 4


def test_mesh_levels_raise():
    xs = P.var_exp("xs", Arr(64, Num()))
    e = P.Join(P.Map(lambda blk: P.mul(blk, blk), P.Split(8, xs),
                     level=P.MESH("data")))
    with pytest.raises(NotImplementedError, match="MESH"):
        Program(e, [xs]).check().lower().compile("cuda")


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "int32"])
def test_non_f32_types_raise(dtype):
    xs = P.var_exp("xs", Arr(64, Num(dtype)))
    e = P.Map(lambda x: P.mul(x, x), xs)
    with pytest.raises(NotImplementedError, match="float32"):
        Program(e, [xs]).check().lower().compile("cuda")


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_cpu_tensors_run_the_torch_stage3_and_launch_nothing(rng, name):
    prog = Program.from_builder(lambda: STRATEGIES[name](tblas), name=name)
    fn = prog.check().lower().compile("cuda")
    args = [torch.tensor(a) for a in _inputs(prog.arg_vars, rng)]
    stage3_cuda.launches = 0
    got = fn(*args)
    want = prog.compile("torch")(*args)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert fn.launches == 0 and stage3_cuda.launches == 0


def test_non_cpu_tensors_without_a_card_raise():
    fn = Program.from_builder(lambda: tblas.strategy_dot(64, 16)
                              ).check().lower().compile("cuda")
    x = torch.empty(64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fn(x, x)
    assert fn.launches == 0


def test_compiled_kernel_exposes_plan_and_source():
    fn = Program.from_builder(lambda: tblas.strategy_asum(1 << 12, 512),
                              name="asum").check().lower().compile(
        "dpia-cuda")
    assert fn.backend == "cuda"
    assert fn.plan.grids == [(8,), (1,)]
    assert [h for h in fn.plan.host] and fn.plan.host[0][1] == Arr(8, Num())
    assert "dpia_block_sum" in fn.source
    assert fn.launches == 0
