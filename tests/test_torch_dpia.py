"""The port's DPIA pipeline (repro_torch.core.dpia, repro_torch.compiler)
held against the reference's (repro.core.dpia, repro.compiler).

Every case is written once, as a function of a package's modules, and built
by both packages, so both translate the same term.  Stage II texts are
compared after normalising fresh-name suffixes (both packages draw names
from a global counter) by order of first appearance.  Values go through the
reference's jnp Stage III and the port's torch Stage III with inputs made
by numpy from a seed; rtol and atol 1e-4 as the reference's own tests use
(both sum fp32 terms, in other orders).
"""
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro import compiler as jcompiler
from repro.core.dpia import check as jcheck
from repro.core.dpia import hoist as jhoist
from repro.core.dpia import phrases as jP
from repro.core.dpia import pretty as jpretty
from repro.core.dpia import stage1 as jstage1
from repro.core.dpia import stage2 as jstage2
from repro.core.dpia import stage3_jnp
from repro.core.dpia import strategies as jstrategies
from repro.core.dpia import types as jT
from repro.kernels import dpia_blas as jblas
from repro_torch import compiler as tcompiler
from repro_torch.core.dpia import check as tcheck
from repro_torch.core.dpia import hoist as thoist
from repro_torch.core.dpia import interp as tinterp
from repro_torch.core.dpia import phrases as tP
from repro_torch.core.dpia import pretty as tpretty
from repro_torch.core.dpia import stage1 as tstage1
from repro_torch.core.dpia import stage2 as tstage2
from repro_torch.core.dpia import stage3_torch
from repro_torch.core.dpia import strategies as tstrategies
from repro_torch.core.dpia import types as tT
from repro_torch.kernels import dpia_blas as tblas

REF = types.SimpleNamespace(
    P=jP, T=jT, check=jcheck, hoist=jhoist, stage1=jstage1, stage2=jstage2,
    pretty=jpretty, strategies=jstrategies, blas=jblas)
PORT = types.SimpleNamespace(
    P=tP, T=tT, check=tcheck, hoist=thoist, stage1=tstage1, stage2=tstage2,
    pretty=tpretty, strategies=tstrategies, blas=tblas)
BOTH = pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])

TOL = 1e-4


def _np(x):
    if isinstance(x, tuple):
        return tuple(_np(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# types (test_dpia_core.py::TestTypes), in both packages
# ---------------------------------------------------------------------------

@BOTH
def test_types_shapes_and_passivity(pkg):
    P, T = pkg.P, pkg.T
    assert T.arr(4, 8) == T.Arr(4, T.Arr(8, T.Num()))
    assert T.is_passive(T.ExpT(T.Num()))
    assert not T.is_passive(T.AccT(T.Num()))
    assert not T.is_passive(T.CommT())
    assert T.is_passive(T.FnT(T.AccT(T.Num()), T.ExpT(T.Num())))
    assert not T.is_passive(T.FnT(T.ExpT(T.Num()), T.CommT()))
    assert T.is_passive(T.FnT(T.ExpT(T.Num()), T.CommT(), passive=True))
    xs = P.var_exp("xs", T.Arr(12, T.Num()))
    assert P.exp_data(P.Split(4, xs)) == T.Arr(3, T.Arr(4, T.Num()))
    assert P.exp_data(P.Join(P.Split(4, xs))) == T.Arr(12, T.Num())
    ys = P.var_exp("ys", T.Arr(12, T.Num()))
    assert P.exp_data(P.Zip(xs, ys)) == T.Arr(12, T.Pair(T.Num(), T.Num()))
    assert P.exp_data(P.AsVector(4, xs)) == T.Arr(3, T.Vec(4, "float32"))
    assert P.exp_data(P.AsScalar(P.AsVector(4, xs))) == T.Arr(12, T.Num())
    m = P.Map(lambda x: P.add(x, P.lit(1.0)), xs)
    assert P.exp_data(m) == T.Arr(12, T.Num())


def _zip_mismatch(P, T):
    return P.Zip(P.var_exp("xs", T.Arr(8, T.Num())),
                 P.var_exp("ys", T.Arr(4, T.Num())))


def _split_indivisible(P, T):
    return P.Split(4, P.var_exp("xs", T.Arr(10, T.Num())))


def _assign_mismatch(P, T):
    return P.Assign(P.var_acc("a", T.Arr(4, T.Num())),
                    P.var_exp("e", T.Arr(8, T.Num())))


def _asvector_indivisible(P, T):
    return P.AsVector(3, P.var_exp("xs", T.Arr(16, T.Num())))


@BOTH
@pytest.mark.parametrize("case", [_zip_mismatch, _split_indivisible,
                                  _assign_mismatch, _asvector_indivisible])
def test_type_errors_raised(pkg, case):
    with pytest.raises(pkg.P.DpiaTypeError) as err:
        pkg.P.type_of(case(pkg.P, pkg.T))
    # the same message in both packages
    other = PORT if pkg is REF else REF
    with pytest.raises(other.P.DpiaTypeError) as err2:
        other.P.type_of(case(other.P, other.T))
    assert str(err.value) == str(err2.value)


# ---------------------------------------------------------------------------
# SCIR race check (test_dpia_core.py::TestRaceFreedom)
# ---------------------------------------------------------------------------

def _racy_parfor(P, T):
    """Paper section 3.3: every iteration writes the same acceptor b."""
    b = P.var_acc("b", T.Num())
    es = P.var_exp("es", T.Arr(8, T.Num()))
    out = P.var_acc("out", T.Arr(8, T.Num()))
    return P.ParFor(8, T.Num(), out, lambda i, o: P.Assign(b, P.IdxE(es, i)))


def _racy_nested(P, T):
    out = P.var_acc("out", T.Arr(4, T.Arr(4, T.Num())))
    es = P.var_exp("es", T.Arr(4, T.Num()))
    return P.ParFor(4, T.Arr(4, T.Num()), out, lambda i, o: P.ParFor(
        4, T.Num(), o, lambda j, o2: P.Assign(P.IdxAcc(o, j),
                                              P.IdxE(es, i))))


def _race_free_parfor(P, T):
    es = P.var_exp("es", T.Arr(8, T.Num()))
    out = P.var_acc("out", T.Arr(8, T.Num()))
    return P.ParFor(8, T.Num(), out, lambda i, o: P.Assign(o, P.IdxE(es, i)))


def _sequential_for_may_share(P, T):
    v_acc, v_exp = P.var_acc("v", T.Num()), P.var_exp("v", T.Num())
    return P.For(4, lambda i: P.Assign(v_acc, P.add(v_exp, P.lit(1.0))))


def _nested_parfor_inner_acceptor(P, T):
    es = P.var_exp("es", T.Arr(4, T.Arr(4, T.Num())))
    out = P.var_acc("out", T.Arr(4, T.Arr(4, T.Num())))
    return P.ParFor(4, T.Arr(4, T.Num()), out, lambda i, o: P.ParFor(
        4, T.Num(), o, lambda j, o2: P.Assign(
            o2, P.IdxE(P.IdxE(es, i), j))))


def _full_translation(P, T, stage1, stage2):
    xs = P.var_exp("xs", T.Arr(16, T.Num()))
    e = P.Map(lambda x: P.mul(x, x), xs)
    return stage2.expand(stage1.translate(e, P.var_acc("o",
                                                       T.Arr(16, T.Num()))))


@BOTH
@pytest.mark.parametrize("case", [_racy_parfor, _racy_nested])
def test_racy_terms_rejected(pkg, case):
    with pytest.raises(pkg.check.RaceError):
        pkg.check.check_race_free(case(pkg.P, pkg.T))


@BOTH
@pytest.mark.parametrize("case", [_race_free_parfor, _sequential_for_may_share,
                                  _nested_parfor_inner_acceptor])
def test_race_free_terms_accepted(pkg, case):
    pkg.check.check_race_free(case(pkg.P, pkg.T))


@BOTH
def test_full_translation_is_race_free(pkg):
    pkg.check.check(_full_translation(pkg.P, pkg.T, pkg.stage1, pkg.stage2))


def test_program_check_rejects_racy_imperative_program():
    cmd = _racy_parfor(tP, tT)
    prog = tcompiler.Program.from_imperative(
        cmd, [tP.var_exp("es", tT.Arr(8, tT.Num()))],
        tP.var_acc("out", tT.Arr(8, tT.Num())))
    with pytest.raises(tcheck.RaceError):
        prog.check()


# ---------------------------------------------------------------------------
# Stage II text: every dpia_blas builder and the paper examples
# ---------------------------------------------------------------------------

def _dot_eq1(pkg, n=32):
    P, T = pkg.P, pkg.T
    xs, ys = P.var_exp("xs", T.Arr(n, T.Num())), P.var_exp("ys", T.Arr(n, T.Num()))
    return P.Reduce(lambda x, a: P.add(a, x), P.lit(0.0),
                    P.Map(lambda z: P.mul(P.Fst(z), P.Snd(z)),
                          P.Zip(xs, ys))), [xs, ys]


def _dot_eq2(pkg, n=32):
    P, T = pkg.P, pkg.T
    xs, ys = P.var_exp("xs", T.Arr(n, T.Num())), P.var_exp("ys", T.Arr(n, T.Num()))
    e = P.Reduce(
        lambda x, a: P.add(a, x), P.lit(0.0),
        P.Join(P.Map(
            lambda zs1: P.Map(
                lambda zs2: P.Reduce(
                    lambda z, a: P.add(P.mul(P.Fst(z), P.Snd(z)), a),
                    P.lit(0.0), zs2),
                P.Split(4, zs1), level=P.PAR),
            P.Split(8, P.Zip(xs, ys)), level=P.PAR)))
    return e, [xs, ys]


def _square_sum(pkg, n=16):
    P, T = pkg.P, pkg.T
    xs = P.var_exp("xs", T.Arr(n, T.Num()))
    return P.Reduce(lambda x, a: P.add(a, x), P.lit(0.0),
                    P.Map(lambda x: P.mul(x, x), xs)), [xs]


def _fused_square_sum(pkg):
    e, argv = _square_sum(pkg)
    return pkg.strategies.fuse_map_into_reduce(e), argv


def _gemv_spec(pkg, m=6, n=8):
    P, T = pkg.P, pkg.T
    A = P.var_exp("A", T.Arr(m, T.Arr(n, T.Num())))
    x = P.var_exp("x", T.Arr(n, T.Num()))
    return P.Map(lambda row: P.Reduce(
        lambda z, acc: P.add(acc, z), P.lit(0.0),
        P.Map(lambda p_: P.mul(P.Fst(p_), P.Snd(p_)), P.Zip(row, x))), A), [A, x]


def _pair_output(pkg, n=8):
    P, T = pkg.P, pkg.T
    xs = P.var_exp("xs", T.Arr(n, T.Num()))
    return P.PairE(P.FullReduce("add", xs), P.FullReduce("max", xs)), [xs]


def _transpose2(pkg):
    P, T = pkg.P, pkg.T
    A = P.var_exp("A", T.Arr(4, T.Arr(6, T.Num())))
    return P.Transpose(P.Transpose(A)), [A]


def _asvector_roundtrip(pkg):
    P, T = pkg.P, pkg.T
    xs = P.var_exp("xs", T.Arr(16, T.Num()))
    return P.AsScalar(P.AsVector(4, xs)), [xs]


def _vectorised_scal(pkg):
    P, T = pkg.P, pkg.T
    alpha = P.var_exp("alpha", T.Num())
    xs = P.var_exp("xs", T.Arr(256, T.Num()))
    e = P.AsScalar(P.Join(P.Map(
        lambda blk: P.mul(alpha, blk),
        P.Split(4, P.AsVector(8, xs)), level=P.GRID(0))))
    return e, [alpha, xs]


def _quickstart_dot(pkg, n=1024):
    """examples/quickstart.py: fuse, block for the grid, reduce each block."""
    e, argv = _dot_eq1(pkg, n)
    fused = pkg.strategies.fuse_map_into_reduce(e)
    return pkg.strategies.blocked_reduce(
        fused, 256, partial_level=pkg.P.GRID(0),
        combine=lambda x, a: pkg.P.add(a, x)), argv


BUILDERS = {
    "naive_scal": lambda pkg: pkg.blas.naive_scal(64),
    "strategy_scal": lambda pkg: pkg.blas.strategy_scal(64, block=16),
    "wholeblock_scal": lambda pkg: pkg.blas.wholeblock_scal(64),
    "naive_asum": lambda pkg: pkg.blas.naive_asum(64),
    "strategy_asum": lambda pkg: pkg.blas.strategy_asum(64, block=16),
    "naive_dot": lambda pkg: pkg.blas.naive_dot(64),
    "strategy_dot": lambda pkg: pkg.blas.strategy_dot(64, block=16),
    "naive_gemv": lambda pkg: pkg.blas.naive_gemv(8, 16),
    "strategy_gemv": lambda pkg: pkg.blas.strategy_gemv(8, 16, row_block=4),
    "naive_rmsnorm": lambda pkg: pkg.blas.naive_rmsnorm(8, 16),
    "strategy_rmsnorm": lambda pkg: pkg.blas.strategy_rmsnorm(8, 16,
                                                              row_block=4),
    "naive_softmax": lambda pkg: pkg.blas.naive_softmax(8, 16),
    "strategy_softmax": lambda pkg: pkg.blas.strategy_softmax(8, 16,
                                                              row_block=4),
    "naive_matmul": lambda pkg: pkg.blas.naive_matmul(8, 4, 6),
    "strategy_matmul": lambda pkg: pkg.blas.strategy_matmul(8, 4, 6, bm=4,
                                                            bk=2),
    "dot_eq1": _dot_eq1,
    "dot_eq2": _dot_eq2,
    "no_implicit_fusion": _square_sum,
    "fused_strategy": _fused_square_sum,
    "gemv_spec": _gemv_spec,
    "pair_output": _pair_output,
    "transpose_roundtrip": _transpose2,
    "asvector_roundtrip": _asvector_roundtrip,
    "vectorised_scal": _vectorised_scal,
    "quickstart_dot": _quickstart_dot,
}

_OBJ = re.compile(r"<[\w.]+\.(\w+) object at 0x[0-9a-f]+>")
_FRESH = re.compile(r"(?<![A-Za-z0-9_])([A-Za-z][A-Za-z0-9]*)_(\d+)(?![0-9])")


def normalise(text: str) -> str:
    """Fresh-name suffixes renumbered by order of first appearance; object
    reprs (the printer has no case for transpose) reduced to the class."""
    text = _OBJ.sub(r"<\1>", text)
    seen = {}

    def sub(m):
        key = m.group(0)
        if key not in seen:
            seen[key] = f"{m.group(1)}_{len(seen)}"
        return seen[key]
    return _FRESH.sub(sub, text)


def stage2_text(pkg, name):
    e, _ = BUILDERS[name](pkg)
    out = pkg.P.Var("out#", pkg.T.AccT(pkg.P.exp_data(e)))
    return normalise(pkg.pretty.show(pkg.stage2.expand(
        pkg.stage1.translate(e, out))))


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_stage2_text_equals_reference(name):
    assert stage2_text(PORT, name) == stage2_text(REF, name)


@pytest.mark.parametrize("name", ["strategy_asum", "strategy_matmul",
                                  "no_implicit_fusion"])
def test_hoisted_text_equals_reference(name):
    texts = []
    for pkg in (REF, PORT):
        e, _ = BUILDERS[name](pkg)
        out = pkg.P.Var("out#", pkg.T.AccT(pkg.P.exp_data(e)))
        cmd = pkg.stage2.expand(pkg.stage1.translate(e, out))
        texts.append(normalise(pkg.pretty.show(
            pkg.hoist.hoist(cmd, spaces=(pkg.P.HBM,)))))
    assert texts[0] == texts[1]


def test_no_implicit_fusion_materialises():
    """Paper section 2.2: reduce-of-map allocates the n.num intermediate."""
    e, _ = _square_sum(PORT)
    cmd = tstage1.translate(e, tP.var_acc("out", tT.Num()))
    assert isinstance(cmd, tP.New) and cmd.d == tT.Arr(16, tT.Num())


# ---------------------------------------------------------------------------
# Stage III values: the port's torch backend against the reference's jnp
# ---------------------------------------------------------------------------

def _inputs(argv, rng):
    out = []
    for v in argv:
        shape = tT.shape_of(v.t.d)
        out.append(np.float32(rng.randn()) if not shape
                   else rng.randn(*shape).astype(np.float32))
    return out


def _run_both(name, rng, builders=BUILDERS):
    je, jargv = builders[name](REF)
    te, targv = builders[name](PORT)
    vals = _inputs(targv, rng)
    want = jcompiler.Program(je, jargv).check().lower().compile("jnp")(
        *[jnp.asarray(v) for v in vals])
    got = tcompiler.Program(te, targv).check().lower().compile("torch")(
        *[torch.tensor(v) for v in vals])
    oracle = tinterp.interp(te, {v.name: torch.tensor(a)
                                 for v, a in zip(targv, vals)})
    return got, want, oracle


# _SIX_OPS (test_compiler.py:137) plus gemv, TestPallasBackend
# (test_dpia_backends.py:28) and the quickstart's rewritten dot
STAGE3_CASES = {
    "scal": lambda pkg: pkg.blas.strategy_scal(256, block=256),
    "asum": lambda pkg: pkg.blas.strategy_asum(256, block=256),
    "dot": lambda pkg: pkg.blas.strategy_dot(256, block=256),
    "matmul": lambda pkg: pkg.blas.strategy_matmul(32, 64, 16, bm=32, bk=64),
    "rmsnorm": lambda pkg: pkg.blas.strategy_rmsnorm(16, 64, row_block=8),
    "softmax": lambda pkg: pkg.blas.strategy_softmax(16, 64, row_block=8),
    "gemv": lambda pkg: pkg.blas.strategy_gemv(256, 32),
    "grid_dot": lambda pkg: pkg.blas.strategy_dot(1024, block=128),
    "grid_scal": lambda pkg: pkg.blas.strategy_scal(512, block=64),
    "grid_matmul": lambda pkg: pkg.blas.strategy_matmul(64, 64, 32, bm=16,
                                                        bk=32),
    "grid_rmsnorm": lambda pkg: pkg.blas.strategy_rmsnorm(16, 64,
                                                          row_block=4),
    # the generated CUDA's ragged and shrunk dotBlock tilings
    # (test_torch_emulated.py) are held to this Stage III
    "matmul_ragged": lambda pkg: pkg.blas.strategy_matmul(130, 74, 150,
                                                          bm=130, bk=37),
    "matmul_shrunk": lambda pkg: pkg.blas.strategy_matmul(8, 100, 6000,
                                                          bm=8, bk=100),
    "vectorised_scal": _vectorised_scal,
    "quickstart_dot": _quickstart_dot,
    "pair_output": _pair_output,
    "transpose_roundtrip": _transpose2,
    "dot_eq2": _dot_eq2,
    "gemv_spec": _gemv_spec,
}


@pytest.mark.parametrize("name", sorted(STAGE3_CASES))
def test_stage3_torch_matches_jnp_backend(rng, name):
    got, want, oracle = _run_both(name, rng, STAGE3_CASES)
    _close(got, want)
    _close(got, oracle)


def _paper_64_example(pkg):
    """Section 6.4: a parfor whose body allocates an HBM temporary."""
    P, T = pkg.P, pkg.T
    xs = P.var_exp("xs", T.Arr(64, T.Num()))
    out = P.var_acc("out", T.Arr(16, T.Num()))
    return P.ParFor(16, T.Num(), out, lambda i, o: P.New(
        T.Arr(4, T.Num()),
        lambda tmp: P.SeqC(
            P.For(4, lambda j: P.Assign(
                P.IdxAcc(P.AccPart(tmp), j),
                P.IdxE(P.IdxE(P.Split(4, xs), i), j))),
            P.Assign(o, P.FullReduce("add", P.ExpPart(tmp)))),
        space=P.HBM))


def test_hoist_paper_example_matches_reference(rng):
    """Hoisting multiplies extents, preserves semantics, and the port's
    executor agrees with the reference's on the hoisted command."""
    a = rng.randn(64).astype(np.float32)
    want = stage3_jnp.exec_comm(jhoist.hoist(_paper_64_example(REF)),
                                {"xs": jnp.asarray(a)},
                                {"out": jnp.zeros(16)})["out"]
    prog = _paper_64_example(PORT)
    hoisted = thoist.hoist(prog)
    assert isinstance(hoisted, tP.New)
    assert hoisted.d == tT.Arr(16, tT.Arr(4, tT.Num()))
    for cmd in (prog, hoisted):
        store = stage3_torch.exec_comm(cmd, {"xs": torch.tensor(a)},
                                       {"out": torch.zeros(16)})
        _close(store["out"], want, 1e-5)
    _close(store["out"], a.reshape(16, 4).sum(1), 1e-5)


def test_reg_news_not_hoisted():
    out = tP.var_acc("out", tT.Arr(8, tT.Num()))
    xs = tP.var_exp("xs", tT.Arr(8, tT.Num()))
    prog = tP.ParFor(8, tT.Num(), out, lambda i, o: tP.New(
        tT.Num(), lambda v: tP.SeqC(
            tP.Assign(tP.AccPart(v), tP.IdxE(xs, i)),
            tP.Assign(o, tP.ExpPart(v))), space=tP.REG))
    assert thoist.hoist(prog) is prog


def test_program_lower_with_rewrite_matches_spec(rng):
    """Program.lower(rewrite): the quickstart's strategy, derived from the
    spec by rewriting, computes the spec's value."""
    spec, argv = _dot_eq1(PORT, 1024)

    def strategy(e):
        fused = tstrategies.fuse_map_into_reduce(e)
        return tstrategies.blocked_reduce(fused, 256,
                                          partial_level=tP.GRID(0),
                                          combine=lambda x, a: tP.add(a, x))
    prog = tcompiler.Program(spec, argv, name="dot").lower(strategy)
    assert prog.expr is not spec
    x, y = (torch.tensor(rng.randn(1024), dtype=torch.float32)
            for _ in range(2))
    for backend in ("torch", "dpia-torch", "cuda", "dpia-cuda"):
        _close(prog.check().compile(backend)(x, y), (x * y).sum())
    assert "parfor[grid(0)] 4" in prog.show()


def test_unknown_backend_names_the_registered_ones():
    assert tcompiler.backend_names() == ("cuda", "shardmap", "torch")
    with pytest.raises(ValueError, match="registered backends"):
        tcompiler.get_backend("pallas")


# ---------------------------------------------------------------------------
# random terms (test_dpia_translation.py:152-197) through the port
# ---------------------------------------------------------------------------

def _scalar_fn(P, which):
    return {
        0: lambda x: P.add(x, P.lit(1.0)),
        1: lambda x: P.mul(x, P.lit(2.0)),
        2: lambda x: P.UnOp("neg", x),
        3: lambda x: P.mul(x, x),
        4: lambda x: P.UnOp("abs", x),
    }[which]


@st.composite
def dpia_exprs(draw):
    """Random (expr, argv, args) triples built with the port's phrases."""
    P, T = tP, tT
    n = draw(st.sampled_from([4, 6, 8, 12]))
    depth = draw(st.integers(0, 3))
    rng = np.random.RandomState(draw(st.integers(0, 2 ** 16)))
    xs = P.var_exp("xs", T.Arr(n, T.Num()))
    args = (torch.tensor(rng.randn(n), dtype=torch.float32),)
    e = xs
    for _ in range(depth):
        kind = draw(st.integers(0, 4))
        if kind == 0:
            e = P.Map(_scalar_fn(P, draw(st.integers(0, 4))), e, level=P.PAR)
        elif kind == 1:
            divisors = [d for d in (2, 3, 4) if n % d == 0]
            if not divisors:
                continue
            d_ = draw(st.sampled_from(divisors))
            which = draw(st.integers(0, 4))  # drawn EAGERLY: binders are pure
            e = P.Join(P.Map(
                lambda blk, w=which: P.Map(_scalar_fn(P, w), blk,
                                           level=P.SEQ),
                P.Split(d_, e), level=P.PAR))
        elif kind == 2:
            half = P.Map(lambda x: P.mul(x, P.lit(0.5)), e, level=P.SEQ)
            e = P.Map(lambda z: P.add(P.Fst(z), P.Snd(z)), P.Zip(e, half))
        elif kind == 3:
            divisors = [d for d in (2, 4) if n % d == 0]
            if divisors:
                e = P.AsScalar(P.AsVector(draw(st.sampled_from(divisors)), e))
        else:
            e = P.Map(_scalar_fn(P, draw(st.integers(0, 4))), e, level=P.SEQ)
    if draw(st.booleans()):
        e = P.Reduce(lambda x, a: P.add(a, x), P.lit(0.0), e)
    return e, [xs], args


@settings(max_examples=25, deadline=None)
@given(dpia_exprs())
def test_random_terms_stage3_torch_matches_interp(triple):
    e, argv, args = triple
    got = stage3_torch.compile_expr(e, argv)(*args)
    want = tinterp.interp(e, {v.name: a for v, a in zip(argv, args)})
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-3, atol=1e-5)
