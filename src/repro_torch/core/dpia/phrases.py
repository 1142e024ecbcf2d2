"""DPIA phrase AST (paper Fig. 4) with HOAS binders.

Functions inside phrases (the argument of ``map``, loop bodies, ``new``
scopes) are represented as Python callables receiving ``Var`` nodes — higher
order abstract syntax.  Beta reduction (all over Stage II) is function
application; printing / checking instantiate binders with fresh variables.

The strategy annotations of the paper's section 6 appear as ``level`` tags on
``map`` / ``reduce`` / ``parfor`` (OpenCL's workgroup/local/seq hierarchy,
re-based in the reference for TPU: mesh axis / grid dim / whole-block lanes /
sequential; the port's CUDA generator reads grid as a CUDA grid) and as
``space`` tags (toGlobal/toLocal/toPrivate -> HBM/VMEM/REG).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Optional, Union

from .types import (
    AccT, Arr, CommT, DataType, ExpT, FnT, Idx, Num, Pair, PhraseType, Vec,
    VarT, data_eq, dtype_of, is_numeric, promote_dtype, scalar_of, shape_of,
    show_data,
)

_counter = itertools.count()


def fresh(prefix: str = "x") -> str:
    return f"{prefix}_{next(_counter)}"


# ---------------------------------------------------------------------------
# Strategy levels (the paper's parallelism hierarchy, TPU re-based)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Par:
    """Where a map/reduce/parfor runs.

    kind: 'seq'   — sequential loop (paper: mapSeq / for)
          'par'   — unassigned parallel (paper: plain map / parfor)
          'grid'  — Pallas grid dimension ``axis`` (paper: mapWorkgroup/Local)
          'lanes' — whole-block VPU op (paper: asVector-ised map)
          'mesh'  — shard_map over mesh axis ``axis`` (our multi-device level)
    """
    kind: str
    axis: Union[int, str, None] = None

    def __repr__(self) -> str:
        return self.kind if self.axis is None else f"{self.kind}({self.axis})"


SEQ = Par("seq")
PAR = Par("par")
LANES = Par("lanes")


def GRID(axis: int = 0) -> Par:
    return Par("grid", axis)


def MESH(axis: str) -> Par:
    return Par("mesh", axis)


# Memory spaces (paper: global/local/private -> TPU: HBM/VMEM/registers)
HBM, VMEM, REG = "hbm", "vmem", "reg"


# ---------------------------------------------------------------------------
# AST nodes
# ---------------------------------------------------------------------------

class Phrase:
    def __repr__(self) -> str:  # pragma: no cover
        from .pretty import show
        try:
            return show(self)
        except Exception:
            return object.__repr__(self)


@dataclass(frozen=True, repr=False)
class Var(Phrase):
    name: str
    t: PhraseType


# -- functional expressions (Fig. 4a) ---------------------------------------

@dataclass(frozen=True, repr=False)
class Lit(Phrase):
    value: float
    d: DataType = Num("float32")


@dataclass(frozen=True, repr=False)
class UnOp(Phrase):
    op: str  # 'neg' | 'exp' | 'rsqrt' | 'abs' | 'log' | 'tanh' | 'sigmoid'
    e: Phrase


@dataclass(frozen=True, repr=False)
class BinOp(Phrase):
    op: str  # 'add' | 'sub' | 'mul' | 'div' | 'max' | 'min'
    a: Phrase
    b: Phrase


@dataclass(frozen=True, repr=False)
class Map(Phrase):
    f: Callable[[Phrase], Phrase]
    e: Phrase
    level: Par = PAR
    space: Optional[str] = None  # to{HBM,VMEM,REG} wrapper on the output


@dataclass(frozen=True, repr=False)
class Reduce(Phrase):
    f: Callable[[Phrase, Phrase], Phrase]  # (x, acc) -> acc'
    init: Phrase
    e: Phrase
    level: Par = SEQ


@dataclass(frozen=True, repr=False)
class Zip(Phrase):
    a: Phrase
    b: Phrase


@dataclass(frozen=True, repr=False)
class Split(Phrase):
    n: int  # chunk size; exp[(m*n).d] -> exp[m.n.d]
    e: Phrase


@dataclass(frozen=True, repr=False)
class Join(Phrase):
    e: Phrase  # exp[n.m.d] -> exp[(n*m).d]


@dataclass(frozen=True, repr=False)
class PairE(Phrase):
    a: Phrase
    b: Phrase


@dataclass(frozen=True, repr=False)
class Fst(Phrase):
    e: Phrase


@dataclass(frozen=True, repr=False)
class Snd(Phrase):
    e: Phrase


@dataclass(frozen=True, repr=False)
class IdxE(Phrase):
    e: Phrase  # exp[n.d]
    i: Phrase  # exp[idx(n)]


@dataclass(frozen=True, repr=False)
class AsVector(Phrase):
    w: int
    e: Phrase  # exp[(m*w).num] -> exp[m.num<w>]


@dataclass(frozen=True, repr=False)
class AsScalar(Phrase):
    e: Phrase  # exp[m.num<w>] -> exp[(m*w).num]


@dataclass(frozen=True, repr=False)
class Transpose(Phrase):
    e: Phrase  # exp[n.m.d] -> exp[m.n.d]


@dataclass(frozen=True, repr=False)
class DotBlock(Phrase):
    """MXU leaf contraction (TPU adaptation; DESIGN.md section 2).

    (k,)x(k,) -> num | (n,k)x(k,) -> (n,) | (n,k)x(k,m) -> (n,m).
    """
    a: Phrase
    b: Phrase
    acc_dtype: str = "float32"


@dataclass(frozen=True, repr=False)
class FullReduce(Phrase):
    """Whole-block VPU reduction: exp[n....num] -> exp[num]."""
    op: str  # 'add' | 'max'
    e: Phrase


@dataclass(frozen=True, repr=False)
class ToMem(Phrase):
    """Paper section 6.2 to{Global,Local,Private}: semantically the identity;
    steers where the translation materialises the wrapped value."""
    space: str
    e: Phrase


# -- imperative phrases (Fig. 4b) --------------------------------------------

@dataclass(frozen=True, repr=False)
class Skip(Phrase):
    pass


@dataclass(frozen=True, repr=False)
class SeqC(Phrase):
    c1: Phrase
    c2: Phrase


@dataclass(frozen=True, repr=False)
class Assign(Phrase):
    a: Phrase  # acc[d]
    e: Phrase  # exp[d]


@dataclass(frozen=True, repr=False)
class New(Phrase):
    d: DataType
    f: Callable[[Phrase], Phrase]  # var[d] -> comm
    space: str = HBM


@dataclass(frozen=True, repr=False)
class For(Phrase):
    n: int
    f: Callable[[Phrase], Phrase]  # exp[idx(n)] -> comm
    unroll: bool = False


@dataclass(frozen=True, repr=False)
class ParFor(Phrase):
    n: int
    d: DataType
    a: Phrase  # acc[n.d]
    f: Callable[[Phrase, Phrase], Phrase]  # (exp[idx(n)], acc[d]) ->p comm
    level: Par = PAR


# variable projections: var[d] = acc[d] x exp[d]
@dataclass(frozen=True, repr=False)
class AccPart(Phrase):
    v: Phrase


@dataclass(frozen=True, repr=False)
class ExpPart(Phrase):
    v: Phrase


@dataclass(frozen=True, repr=False)
class VView(Phrase):
    """A virtual ``var[d]`` built from an (acceptor, expression) pair.

    Introduced by allocation hoisting (paper section 6.4): the hoisted loop body
    receives a view of the enlarged outer buffer in place of its own ``new``."""
    acc: Phrase  # acc[d]
    exp: Phrase  # exp[d]


# acceptor-side data layout combinators (Fig. 4b)
@dataclass(frozen=True, repr=False)
class IdxAcc(Phrase):
    a: Phrase  # acc[n.d]
    i: Phrase  # exp[idx(n)]


@dataclass(frozen=True, repr=False)
class SplitAcc(Phrase):
    n: int
    a: Phrase  # acc[m.n.d] -> acc[(m*n).d]


@dataclass(frozen=True, repr=False)
class JoinAcc(Phrase):
    m: int
    a: Phrase  # acc[(n*m).d] -> acc[n.m.d]


@dataclass(frozen=True, repr=False)
class PairAcc1(Phrase):
    a: Phrase  # acc[d1 x d2] -> acc[d1]


@dataclass(frozen=True, repr=False)
class PairAcc2(Phrase):
    a: Phrase


@dataclass(frozen=True, repr=False)
class ZipAcc1(Phrase):
    a: Phrase  # acc[n.(d1 x d2)] -> acc[n.d1]


@dataclass(frozen=True, repr=False)
class ZipAcc2(Phrase):
    a: Phrase


@dataclass(frozen=True, repr=False)
class TransposeAcc(Phrase):
    a: Phrase  # acc[m.n.d] -> acc[n.m.d]


@dataclass(frozen=True, repr=False)
class AsScalarAcc(Phrase):
    a: Phrase  # acc[m.num<w>] -> acc[(m*w).num]


@dataclass(frozen=True, repr=False)
class AsVectorAcc(Phrase):
    w: int
    a: Phrase  # acc[(m*w).num] -> acc[m.num<w>]


# intermediate imperative combinators (Fig. 4c)
@dataclass(frozen=True, repr=False)
class MapI(Phrase):
    n: int
    d1: DataType
    d2: DataType
    f: Callable[[Phrase, Phrase], Phrase]  # (exp[d1], acc[d2]) ->p comm
    e: Phrase  # exp[n.d1]
    a: Phrase  # acc[n.d2]
    level: Par = PAR


@dataclass(frozen=True, repr=False)
class ReduceI(Phrase):
    n: int
    d1: DataType
    d2: DataType
    f: Callable[[Phrase, Phrase, Phrase], Phrase]  # (exp[d1],exp[d2],acc[d2])->comm
    init: Phrase  # exp[d2]
    e: Phrase  # exp[n.d1]
    k: Callable[[Phrase], Phrase]  # exp[d2] -> comm


# ---------------------------------------------------------------------------
# Type inference (the typing rules of Fig. 3 + primitive signatures of Fig. 4,
# with sizes concrete).  Raises DpiaTypeError on ill-typed phrases.
# ---------------------------------------------------------------------------

class DpiaTypeError(TypeError):
    pass


def _expect_exp(p: Phrase, what: str) -> DataType:
    t = type_of(p)
    if not isinstance(t, ExpT):
        raise DpiaTypeError(f"{what}: expected an expression, got {t}")
    return t.d


def _expect_acc(p: Phrase, what: str) -> DataType:
    t = type_of(p)
    if not isinstance(t, AccT):
        raise DpiaTypeError(f"{what}: expected an acceptor, got {t}")
    return t.d


def _expect_arr(d: DataType, what: str) -> Arr:
    if not isinstance(d, Arr):
        raise DpiaTypeError(f"{what}: expected an array, got {show_data(d)}")
    return d


def _elementwise(op: str, da: DataType, db: DataType) -> DataType:
    """BinOp typing: same-shape numeric, or scalar broadcast against array/vec.

    The paper types (+,*,...) at num only; the TPU adaptation lifts them
    pointwise to whole blocks (VPU ops)."""
    if not (is_numeric(da) and is_numeric(db)):
        raise DpiaTypeError(f"{op}: non-numeric operands "
                            f"{show_data(da)}, {show_data(db)}")
    if isinstance(da, (Num, Idx)) and not isinstance(db, (Num, Idx)):
        return db
    if isinstance(db, (Num, Idx)) and not isinstance(da, (Num, Idx)):
        return da
    if shape_of(da) != shape_of(db):
        raise DpiaTypeError(f"{op}: shape mismatch "
                            f"{show_data(da)} vs {show_data(db)}")
    if isinstance(da, Idx) and isinstance(db, Idx):
        return Num("int32")
    return da


def _proj_type(d: DataType, which: int) -> DataType:
    """fst/snd at pairs, lifted pointwise through arrays (struct-of-arrays
    makes the lifted projection a no-op re-view; TPU adaptation)."""
    if isinstance(d, Pair):
        return d.fst if which == 0 else d.snd
    if isinstance(d, Arr):
        return Arr(d.n, _proj_type(d.elem, which))
    raise DpiaTypeError(f"fst/snd: not (an array of) pairs: {show_data(d)}")


def type_of(p: Phrase) -> PhraseType:  # noqa: C901 - structural dispatch
    if isinstance(p, Var):
        return p.t
    if isinstance(p, Lit):
        return ExpT(p.d)
    if isinstance(p, UnOp):
        d = _expect_exp(p.e, p.op)
        if not is_numeric(d):
            raise DpiaTypeError(f"{p.op}: non-numeric operand {show_data(d)}")
        return ExpT(d)
    if isinstance(p, BinOp):
        da = _expect_exp(p.a, p.op)
        db = _expect_exp(p.b, p.op)
        return ExpT(_elementwise(p.op, da, db))
    if isinstance(p, Map):
        d = _expect_exp(p.e, "map")
        a = _expect_arr(d, "map input")
        x = Var(fresh("x"), ExpT(a.elem))
        d2 = _expect_exp(p.f(x), "map body")
        return ExpT(Arr(a.n, d2))
    if isinstance(p, Reduce):
        d = _expect_exp(p.e, "reduce")
        a = _expect_arr(d, "reduce input")
        d2 = _expect_exp(p.init, "reduce init")
        x = Var(fresh("x"), ExpT(a.elem))
        acc = Var(fresh("acc"), ExpT(d2))
        d2b = _expect_exp(p.f(x, acc), "reduce body")
        if not data_eq(d2, d2b):
            raise DpiaTypeError(
                f"reduce: accumulator {show_data(d2)} vs body {show_data(d2b)}")
        return ExpT(d2)
    if isinstance(p, Zip):
        da = _expect_arr(_expect_exp(p.a, "zip"), "zip lhs")
        db = _expect_arr(_expect_exp(p.b, "zip"), "zip rhs")
        if da.n != db.n:
            raise DpiaTypeError(f"zip: lengths {da.n} vs {db.n}")
        return ExpT(Arr(da.n, Pair(da.elem, db.elem)))
    if isinstance(p, Split):
        d = _expect_arr(_expect_exp(p.e, "split"), "split input")
        if d.n % p.n != 0:
            raise DpiaTypeError(f"split: {d.n} not divisible by chunk {p.n}")
        return ExpT(Arr(d.n // p.n, Arr(p.n, d.elem)))
    if isinstance(p, Join):
        d = _expect_arr(_expect_exp(p.e, "join"), "join input")
        inner = _expect_arr(d.elem, "join inner")
        return ExpT(Arr(d.n * inner.n, inner.elem))
    if isinstance(p, PairE):
        return ExpT(Pair(_expect_exp(p.a, "pair"), _expect_exp(p.b, "pair")))
    if isinstance(p, Fst):
        return ExpT(_proj_type(_expect_exp(p.e, "fst"), 0))
    if isinstance(p, Snd):
        return ExpT(_proj_type(_expect_exp(p.e, "snd"), 1))
    if isinstance(p, IdxE):
        d = _expect_arr(_expect_exp(p.e, "idx"), "idx input")
        di = _expect_exp(p.i, "idx index")
        if not isinstance(di, (Idx, Num)):
            raise DpiaTypeError(f"idx: bad index type {show_data(di)}")
        return ExpT(d.elem)
    if isinstance(p, AsVector):
        d = _expect_arr(_expect_exp(p.e, "asVector"), "asVector input")
        if not isinstance(d.elem, Num):
            raise DpiaTypeError("asVector: element type must be num")
        if d.n % p.w != 0:
            raise DpiaTypeError(f"asVector: {d.n} not divisible by {p.w}")
        return ExpT(Arr(d.n // p.w, Vec(p.w, d.elem.dtype)))
    if isinstance(p, AsScalar):
        d = _expect_arr(_expect_exp(p.e, "asScalar"), "asScalar input")
        if not isinstance(d.elem, Vec):
            raise DpiaTypeError("asScalar: element type must be a vector")
        return ExpT(Arr(d.n * d.elem.n, Num(d.elem.dtype)))
    if isinstance(p, Transpose):
        d = _expect_arr(_expect_exp(p.e, "transpose"), "transpose input")
        inner = _expect_arr(d.elem, "transpose inner")
        return ExpT(Arr(inner.n, Arr(d.n, inner.elem)))
    if isinstance(p, DotBlock):
        da = _expect_exp(p.a, "dotBlock")
        db = _expect_exp(p.b, "dotBlock")
        sa, sb = shape_of(da), shape_of(db)
        out_dt = p.acc_dtype
        if len(sa) == 1 and len(sb) == 1 and sa == sb:
            return ExpT(Num(out_dt))
        if len(sa) == 2 and len(sb) == 1 and sa[1] == sb[0]:
            return ExpT(Arr(sa[0], Num(out_dt)))
        if len(sa) == 2 and len(sb) == 2 and sa[1] == sb[0]:
            return ExpT(Arr(sa[0], Arr(sb[1], Num(out_dt))))
        raise DpiaTypeError(f"dotBlock: bad shapes {sa} x {sb}")
    if isinstance(p, FullReduce):
        d = _expect_exp(p.e, "fullReduce")
        if not is_numeric(d) or not isinstance(d, (Arr, Vec)):
            raise DpiaTypeError(f"fullReduce: need numeric array, got {show_data(d)}")
        return ExpT(Num(dtype_of(d)))
    if isinstance(p, ToMem):
        return ExpT(_expect_exp(p.e, "toMem"))
    # imperative
    if isinstance(p, Skip):
        return CommT()
    if isinstance(p, SeqC):
        for c in (p.c1, p.c2):
            if not isinstance(type_of(c), CommT):
                raise DpiaTypeError("seq: operand not a command")
        return CommT()
    if isinstance(p, Assign):
        da = _expect_acc(p.a, "assign lhs")
        de = _expect_exp(p.e, "assign rhs")
        if shape_of(da) != shape_of(de):
            raise DpiaTypeError(
                f"assign: {show_data(da)} := {show_data(de)} shape mismatch")
        return CommT()
    if isinstance(p, New):
        v = Var(fresh("v"), VarT(p.d))
        if not isinstance(type_of(p.f(v)), CommT):
            raise DpiaTypeError("new: body not a command")
        return CommT()
    if isinstance(p, For):
        i = Var(fresh("i"), ExpT(Idx(p.n)))
        if not isinstance(type_of(p.f(i)), CommT):
            raise DpiaTypeError("for: body not a command")
        return CommT()
    if isinstance(p, ParFor):
        da = _expect_acc(p.a, "parfor out")
        arr_d = _expect_arr(da, "parfor out")
        if arr_d.n != p.n or not data_eq(arr_d.elem, p.d):
            raise DpiaTypeError(
                f"parfor: acceptor {show_data(da)} does not match "
                f"{p.n}.{show_data(p.d)}")
        i = Var(fresh("i"), ExpT(Idx(p.n)))
        o = Var(fresh("o"), AccT(p.d))
        if not isinstance(type_of(p.f(i, o)), CommT):
            raise DpiaTypeError("parfor: body not a command")
        return CommT()
    if isinstance(p, VView):
        da = _expect_acc(p.acc, "vview acc")
        de = _expect_exp(p.exp, "vview exp")
        if not data_eq(da, de):
            raise DpiaTypeError("vview: acc/exp type mismatch")
        return VarT(da)
    if isinstance(p, AccPart):
        if isinstance(p.v, VView):
            return type_of(p.v.acc)
        t = type_of(p.v)
        if not isinstance(t, VarT):
            raise DpiaTypeError(f"'.1' of non-variable {t}")
        return AccT(t.d)
    if isinstance(p, ExpPart):
        if isinstance(p.v, VView):
            return type_of(p.v.exp)
        t = type_of(p.v)
        if not isinstance(t, VarT):
            raise DpiaTypeError(f"'.2' of non-variable {t}")
        return ExpT(t.d)
    if isinstance(p, IdxAcc):
        d = _expect_arr(_expect_acc(p.a, "idxAcc"), "idxAcc input")
        return AccT(d.elem)
    if isinstance(p, SplitAcc):
        d = _expect_arr(_expect_acc(p.a, "splitAcc"), "splitAcc input")
        inner = _expect_arr(d.elem, "splitAcc inner")
        if inner.n != p.n:
            raise DpiaTypeError("splitAcc: chunk mismatch")
        return AccT(Arr(d.n * inner.n, inner.elem))
    if isinstance(p, JoinAcc):
        d = _expect_arr(_expect_acc(p.a, "joinAcc"), "joinAcc input")
        if d.n % p.m != 0:
            raise DpiaTypeError("joinAcc: not divisible")
        return AccT(Arr(d.n // p.m, Arr(p.m, d.elem)))
    if isinstance(p, PairAcc1):
        d = _expect_acc(p.a, "pairAcc1")
        if not isinstance(d, Pair):
            raise DpiaTypeError("pairAcc1: not a pair acceptor")
        return AccT(d.fst)
    if isinstance(p, PairAcc2):
        d = _expect_acc(p.a, "pairAcc2")
        if not isinstance(d, Pair):
            raise DpiaTypeError("pairAcc2: not a pair acceptor")
        return AccT(d.snd)
    if isinstance(p, ZipAcc1):
        d = _expect_arr(_expect_acc(p.a, "zipAcc1"), "zipAcc1 input")
        if not isinstance(d.elem, Pair):
            raise DpiaTypeError("zipAcc1: element not a pair")
        return AccT(Arr(d.n, d.elem.fst))
    if isinstance(p, ZipAcc2):
        d = _expect_arr(_expect_acc(p.a, "zipAcc2"), "zipAcc2 input")
        if not isinstance(d.elem, Pair):
            raise DpiaTypeError("zipAcc2: element not a pair")
        return AccT(Arr(d.n, d.elem.snd))
    if isinstance(p, TransposeAcc):
        d = _expect_arr(_expect_acc(p.a, "transposeAcc"), "transposeAcc input")
        inner = _expect_arr(d.elem, "transposeAcc inner")
        return AccT(Arr(inner.n, Arr(d.n, inner.elem)))
    if isinstance(p, AsScalarAcc):
        d = _expect_arr(_expect_acc(p.a, "asScalarAcc"), "asScalarAcc input")
        if not isinstance(d.elem, Vec):
            raise DpiaTypeError("asScalarAcc: element not a vector")
        return AccT(Arr(d.n * d.elem.n, Num(d.elem.dtype)))
    if isinstance(p, AsVectorAcc):
        d = _expect_arr(_expect_acc(p.a, "asVectorAcc"), "asVectorAcc input")
        if not isinstance(d.elem, Num) or d.n % p.w != 0:
            raise DpiaTypeError("asVectorAcc: bad input")
        return AccT(Arr(d.n // p.w, Vec(p.w, d.elem.dtype)))
    if isinstance(p, MapI):
        de = _expect_exp(p.e, "mapI input")
        da = _expect_acc(p.a, "mapI output")
        if not data_eq(de, Arr(p.n, p.d1)) or not data_eq(da, Arr(p.n, p.d2)):
            raise DpiaTypeError(
                f"mapI: {show_data(de)} -> {show_data(da)} vs declared "
                f"{p.n}.{show_data(p.d1)} -> {p.n}.{show_data(p.d2)}")
        x = Var(fresh("x"), ExpT(p.d1))
        o = Var(fresh("o"), AccT(p.d2))
        if not isinstance(type_of(p.f(x, o)), CommT):
            raise DpiaTypeError("mapI: body not a command")
        return CommT()
    if isinstance(p, ReduceI):
        de = _expect_exp(p.e, "reduceI input")
        if not data_eq(de, Arr(p.n, p.d1)):
            raise DpiaTypeError("reduceI: input type mismatch")
        di = _expect_exp(p.init, "reduceI init")
        if not data_eq(di, p.d2):
            raise DpiaTypeError("reduceI: init type mismatch")
        x = Var(fresh("x"), ExpT(p.d1))
        y = Var(fresh("y"), ExpT(p.d2))
        o = Var(fresh("o"), AccT(p.d2))
        if not isinstance(type_of(p.f(x, y, o)), CommT):
            raise DpiaTypeError("reduceI: body not a command")
        r = Var(fresh("r"), ExpT(p.d2))
        if not isinstance(type_of(p.k(r)), CommT):
            raise DpiaTypeError("reduceI: continuation not a command")
        return CommT()
    raise DpiaTypeError(f"unknown phrase {p!r}")


def exp_data(p: Phrase) -> DataType:
    return _expect_exp(p, "exp_data")


def acc_data(p: Phrase) -> DataType:
    return _expect_acc(p, "acc_data")


# ---------------------------------------------------------------------------
# Ergonomic constructors
# ---------------------------------------------------------------------------

def lit(v, dtype: str = "float32") -> Lit:
    return Lit(float(v), Num(dtype))


def var_exp(name: str, d: DataType) -> Var:
    return Var(name, ExpT(d))


def var_acc(name: str, d: DataType) -> Var:
    return Var(name, AccT(d))


def add(a, b):
    return BinOp("add", a, b)


def sub(a, b):
    return BinOp("sub", a, b)


def mul(a, b):
    return BinOp("mul", a, b)


def div(a, b):
    return BinOp("div", a, b)


def fmax(a, b):
    return BinOp("max", a, b)


def map_seq(f, e):
    return Map(f, e, level=SEQ)


def map_par(f, e):
    return Map(f, e, level=PAR)


def map_grid(axis: int):
    return lambda f, e: Map(f, e, level=GRID(axis))


def map_lanes(f, e):
    return Map(f, e, level=LANES)


def map_mesh(axis: str):
    return lambda f, e: Map(f, e, level=MESH(axis))


def reduce_seq(f, init, e):
    return Reduce(f, init, e, level=SEQ)


def to_vmem(e):
    return ToMem(VMEM, e)


def to_reg(e):
    return ToMem(REG, e)


def to_hbm(e):
    return ToMem(HBM, e)
