"""Pretty printer for DPIA phrases (instantiates HOAS binders with fresh vars)."""
from __future__ import annotations

from . import phrases as P
from .types import AccT, ExpT, Idx, VarT, show_data


def show(p: P.Phrase, indent: int = 0) -> str:  # noqa: C901
    pad = "  " * indent
    s = lambda q: show(q, indent)  # noqa: E731
    if isinstance(p, P.Var):
        return p.name
    if isinstance(p, P.Lit):
        return f"{p.value:g}"
    if isinstance(p, P.UnOp):
        return f"{p.op}({s(p.e)})"
    if isinstance(p, P.BinOp):
        sym = {"add": "+", "sub": "-", "mul": "*", "div": "/",
               "max": "max", "min": "min"}[p.op]
        return f"({s(p.a)} {sym} {s(p.b)})"
    if isinstance(p, P.Map):
        x = P.Var(P.fresh("x"), ExpT(_elem(p.e)))
        sp = f"@{p.space}" if p.space else ""
        return f"map[{p.level}]{sp} (λ{x.name}. {s(p.f(x))}) ({s(p.e)})"
    if isinstance(p, P.Reduce):
        x = P.Var(P.fresh("x"), ExpT(_elem(p.e)))
        acc = P.Var(P.fresh("a"), P.type_of(p.init))
        return (f"reduce[{p.level}] (λ{x.name} {acc.name}. "
                f"{s(p.f(x, acc))}) ({s(p.init)}) ({s(p.e)})")
    if isinstance(p, P.Zip):
        return f"zip ({s(p.a)}) ({s(p.b)})"
    if isinstance(p, P.Split):
        return f"split {p.n} ({s(p.e)})"
    if isinstance(p, P.Join):
        return f"join ({s(p.e)})"
    if isinstance(p, P.PairE):
        return f"pair ({s(p.a)}) ({s(p.b)})"
    if isinstance(p, P.Fst):
        return f"fst ({s(p.e)})"
    if isinstance(p, P.Snd):
        return f"snd ({s(p.e)})"
    if isinstance(p, P.IdxE):
        return f"idx ({s(p.e)}) ({s(p.i)})"
    if isinstance(p, P.AsVector):
        return f"asVector<{p.w}> ({s(p.e)})"
    if isinstance(p, P.AsScalar):
        return f"asScalar ({s(p.e)})"
    if isinstance(p, P.DotBlock):
        return f"dotBlock ({s(p.a)}) ({s(p.b)})"
    if isinstance(p, P.FullReduce):
        return f"fullReduce[{p.op}] ({s(p.e)})"
    if isinstance(p, P.ToMem):
        return f"to{p.space.upper()} ({s(p.e)})"
    if isinstance(p, P.Skip):
        return "skip"
    if isinstance(p, P.SeqC):
        return f"{show(p.c1, indent)};\n{pad}{show(p.c2, indent)}"
    if isinstance(p, P.Assign):
        return f"{s(p.a)} := {s(p.e)}"
    if isinstance(p, P.New):
        v = P.Var(P.fresh("v"), VarT(p.d))
        body = show(p.f(v), indent + 1)
        return (f"new[{p.space}] {show_data(p.d)} (λ{v.name}.\n"
                f"{pad}  {body})")
    if isinstance(p, P.For):
        i = P.Var(P.fresh("i"), ExpT(Idx(p.n)))
        body = show(p.f(i), indent + 1)
        return f"for {p.n} (λ{i.name}.\n{pad}  {body})"
    if isinstance(p, P.ParFor):
        i = P.Var(P.fresh("i"), ExpT(Idx(p.n)))
        o = P.Var(P.fresh("o"), AccT(p.d))
        body = show(p.f(i, o), indent + 1)
        return (f"parfor[{p.level}] {p.n} ({s(p.a)}) (λ{i.name} {o.name}.\n"
                f"{pad}  {body})")
    if isinstance(p, P.VView):
        return f"<view {s(p.acc)}>"
    if isinstance(p, P.AccPart):
        return f"{s(p.v)}.1"
    if isinstance(p, P.ExpPart):
        return f"{s(p.v)}.2"
    if isinstance(p, P.IdxAcc):
        return f"idxAcc ({s(p.a)}) ({s(p.i)})"
    if isinstance(p, P.SplitAcc):
        return f"splitAcc {p.n} ({s(p.a)})"
    if isinstance(p, P.JoinAcc):
        return f"joinAcc {p.m} ({s(p.a)})"
    if isinstance(p, P.PairAcc1):
        return f"pairAcc1 ({s(p.a)})"
    if isinstance(p, P.PairAcc2):
        return f"pairAcc2 ({s(p.a)})"
    if isinstance(p, P.ZipAcc1):
        return f"zipAcc1 ({s(p.a)})"
    if isinstance(p, P.ZipAcc2):
        return f"zipAcc2 ({s(p.a)})"
    if isinstance(p, P.AsScalarAcc):
        return f"asScalarAcc ({s(p.a)})"
    if isinstance(p, P.AsVectorAcc):
        return f"asVectorAcc<{p.w}> ({s(p.a)})"
    if isinstance(p, P.MapI):
        x = P.Var(P.fresh("x"), ExpT(p.d1))
        o = P.Var(P.fresh("o"), AccT(p.d2))
        body = show(p.f(x, o), indent + 1)
        return (f"mapI[{p.level}] {p.n} (λ{x.name} {o.name}.\n{pad}  {body})\n"
                f"{pad}  ({s(p.e)}) ({s(p.a)})")
    if isinstance(p, P.ReduceI):
        x = P.Var(P.fresh("x"), ExpT(p.d1))
        y = P.Var(P.fresh("y"), ExpT(p.d2))
        o = P.Var(P.fresh("o"), AccT(p.d2))
        r = P.Var(P.fresh("r"), ExpT(p.d2))
        body = show(p.f(x, y, o), indent + 1)
        kont = show(p.k(r), indent + 1)
        return (f"reduceI {p.n} (λ{x.name} {y.name} {o.name}.\n{pad}  {body})\n"
                f"{pad}  ({s(p.init)}) ({s(p.e)}) (λ{r.name}.\n{pad}  {kont})")
    return object.__repr__(p)


def _elem(e: P.Phrase):
    from .types import Arr
    d = P.exp_data(e)
    assert isinstance(d, Arr), show_data(d)
    return d.elem
