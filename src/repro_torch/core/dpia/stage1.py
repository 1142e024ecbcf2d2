"""Stage I: acceptor-passing and continuation-passing translations (Fig. 5).

``acceptor(E, A)`` produces a command equivalent to ``A :=_d E``;
``continuation(E, C)`` produces a command equivalent to ``C(E)``.
The two are mutually recursive exactly as in the paper; because binders are
HOAS, the "no administrative redexes" property of the paper's one-pass
formulation holds by construction.

Deviations from Fig. 5 (documented in DESIGN.md section 8):
  * ``Assign`` is kept at compound data types as a block operation (the TPU VPU
    leaf) instead of always expanding through ``mapI``; the paper's expansion
    of ``:=_d`` is available as :func:`expand_assign` and is applied by the
    imperative backends where needed.
  * ``ToMem`` (the paper's toGlobal/toLocal/toPrivate of section 6.2) threads a
    ``space`` parameter into the continuation translation; it steers where
    ``new`` allocates when a map result is materialised.
  * extra leaf primitives (DotBlock/FullReduce/As{Vector,Scalar}) follow the
    same clause shapes as the paper's first-order operators / split / join.
"""
from __future__ import annotations

from typing import Callable

from . import phrases as P
from .types import Arr, Pair, Vec


def acceptor(e: P.Phrase, a: P.Phrase) -> P.Phrase:  # noqa: C901
    """A(E)_d(A): a command with the effect of ``A :=_d E`` (Fig. 5a)."""
    if isinstance(e, (P.Var, P.Lit, P.ExpPart)):
        return P.Assign(a, e)
    if isinstance(e, P.UnOp):
        return continuation(e.e, lambda x: P.Assign(a, P.UnOp(e.op, x)))
    if isinstance(e, P.BinOp):
        return continuation(
            e.a, lambda x: continuation(
                e.b, lambda y: P.Assign(a, P.BinOp(e.op, x, y))))
    if isinstance(e, P.Map):
        d = P.exp_data(e.e)
        assert isinstance(d, Arr)
        x0 = P.Var(P.fresh("xe"), P.ExpT(d.elem))
        d2 = P.exp_data(e.f(x0))
        return continuation(
            e.e,
            lambda x: P.MapI(
                d.n, d.elem, d2,
                lambda xe, o: acceptor(e.f(xe), o),
                x, a, level=e.level))
    if isinstance(e, P.Reduce):
        d = P.exp_data(e.e)
        assert isinstance(d, Arr)
        d2 = P.exp_data(e.init)
        return continuation(
            e.e,
            lambda x: continuation(
                e.init,
                lambda y: P.ReduceI(
                    d.n, d.elem, d2,
                    lambda xe, ye, o: acceptor(e.f(xe, ye), o),
                    y, x,
                    lambda r: P.Assign(a, r))))
    if isinstance(e, P.Zip):
        return P.SeqC(acceptor(e.a, P.ZipAcc1(a)), acceptor(e.b, P.ZipAcc2(a)))
    if isinstance(e, P.Split):
        return acceptor(e.e, P.SplitAcc(e.n, a))
    if isinstance(e, P.Join):
        d = P.exp_data(e.e)
        assert isinstance(d, Arr) and isinstance(d.elem, Arr)
        return acceptor(e.e, P.JoinAcc(d.elem.n, a))
    if isinstance(e, P.PairE):
        return P.SeqC(acceptor(e.a, P.PairAcc1(a)), acceptor(e.b, P.PairAcc2(a)))
    if isinstance(e, P.Fst):
        return continuation(e.e, lambda x: P.Assign(a, P.Fst(x)))
    if isinstance(e, P.Snd):
        return continuation(e.e, lambda x: P.Assign(a, P.Snd(x)))
    if isinstance(e, P.IdxE):
        return continuation(
            e.e, lambda x: continuation(
                e.i, lambda j: P.Assign(a, P.IdxE(x, j))))
    if isinstance(e, P.AsVector):
        return acceptor(e.e, P.AsScalarAcc(a))
    if isinstance(e, P.AsScalar):
        d = P.exp_data(e.e)
        assert isinstance(d, Arr) and isinstance(d.elem, Vec)
        return acceptor(e.e, P.AsVectorAcc(d.elem.n, a))
    if isinstance(e, P.Transpose):
        return acceptor(e.e, P.TransposeAcc(a))
    if isinstance(e, P.DotBlock):
        return continuation(
            e.a, lambda x: continuation(
                e.b, lambda y: P.Assign(a, P.DotBlock(x, y, e.acc_dtype))))
    if isinstance(e, P.FullReduce):
        return continuation(e.e, lambda x: P.Assign(a, P.FullReduce(e.op, x)))
    if isinstance(e, P.ToMem):
        # In acceptor position the target storage already exists; the space
        # annotation only matters for the continuation translation.
        return acceptor(e.e, a)
    raise TypeError(f"acceptor translation: unhandled {type(e).__name__}")


def continuation(e: P.Phrase,
                 c: Callable[[P.Phrase], P.Phrase],
                 space: str = P.HBM) -> P.Phrase:  # noqa: C901
    """C(E)_d(C): a command with the effect of ``C(E)`` (Fig. 5b)."""
    if isinstance(e, (P.Var, P.Lit, P.ExpPart)):
        return c(e)
    if isinstance(e, P.UnOp):
        return continuation(e.e, lambda x: c(P.UnOp(e.op, x)), space)
    if isinstance(e, P.BinOp):
        return continuation(
            e.a, lambda x: continuation(
                e.b, lambda y: c(P.BinOp(e.op, x, y)), space), space)
    if isinstance(e, P.Map):
        d = P.exp_data(e.e)
        assert isinstance(d, Arr)
        x0 = P.Var(P.fresh("xe"), P.ExpT(d.elem))
        d2 = P.exp_data(e.f(x0))
        out_space = e.space or space
        # new (n.d2) (λtmp. A(map ..)(tmp.1); C(tmp.2))   — the deliberate
        # materialisation point: no implicit fusion (paper section 2.2).
        return P.New(
            Arr(d.n, d2),
            lambda tmp: P.SeqC(
                acceptor(e, P.AccPart(tmp)),
                c(P.ExpPart(tmp))),
            space=out_space)
    if isinstance(e, P.Reduce):
        d = P.exp_data(e.e)
        assert isinstance(d, Arr)
        d2 = P.exp_data(e.init)
        return continuation(
            e.e,
            lambda x: continuation(
                e.init,
                lambda y: P.ReduceI(
                    d.n, d.elem, d2,
                    lambda xe, ye, o: acceptor(e.f(xe, ye), o),
                    y, x, c),
                space),
            space)
    if isinstance(e, P.Zip):
        return continuation(
            e.a, lambda x: continuation(
                e.b, lambda y: c(P.Zip(x, y)), space), space)
    if isinstance(e, P.Split):
        return continuation(e.e, lambda x: c(P.Split(e.n, x)), space)
    if isinstance(e, P.Join):
        return continuation(e.e, lambda x: c(P.Join(x)), space)
    if isinstance(e, P.PairE):
        return continuation(
            e.a, lambda x: continuation(
                e.b, lambda y: c(P.PairE(x, y)), space), space)
    if isinstance(e, P.Fst):
        return continuation(e.e, lambda x: c(P.Fst(x)), space)
    if isinstance(e, P.Snd):
        return continuation(e.e, lambda x: c(P.Snd(x)), space)
    if isinstance(e, P.IdxE):
        return continuation(
            e.e, lambda x: continuation(
                e.i, lambda j: c(P.IdxE(x, j)), space), space)
    if isinstance(e, P.AsVector):
        return continuation(e.e, lambda x: c(P.AsVector(e.w, x)), space)
    if isinstance(e, P.AsScalar):
        return continuation(e.e, lambda x: c(P.AsScalar(x)), space)
    if isinstance(e, P.Transpose):
        return continuation(e.e, lambda x: c(P.Transpose(x)), space)
    if isinstance(e, P.DotBlock):
        return continuation(
            e.a, lambda x: continuation(
                e.b, lambda y: c(P.DotBlock(x, y, e.acc_dtype)), space), space)
    if isinstance(e, P.FullReduce):
        return continuation(e.e, lambda x: c(P.FullReduce(e.op, x)), space)
    if isinstance(e, P.ToMem):
        return continuation(e.e, c, space=e.space)
    raise TypeError(f"continuation translation: unhandled {type(e).__name__}")


def expand_assign(a: P.Phrase, e: P.Phrase) -> P.Phrase:
    """The paper's generalised assignment ``:=_d`` by induction on d
    (section 4.1): arrays via mapI, pairs componentwise, scalars directly."""
    d = P.acc_data(a)
    if isinstance(d, Arr):
        return P.MapI(d.n, d.elem, d.elem,
                      lambda x, o: expand_assign(o, x), e, a)
    if isinstance(d, Pair):
        return P.SeqC(expand_assign(P.PairAcc1(a), P.Fst(e)),
                      expand_assign(P.PairAcc2(a), P.Snd(e)))
    return P.Assign(a, e)


def translate(e: P.Phrase, out: P.Phrase) -> P.Phrase:
    """Whole Stage-I entry point: A(E)(out)."""
    return acceptor(e, out)
