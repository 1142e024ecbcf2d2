"""Stage II: expand intermediate imperative combinators to loops (paper 4.2).

  mapI n d1 d2 F E A      ==>  parfor n d2 A (λi o. F (idx E i) o)
  reduceI n d1 d2 F I E C ==>  new d2 (λacc. acc.1 := I;
                                         for n (λi. F (idx E i) acc.2 acc.1);
                                         C acc.2)

Substitution and beta-reduction are free because binders are HOAS.  ``expand``
rewrites a whole command tree bottom-up; the result contains only
new/for/parfor/assign/seq/skip plus expression and acceptor combinators.
"""
from __future__ import annotations

from . import phrases as P


def expand(p: P.Phrase) -> P.Phrase:  # noqa: C901
    """Recursively eliminate MapI/ReduceI from a command phrase."""
    if isinstance(p, P.MapI):
        e, a = p.e, p.a
        return P.ParFor(
            p.n, p.d2, a,
            lambda i, o: expand(p.f(P.IdxE(e, i), o)),
            level=p.level)
    if isinstance(p, P.ReduceI):
        e = p.e
        # The accumulator of a sequential reduction lives in the innermost
        # space (paper: a plain stack variable; TPU: registers/VREG).
        return P.New(
            p.d2,
            lambda v: P.SeqC(
                P.SeqC(
                    P.Assign(P.AccPart(v), p.init),
                    P.For(p.n, lambda i: expand(
                        p.f(P.IdxE(e, i), P.ExpPart(v), P.AccPart(v))))),
                expand(p.k(P.ExpPart(v)))),
            space=P.REG)
    if isinstance(p, P.SeqC):
        return P.SeqC(expand(p.c1), expand(p.c2))
    if isinstance(p, P.New):
        return P.New(p.d, lambda v: expand(p.f(v)), space=p.space)
    if isinstance(p, P.For):
        return P.For(p.n, lambda i: expand(p.f(i)), unroll=p.unroll)
    if isinstance(p, P.ParFor):
        return P.ParFor(p.n, p.d, p.a,
                        lambda i, o: expand(p.f(i, o)), level=p.level)
    if isinstance(p, (P.Skip, P.Assign)):
        return p
    raise TypeError(f"stage2.expand: not a command: {type(p).__name__}")
