"""Allocation hoisting out of parallel loops (paper section 6.4).

OpenCL (and Pallas) require temporary buffers to be declared up front rather
than allocated inside kernels.  This pass lifts every non-register ``new``
nested inside ``parfor`` loops to the top of the program, multiplying its
extent by the iteration counts of the enclosing parallel loops, and hands the
loop body a *view* (``VView``) of its private slice — exactly the paper's
transformation (their shaded-substitution example).

Two deterministic passes over the HOAS tree, keyed by structural paths so the
collect pass and the rebuild pass agree on which ``new`` is which.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from . import phrases as P
from .types import AccT, Arr, DataType, ExpT, Idx, VarT


def _probe(t) -> P.Var:
    return P.Var(P.fresh("probe"), t)


def collect(cmd: P.Phrase,
            spaces: Tuple[str, ...] = (P.HBM, P.VMEM)) -> Dict[str, Tuple[DataType, str]]:
    """Map structural-path -> (hoisted full data type, space) for every
    ``new`` in one of ``spaces`` under at least one ``parfor``."""
    items: Dict[str, Tuple[DataType, str]] = {}

    def go(q: P.Phrase, key: str, loop_ns: List[int]) -> None:
        if isinstance(q, P.SeqC):
            go(q.c1, key + "L", loop_ns)
            go(q.c2, key + "R", loop_ns)
        elif isinstance(q, P.New):
            if q.space in spaces and loop_ns:
                d_full: DataType = q.d
                for n in reversed(loop_ns):
                    d_full = Arr(n, d_full)
                items[key] = (d_full, q.space)
            go(q.f(_probe(VarT(q.d))), key + "N", loop_ns)
        elif isinstance(q, P.For):
            go(q.f(_probe(ExpT(Idx(q.n)))), key + "F", loop_ns)
        elif isinstance(q, P.ParFor):
            go(q.f(_probe(ExpT(Idx(q.n))), _probe(AccT(q.d))),
               key + "P", loop_ns + [q.n])
        elif isinstance(q, (P.MapI, P.ReduceI)):
            from . import stage2
            go(stage2.expand(q), key, loop_ns)
        elif isinstance(q, (P.Skip, P.Assign)):
            pass
        else:
            raise TypeError(f"hoist.collect: not a command {type(q).__name__}")

    go(cmd, "", [])
    return items


def hoist(cmd: P.Phrase,
          spaces: Tuple[str, ...] = (P.HBM, P.VMEM)) -> P.Phrase:
    """Lift parfor-nested allocations to the top (paper section 6.4)."""
    items = collect(cmd, spaces)
    if not items:
        return cmd
    keys = list(items)

    def rebuild(q: P.Phrase, key: str, idx_stack, handles) -> P.Phrase:
        if isinstance(q, P.SeqC):
            return P.SeqC(rebuild(q.c1, key + "L", idx_stack, handles),
                          rebuild(q.c2, key + "R", idx_stack, handles))
        if isinstance(q, P.New):
            if key in items:
                h = handles[key]
                acc: P.Phrase = P.AccPart(h)
                exp: P.Phrase = P.ExpPart(h)
                for i in idx_stack:
                    acc = P.IdxAcc(acc, i)
                    exp = P.IdxE(exp, i)
                vv = P.VView(acc, exp)
                return rebuild(q.f(vv), key + "N", idx_stack, handles)
            return P.New(q.d,
                         lambda v: rebuild(q.f(v), key + "N", idx_stack,
                                           handles),
                         space=q.space)
        if isinstance(q, P.For):
            return P.For(q.n,
                         lambda i: rebuild(q.f(i), key + "F", idx_stack,
                                           handles),
                         unroll=q.unroll)
        if isinstance(q, P.ParFor):
            return P.ParFor(
                q.n, q.d, q.a,
                lambda i, o: rebuild(q.f(i, o), key + "P",
                                     idx_stack + [i], handles),
                level=q.level)
        if isinstance(q, (P.MapI, P.ReduceI)):
            from . import stage2
            return rebuild(stage2.expand(q), key, idx_stack, handles)
        return q

    def mk(k: int, handles) -> P.Phrase:
        if k == len(keys):
            return rebuild(cmd, "", [], handles)
        key = keys[k]
        d_full, space = items[key]
        return P.New(d_full, lambda h: mk(k + 1, {**handles, key: h}),
                     space=space)

    return mk(0, {})
