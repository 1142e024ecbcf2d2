"""SCIR interference control (paper section 3.2, Fig. 3) as a checker.

The substructural discipline we enforce on the AST:

  * every ``parfor`` / parallel ``mapI`` body must be *passive* apart from the
    acceptor parameter it is handed (the paper's ``->p`` requirement on the
    loop body) — this is the data-race-freedom guarantee;
  * parallel functional ``map`` bodies must not capture active identifiers;
  * variable occurrences are classified passively (``exp``/``.2`` reads) or
    actively (``acc``/``.1`` writes) following the Passify/Activate rules.

``check(phrase)`` = type check (phrases.type_of) + race-freedom.  Violations
raise :class:`RaceError` with the offending identifiers.
"""
from __future__ import annotations

from typing import Dict, Set

from . import phrases as P
from .types import AccT, ExpT, Idx, VarT


class RaceError(Exception):
    pass


PASSIVE, ACTIVE = "P", "A"


def _merge(into: Dict[str, Set[str]], frm: Dict[str, Set[str]]) -> None:
    for k, v in frm.items():
        into.setdefault(k, set()).update(v)


def uses(p: P.Phrase) -> Dict[str, Set[str]]:  # noqa: C901
    """Free identifier occurrences classified as passive/active."""
    out: Dict[str, Set[str]] = {}

    def go(q: P.Phrase) -> None:
        if isinstance(q, P.Var):
            if isinstance(q.t, ExpT):
                out.setdefault(q.name, set()).add(PASSIVE)
            else:  # acc / var / comm / fn-typed bare identifiers
                out.setdefault(q.name, set()).add(ACTIVE)
            return
        if isinstance(q, P.ExpPart):
            if isinstance(q.v, P.VView):
                go(q.v.exp)
            else:
                out.setdefault(q.v.name, set()).add(PASSIVE)
            return
        if isinstance(q, P.AccPart):
            if isinstance(q.v, P.VView):
                go(q.v.acc)
            else:
                out.setdefault(q.v.name, set()).add(ACTIVE)
            return
        if isinstance(q, P.Map):
            x = P.Var(P.fresh("x"), ExpT(_elem(q.e)))
            _merge(out, _without(uses(q.f(x)), {x.name}))
            go(q.e)
            return
        if isinstance(q, P.Reduce):
            x = P.Var(P.fresh("x"), ExpT(_elem(q.e)))
            acc = P.Var(P.fresh("acc"), P.type_of(q.init))
            _merge(out, _without(uses(q.f(x, acc)), {x.name, acc.name}))
            go(q.init)
            go(q.e)
            return
        if isinstance(q, P.New):
            v = P.Var(P.fresh("v"), VarT(q.d))
            _merge(out, _without(uses(q.f(v)), {v.name}))
            return
        if isinstance(q, P.For):
            i = P.Var(P.fresh("i"), ExpT(Idx(q.n)))
            _merge(out, _without(uses(q.f(i)), {i.name}))
            return
        if isinstance(q, P.ParFor):
            i = P.Var(P.fresh("i"), ExpT(Idx(q.n)))
            o = P.Var(P.fresh("o"), AccT(q.d))
            _merge(out, _without(uses(q.f(i, o)), {i.name, o.name}))
            go(q.a)
            return
        if isinstance(q, P.MapI):
            x = P.Var(P.fresh("x"), ExpT(q.d1))
            o = P.Var(P.fresh("o"), AccT(q.d2))
            _merge(out, _without(uses(q.f(x, o)), {x.name, o.name}))
            go(q.e)
            go(q.a)
            return
        if isinstance(q, P.ReduceI):
            x = P.Var(P.fresh("x"), ExpT(q.d1))
            y = P.Var(P.fresh("y"), ExpT(q.d2))
            o = P.Var(P.fresh("o"), AccT(q.d2))
            r = P.Var(P.fresh("r"), ExpT(q.d2))
            _merge(out, _without(uses(q.f(x, y, o)), {x.name, y.name, o.name}))
            _merge(out, _without(uses(q.k(r)), {r.name}))
            go(q.init)
            go(q.e)
            return
        # structural recursion over plain children
        for name in ("e", "a", "b", "i", "v", "c1", "c2", "init"):
            child = getattr(q, name, None)
            if isinstance(child, P.Phrase):
                go(child)

    go(p)
    return out


def _without(u: Dict[str, Set[str]], names: Set[str]) -> Dict[str, Set[str]]:
    return {k: v for k, v in u.items() if k not in names}


def _elem(e: P.Phrase):
    from .types import Arr
    d = P.exp_data(e)
    assert isinstance(d, Arr)
    return d.elem


def _actives(u: Dict[str, Set[str]]) -> Set[str]:
    return {k for k, v in u.items() if ACTIVE in v}


def check_race_free(p: P.Phrase) -> None:  # noqa: C901
    """Verify the parfor/parallel-map passivity discipline recursively."""
    if isinstance(p, P.ParFor):
        i = P.Var(P.fresh("i"), ExpT(Idx(p.n)))
        o = P.Var(P.fresh("o"), AccT(p.d))
        body = p.f(i, o)
        bad = _actives(_without(uses(body), {i.name})) - {o.name}
        if bad:
            raise RaceError(
                f"parfor[{p.level}] body actively uses {sorted(bad)}; a "
                f"parallel loop body may only write through its own acceptor")
        check_race_free(body)
        return
    if isinstance(p, P.MapI):
        x = P.Var(P.fresh("x"), ExpT(p.d1))
        o = P.Var(P.fresh("o"), AccT(p.d2))
        body = p.f(x, o)
        bad = _actives(_without(uses(body), {x.name})) - {o.name}
        if bad:
            raise RaceError(
                f"mapI[{p.level}] body actively uses {sorted(bad)}")
        check_race_free(body)
        return
    if isinstance(p, P.Map) and p.level.kind not in ("seq",):
        x = P.Var(P.fresh("x"), ExpT(_elem(p.e)))
        body = p.f(x)
        bad = _actives(_without(uses(body), {x.name}))
        if bad:
            raise RaceError(f"parallel map body actively uses {sorted(bad)}")
        check_race_free(body)
        check_race_free(p.e)
        return
    if isinstance(p, P.Reduce):
        x = P.Var(P.fresh("x"), ExpT(_elem(p.e)))
        acc = P.Var(P.fresh("acc"), P.type_of(p.init))
        check_race_free(p.f(x, acc))
        check_race_free(p.init)
        check_race_free(p.e)
        return
    if isinstance(p, P.New):
        check_race_free(p.f(P.Var(P.fresh("v"), VarT(p.d))))
        return
    if isinstance(p, P.For):
        check_race_free(p.f(P.Var(P.fresh("i"), ExpT(Idx(p.n)))))
        return
    if isinstance(p, P.ReduceI):
        x = P.Var(P.fresh("x"), ExpT(p.d1))
        y = P.Var(P.fresh("y"), ExpT(p.d2))
        o = P.Var(P.fresh("o"), AccT(p.d2))
        check_race_free(p.f(x, y, o))
        check_race_free(p.k(P.Var(P.fresh("r"), ExpT(p.d2))))
        check_race_free(p.init)
        check_race_free(p.e)
        return
    for name in ("e", "a", "b", "i", "v", "c1", "c2", "init"):
        child = getattr(p, name, None)
        if isinstance(child, P.Phrase):
            check_race_free(child)


def check(p: P.Phrase) -> None:
    """Full check: well-typed + race free."""
    P.type_of(p)
    check_race_free(p)
