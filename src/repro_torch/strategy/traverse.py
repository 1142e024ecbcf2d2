"""HOAS-aware traversal combinators over the DPIA phrase tree.

The functional phrase nodes are frozen dataclasses whose children are
either plain sub-phrases (``BinOp.a``) or *binders* — Python callables
receiving ``Var`` nodes (``Map.f``, ``Reduce.f``).  A slot table maps each
node type to its children in declared field order, so traversal strategies
can

  * descend into plain children by field name, and
  * descend *under* a binder by probing it with a fresh typed ``Var``
    (deciding success and recording the trace on the probe body), then
    rebuilding the binder as a closure that re-applies the same pure
    strategy at every later instantiation.

Paths in traces are tuples of slot names from the root (``("e", "f")`` =
"inside the ``e`` child, under its ``f`` binder"), which is what makes a
trace replayable with :func:`at` / :func:`replay`.

``fingerprint`` is the structural identity the subsystem standardises on:
binders are instantiated with canonical depth-indexed names so two
independently built phrases compare equal iff they are the same term —
``repr``/``pretty.show`` cannot serve here because ``phrases.fresh()``
draws from a process-global counter.

The port's copy of ``repro.strategy.traverse``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

from repro_torch.core.dpia import phrases as P
from repro_torch.core.dpia.types import Arr, ExpT

from . import lang
from .lang import (Result, Strategy, StrategyTrace, failure, rule, success)

__all__ = ["Slot", "slots_of", "fingerprint", "one", "all_", "topdown",
           "bottomup", "at", "replay"]


# ---------------------------------------------------------------------------
# the slot table
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Slot:
    """One child position of a phrase node.

    ``kind`` is "phrase" (a plain sub-phrase field) or "binder" (a HOAS
    callable field); for binders ``arg_types(node)`` yields the PhraseTypes
    of the fresh Vars to probe with."""
    name: str
    kind: str
    arg_types: Callable[[P.Phrase], Tuple] = None


def _elem_of(p: P.Phrase):
    d = P.exp_data(p)
    if not isinstance(d, Arr):
        raise TypeError(f"binder input is not an array: {d}")
    return d.elem


def _map_args(m: P.Map) -> Tuple:
    return (ExpT(_elem_of(m.e)),)


def _reduce_args(r: P.Reduce) -> Tuple:
    return (ExpT(_elem_of(r.e)), ExpT(P.exp_data(r.init)))


def _ph(name: str) -> Slot:
    return Slot(name, "phrase")


_SLOTS = {
    P.UnOp: [_ph("e")],
    P.BinOp: [_ph("a"), _ph("b")],
    P.Map: [Slot("f", "binder", _map_args), _ph("e")],
    P.Reduce: [Slot("f", "binder", _reduce_args), _ph("init"), _ph("e")],
    P.Zip: [_ph("a"), _ph("b")],
    P.Split: [_ph("e")],
    P.Join: [_ph("e")],
    P.PairE: [_ph("a"), _ph("b")],
    P.Fst: [_ph("e")],
    P.Snd: [_ph("e")],
    P.IdxE: [_ph("e"), _ph("i")],
    P.AsVector: [_ph("e")],
    P.AsScalar: [_ph("e")],
    P.Transpose: [_ph("e")],
    P.DotBlock: [_ph("a"), _ph("b")],
    P.FullReduce: [_ph("e")],
    P.ToMem: [_ph("e")],
}


def slots_of(p: P.Phrase) -> List[Slot]:
    """The traversable children of ``p`` (empty for leaves: Var, Lit, and
    every imperative node — strategies rewrite functional terms only)."""
    return _SLOTS.get(type(p), [])


# ---------------------------------------------------------------------------
# structural fingerprint
# ---------------------------------------------------------------------------

def _head(p: P.Phrase) -> str:
    """Node head: type name + every scalar (non-phrase, non-binder) field."""
    vals = []
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        if isinstance(v, P.Phrase) or callable(v):
            continue
        vals.append(f"{f.name}={v!r}")
    return f"{type(p).__name__}({','.join(vals)})"


def fingerprint(p: P.Phrase) -> str:
    """Canonical structural string: equal iff the phrases are the same term.

    Binders are instantiated with depth-indexed ``_fp<i>`` names, so the
    fingerprint is stable across processes and across builder call sites
    (unlike reprs, which embed the global fresh-variable counter)."""
    parts: List[str] = []
    counter = [0]

    def go(q: P.Phrase) -> None:
        if isinstance(q, P.Var):
            parts.append(f"Var({q.name}:{q.t})")
            return
        parts.append(_head(q))
        for slot in slots_of(q):
            parts.append(f"<{slot.name}")
            if slot.kind == "phrase":
                go(getattr(q, slot.name))
            else:
                fvs = []
                for t in slot.arg_types(q):
                    fvs.append(P.Var(f"_fp{counter[0]}", t))
                    counter[0] += 1
                go(getattr(q, slot.name)(*fvs))
            parts.append(">")

    go(p)
    return "".join(parts)


# ---------------------------------------------------------------------------
# traversal strategies
# ---------------------------------------------------------------------------

def _descend(s: Strategy, p: P.Phrase, slot: Slot,
             path: Tuple[str, ...]) -> Result:
    """Apply ``s`` to one child slot of ``p``; rebuild ``p`` on success."""
    sub_path = tuple(path) + (slot.name,)
    if slot.kind == "phrase":
        res = s.apply(getattr(p, slot.name), sub_path)
        if not res.ok:
            return res
        return success(dataclasses.replace(p, **{slot.name: res.phrase}),
                       res.trace)
    # binder: probe with fresh typed Vars to decide success + trace, then
    # rebuild the closure to re-apply the (pure) strategy per instantiation
    try:
        arg_ts = slot.arg_types(p)
    except Exception as e:  # untyped/odd input: this slot just fails
        return failure(f"binder {slot.name}: {e}")
    f = getattr(p, slot.name)
    probes = [P.Var(P.fresh("_probe"), t) for t in arg_ts]
    try:
        body = f(*probes)
    except Exception as e:
        return failure(f"binder {slot.name}: {e}")
    res = s.apply(body, sub_path)
    if not res.ok:
        return res

    def new_f(*args, _f=f, _s=s):
        r2 = _s.apply(_f(*args))
        if not r2.ok:  # pure strategies succeed identically on every probe
            raise RuntimeError(
                f"strategy {_s.name} succeeded on the binder probe but "
                f"failed on re-instantiation: {r2.reason}")
        return r2.phrase

    return success(dataclasses.replace(p, **{slot.name: new_f}), res.trace)


class _One(Strategy):
    """Apply ``s`` to the first child (declared slot order) where it
    succeeds; fail if no child admits it."""

    def __init__(self, s: Strategy):
        self.s = s
        self.name = f"one({s.name})"

    def apply(self, phrase, path=()):
        reasons = []
        for slot in slots_of(phrase):
            res = _descend(self.s, phrase, slot, path)
            if res.ok:
                return res
            reasons.append(f"{slot.name}: {res.reason}")
        return failure(f"one: no child of {type(phrase).__name__} matched"
                       + (f" ({'; '.join(reasons)})" if reasons else ""))


class _All(Strategy):
    """Apply ``s`` to every child; all must succeed.  Vacuously succeeds on
    leaves (the standard ELEVATE semantics that makes ``topdown`` total)."""

    def __init__(self, s: Strategy):
        self.s = s
        self.name = f"all({s.name})"

    def apply(self, phrase, path=()):
        cur = phrase
        steps = StrategyTrace()
        for slot in slots_of(phrase):
            res = _descend(self.s, cur, slot, path)
            if not res.ok:
                return failure(f"all: child {slot.name}: {res.reason}")
            cur, steps = res.phrase, steps + res.trace
        return success(cur, steps)


def one(s: Strategy) -> Strategy:
    return _One(s)


def all_(s: Strategy) -> Strategy:
    return _All(s)


class _TopDown(Strategy):
    """``topdown(s) = alt(s, one(topdown(s)))`` — outermost-first."""

    def __init__(self, s: Strategy):
        self.s = s
        self.name = f"topdown({s.name})"

    def apply(self, phrase, path=()):
        res = self.s.apply(phrase, path)
        if res.ok:
            return res
        return one(self).apply(phrase, path)


class _BottomUp(Strategy):
    """``bottomup(s) = alt(one(bottomup(s)), s)`` — innermost-first."""

    def __init__(self, s: Strategy):
        self.s = s
        self.name = f"bottomup({s.name})"

    def apply(self, phrase, path=()):
        res = one(self).apply(phrase, path)
        if res.ok:
            return res
        return self.s.apply(phrase, path)


def topdown(s: Strategy) -> Strategy:
    """Apply ``s`` at the outermost position where it succeeds."""
    return _TopDown(s)


def bottomup(s: Strategy) -> Strategy:
    """Apply ``s`` at the innermost position where it succeeds."""
    return _BottomUp(s)


class _At(Strategy):
    """Apply ``s`` exactly at ``path`` (slot names from the root)."""

    def __init__(self, path: Sequence[str], s: Strategy):
        self.path = tuple(path)
        self.s = s
        self.name = f"at({'/'.join(self.path) or '.'},{s.name})"

    def apply(self, phrase, path=()):
        return self._go(phrase, self.path, tuple(path))

    def _go(self, p, rel, abs_path):
        if not rel:
            return self.s.apply(p, abs_path)
        head, rest = rel[0], rel[1:]
        for slot in slots_of(p):
            if slot.name == head:
                inner = _At(rest, self.s)
                # reuse the rebuild machinery with the inner navigation as
                # the strategy for this slot
                return _descend(inner, p, slot, abs_path)
        return failure(f"at: {type(p).__name__} has no slot {head!r}")


def at(path: Sequence[str], s: Strategy) -> Strategy:
    return _At(path, s)


# ---------------------------------------------------------------------------
# trace replay
# ---------------------------------------------------------------------------

def replay(trace, phrase: P.Phrase) -> Result:
    """Re-run a serialised :class:`StrategyTrace` on ``phrase``.

    Each step becomes ``at(step.path, rule(step.rule, **step.params))``
    applied in order — a mined or cached derivation replays with no search.
    Returns a normal :class:`Result`; unknown rules or bad params are a
    failure value like any other."""
    try:
        tr = StrategyTrace.from_doc(trace)
        prog = lang.seq(*[at(s.path, rule(s.rule, **s.params))
                          for s in tr.steps])
    except (KeyError, TypeError, ValueError) as e:
        return failure(f"replay: malformed trace: {e}")
    return prog.apply(phrase)
