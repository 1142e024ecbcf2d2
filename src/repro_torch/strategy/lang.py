"""The strategy combinator language (ELEVATE layer).

A :class:`Strategy` is a program denoting a rewrite attempt: applied to a
DPIA phrase it returns a :class:`Result` — success with the rewritten
phrase and a :class:`StrategyTrace`, or failure with a reason.  Failure is
a *value*, never an exception, so strategies compose: ``seq`` demands both
halves succeed, ``alt``/``try_`` recover, ``repeat`` iterates to a fixed
point, and the traversals in :mod:`repro_torch.strategy.traverse` (``topdown``,
``bottomup``, ``one``, ``all_``) steer rules into subterms — across HOAS
binders — recording *where* each rule fired as a path of field names.

Primitive rules wrap every rewrite in :mod:`repro_torch.core.dpia.strategies`
(split_join, blocked_reduce, fuse_map_into_reduce, vectorize, with_level,
stage_vmem, vpu_reduce, lift_lanes, tile_matmul).  Each primitive carries
JSON-able params only, so a successful application's trace — the ordered
list of ``(rule, path, params)`` steps — serialises into the tuning cache
and replays deterministically (``traverse.replay``), which is what makes a
tuned strategy a portable artefact rather than a closure.

    from repro_torch import strategy as S
    prog = S.seq(S.rule("fuse_map_into_reduce"),
                 S.rule("blocked_reduce", block=2048,
                        partial_level="grid(0)", combine="add"),
                 S.bottomup(S.rule("vpu_reduce")))
    res = prog.apply(expr)          # Result(ok, phrase, trace, reason)
    res.trace.to_doc()              # {"version": 1, "steps": [...]}

The port's copy of ``repro.strategy.lang``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

from repro_torch.core.dpia import phrases as P
from repro_torch.core.dpia import strategies as rw

__all__ = [
    "TraceStep", "StrategyTrace", "Result", "Strategy", "Rule",
    "rule", "RULES", "id_", "fail_", "seq", "try_", "alt", "repeat",
    "repeat_n", "success", "failure", "par_to_str", "par_from_str",
    "is_trace_doc",
]

TRACE_VERSION = 1


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TraceStep:
    """One rule firing: which rule, at which path, with which params."""
    rule: str
    path: Tuple[str, ...] = ()
    params: Dict[str, object] = dataclasses.field(default_factory=dict)

    def to_doc(self) -> dict:
        return {"rule": self.rule, "path": list(self.path),
                "params": dict(self.params)}

    @classmethod
    def from_doc(cls, doc: dict) -> "TraceStep":
        return cls(rule=str(doc["rule"]),
                   path=tuple(str(s) for s in doc.get("path", ())),
                   params=dict(doc.get("params", {})))


@dataclasses.dataclass(frozen=True)
class StrategyTrace:
    """The derivation a successful strategy application took, in order."""
    steps: Tuple[TraceStep, ...] = ()

    def __len__(self) -> int:
        return len(self.steps)

    def __add__(self, other: "StrategyTrace") -> "StrategyTrace":
        return StrategyTrace(self.steps + other.steps)

    def at(self, prefix: Tuple[str, ...]) -> "StrategyTrace":
        """The same trace with every step's path prefixed (a sub-derivation
        hoisted to the enclosing term)."""
        if not prefix:
            return self
        return StrategyTrace(tuple(
            dataclasses.replace(s, path=tuple(prefix) + s.path)
            for s in self.steps))

    def to_doc(self) -> dict:
        return {"version": TRACE_VERSION,
                "steps": [s.to_doc() for s in self.steps]}

    @classmethod
    def from_doc(cls, doc) -> "StrategyTrace":
        if isinstance(doc, StrategyTrace):
            return doc
        steps = doc["steps"] if isinstance(doc, dict) else doc
        return cls(tuple(TraceStep.from_doc(s) for s in steps))

    def describe(self) -> str:
        if not self.steps:
            return "id"
        return " ; ".join(
            s.rule
            + ("(" + ",".join(f"{k}={v}" for k, v in sorted(s.params.items())
                              if v is not None) + ")"
               if any(v is not None for v in s.params.values()) else "")
            + ("@" + "/".join(s.path) if s.path else "")
            for s in self.steps)


def is_trace_doc(obj) -> bool:
    """Does ``obj`` look like a serialised StrategyTrace (or one proper)?"""
    if isinstance(obj, StrategyTrace):
        return True
    return isinstance(obj, dict) and isinstance(obj.get("steps"), list)


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Result:
    """Success (phrase + trace) or failure (reason).  Never raises."""
    ok: bool
    phrase: Optional[P.Phrase] = None
    trace: StrategyTrace = StrategyTrace()
    reason: str = ""

    def __bool__(self) -> bool:
        return self.ok


def success(phrase: P.Phrase, trace=StrategyTrace()) -> Result:
    if isinstance(trace, tuple):
        trace = StrategyTrace(trace)
    return Result(True, phrase, trace)


def failure(reason: str) -> Result:
    return Result(False, None, StrategyTrace(), reason)


# ---------------------------------------------------------------------------
# strategies
# ---------------------------------------------------------------------------

class Strategy:
    """A rewrite program: ``apply(phrase) -> Result``.

    ``path`` threads the position of ``phrase`` inside an enclosing term so
    primitive rules can record absolute paths in their traces; callers at
    the top level never pass it.  Sugar: ``s >> t`` is ``seq(s, t)`` and
    ``s | t`` is ``alt(s, t)``.
    """
    name = "strategy"

    def apply(self, phrase: P.Phrase,
              path: Tuple[str, ...] = ()) -> Result:
        raise NotImplementedError

    def __rshift__(self, other: "Strategy") -> "Strategy":
        return seq(self, other)

    def __or__(self, other: "Strategy") -> "Strategy":
        return alt(self, other)

    def __repr__(self) -> str:
        return f"<Strategy {self.name}>"


class _Id(Strategy):
    name = "id"

    def apply(self, phrase, path=()):
        return success(phrase)


class _Fail(Strategy):
    name = "fail"

    def apply(self, phrase, path=()):
        return failure("fail: always fails")


def id_() -> Strategy:
    """The identity strategy: always succeeds, rewrites nothing."""
    return _Id()


def fail_() -> Strategy:
    """The always-failing strategy (the unit of ``alt``)."""
    return _Fail()


class Rule(Strategy):
    """A primitive rule: one rewrite from ``core.dpia.strategies``.

    Any exception out of the rewrite — an unmet side condition
    (AssertionError), a pattern mismatch (TypeError/AttributeError), an
    ill-typed result (DpiaTypeError from the post-check) — becomes a
    failure value.  A success's trace is the single step
    ``(name, path, params)``."""

    def __init__(self, name: str, params: Dict[str, object],
                 fn: Callable[[P.Phrase], P.Phrase]):
        self.name = name
        self.params = dict(params)
        self._fn = fn

    def apply(self, phrase, path=()):
        try:
            out = self._fn(phrase)
            P.type_of(out)  # a rewrite may never produce an ill-typed term
        except Exception as e:  # noqa: BLE001 — failure is a value here
            return failure(f"{self.name}: {type(e).__name__}: {e}")
        return success(out, (TraceStep(self.name, tuple(path),
                                       dict(self.params)),))


# -- param (de)serialisation helpers -----------------------------------------

_LEVELS = {"seq": P.SEQ, "par": P.PAR, "lanes": P.LANES}


def par_to_str(level: P.Par) -> str:
    return repr(level)  # "seq" | "par" | "lanes" | "grid(0)" | "mesh(x)"


def par_from_str(s) -> P.Par:
    if isinstance(s, P.Par):
        return s
    s = str(s)
    if s in _LEVELS:
        return _LEVELS[s]
    if "(" in s and s.endswith(")"):
        kind, axis = s[:-1].split("(", 1)
        if kind == "grid":
            return P.GRID(int(axis))
        if kind == "mesh":
            return P.MESH(axis)
    raise ValueError(f"par_from_str: unknown level {s!r}")


_COMBINES = {
    "add": lambda x, a: P.add(a, x),
    "max": lambda x, a: P.fmax(a, x),
    "mul": lambda x, a: P.mul(a, x),
}


def _combine_fn(name):
    if name is None:
        return None
    try:
        return _COMBINES[str(name)]
    except KeyError:
        raise ValueError(f"blocked_reduce: unknown combine {name!r}; "
                         f"known: {sorted(_COMBINES)}") from None


# -- the primitive rule registry ---------------------------------------------
# Factories keyed by rule name; kwargs are exactly the JSON params a
# TraceStep carries, so ``rule(step.rule, **step.params)`` replays any step.

RULES: Dict[str, Callable[..., Strategy]] = {
    "id": id_,
    "fail": fail_,
    "split_join": lambda block: Rule(
        "split_join", {"block": int(block)},
        lambda p: rw.split_join(p, int(block))),
    "fuse_map_into_reduce": lambda: Rule(
        "fuse_map_into_reduce", {}, rw.fuse_map_into_reduce),
    "blocked_reduce": lambda block, partial_level=None, combine=None: Rule(
        "blocked_reduce",
        {"block": int(block), "partial_level": partial_level,
         "combine": combine},
        lambda p: rw.blocked_reduce(
            p, int(block),
            partial_level=(par_from_str(partial_level)
                           if partial_level is not None else None),
            combine=_combine_fn(combine))),
    "vectorize": lambda width: Rule(
        "vectorize", {"width": int(width)},
        lambda p: rw.vectorize(p, int(width))),
    "with_level": lambda level: Rule(
        "with_level", {"level": str(level)},
        lambda p: rw.with_level(p, par_from_str(level))),
    "stage_vmem": lambda: Rule("stage_vmem", {}, rw.stage_vmem),
    "vpu_reduce": lambda: Rule("vpu_reduce", {}, rw.vpu_reduce),
    "lift_lanes": lambda: Rule("lift_lanes", {}, rw.lift_lanes),
    "tile_matmul": lambda bm, bk: Rule(
        "tile_matmul", {"bm": int(bm), "bk": int(bk)},
        lambda p: rw.tile_matmul(p, int(bm), int(bk))),
}


def rule(name: str, **params) -> Strategy:
    """A primitive rule by registry name (the replayable vocabulary)."""
    try:
        factory = RULES[name]
    except KeyError:
        raise ValueError(f"rule: unknown rule {name!r}; known: "
                         f"{sorted(RULES)}") from None
    return factory(**params)


# ---------------------------------------------------------------------------
# combinators
# ---------------------------------------------------------------------------

class _Seq(Strategy):
    def __init__(self, ss: Sequence[Strategy]):
        self.ss = list(ss)
        self.name = "seq(" + ";".join(s.name for s in self.ss) + ")"

    def apply(self, phrase, path=()):
        cur, steps = phrase, StrategyTrace()
        for s in self.ss:
            res = s.apply(cur, path)
            if not res.ok:
                return failure(f"seq: {s.name} failed: {res.reason}")
            cur, steps = res.phrase, steps + res.trace
        return success(cur, steps)


def seq(*ss: Strategy) -> Strategy:
    """Apply each strategy in order; fail if any half fails.

    ``seq()`` is the identity and ``seq(s)`` is ``s`` — the monoid laws the
    tests pin down."""
    if not ss:
        return id_()
    if len(ss) == 1:
        return ss[0]
    return _Seq(ss)


class _Alt(Strategy):
    def __init__(self, ss: Sequence[Strategy]):
        self.ss = list(ss)
        self.name = "alt(" + "|".join(s.name for s in self.ss) + ")"

    def apply(self, phrase, path=()):
        reasons = []
        for s in self.ss:
            res = s.apply(phrase, path)
            if res.ok:
                return res
            reasons.append(res.reason)
        return failure("alt: all failed: " + " / ".join(reasons))


def alt(*ss: Strategy) -> Strategy:
    """First success wins (left-biased choice)."""
    if not ss:
        return fail_()
    if len(ss) == 1:
        return ss[0]
    return _Alt(ss)


def try_(s: Strategy) -> Strategy:
    """``alt(s, id)``: attempt ``s``, fall back to the identity."""
    return alt(s, id_())


class _Repeat(Strategy):
    """Apply ``s`` until it fails or stops making progress (fingerprint-
    identical result), up to ``limit`` iterations.  Always succeeds."""

    def __init__(self, s: Strategy, limit: int = 64):
        self.s = s
        self.limit = limit
        self.name = f"repeat({s.name})"

    def apply(self, phrase, path=()):
        from . import traverse  # local: traverse imports this module
        cur, steps = phrase, StrategyTrace()
        fp = traverse.fingerprint(cur)
        for _ in range(self.limit):
            res = self.s.apply(cur, path)
            if not res.ok:
                break
            fp2 = traverse.fingerprint(res.phrase)
            if fp2 == fp:
                break  # non-progressing rule: terminate, drop the no-op
            cur, steps, fp = res.phrase, steps + res.trace, fp2
        return success(cur, steps)


def repeat(s: Strategy, limit: int = 64) -> Strategy:
    """Iterate ``s`` to a fixed point (failure *or* no structural change);
    never fails, ``limit`` bounds runaway always-progressing rules."""
    return _Repeat(s, limit)


class _RepeatN(Strategy):
    def __init__(self, s: Strategy, n: int):
        self.s = s
        self.n = n
        self.name = f"repeat_n({s.name},{n})"

    def apply(self, phrase, path=()):
        cur, steps = phrase, StrategyTrace()
        for i in range(self.n):
            res = self.s.apply(cur, path)
            if not res.ok:
                return failure(f"repeat_n: iteration {i}: {res.reason}")
            cur, steps = res.phrase, steps + res.trace
        return success(cur, steps)


def repeat_n(s: Strategy, n: int) -> Strategy:
    """Apply ``s`` exactly ``n`` times; fails if any iteration fails."""
    return _RepeatN(s, n)


class NamedStrategy(Strategy):
    """Wrap a strategy under a stable display name (mined abstractions,
    space entries)."""

    def __init__(self, name: str, s: Strategy):
        self.name = name
        self.s = s

    def apply(self, phrase, path=()):
        return self.s.apply(phrase, path)


def named(name: str, s: Strategy) -> Strategy:
    return NamedStrategy(name, s)
