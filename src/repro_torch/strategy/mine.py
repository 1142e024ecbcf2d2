"""Strategy mining: compress winning traces into reusable abstractions.

Every tuned decision leaves a serialised :class:`StrategyTrace` in the
persistent tuning cache (``record["strategy_trace"]``).  This module mines
that corpus the imperative-stitch way: pairwise *anti-unification* of
traces — the longest common subsequence of ``(rule, path)`` steps, with
parameters that differ across the pair replaced by holes (``"?"``) — then
keeps the generalisations at least ``min_support`` winners instantiate.

The named :class:`Abstraction` s persist beside the cache
(``<cache>.abstractions.json``) and seed later searches: candidates whose
derivation matches a mined abstraction are ranked first
(:func:`seeded_order`, used by ``autotune.tune``), so on a warm corpus the
incumbent best is reached in fewer candidate evaluations — the metric the
reference's ``benchmarks/strategy_bench.py`` pins down.

The port's copy of ``repro.strategy.mine``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterable, List, Sequence, Tuple

from repro_torch.ft import artefacts

from .lang import StrategyTrace

__all__ = ["HOLE", "AbsStep", "Abstraction", "anti_unify", "mine",
           "matches", "seeded_order", "abstractions_path",
           "save_abstractions", "load_abstractions"]

HOLE = "?"
ABSTRACTIONS_VERSION = 1


@dataclasses.dataclass(frozen=True)
class AbsStep:
    """One generalised trace step; params map to a value or to HOLE."""
    rule: str
    path: Tuple[str, ...]
    params: Tuple[Tuple[str, object], ...]  # sorted items; HOLE = any value

    def to_doc(self) -> dict:
        return {"rule": self.rule, "path": list(self.path),
                "params": {k: v for k, v in self.params}}

    @classmethod
    def from_doc(cls, doc: dict) -> "AbsStep":
        return cls(rule=str(doc["rule"]),
                   path=tuple(str(s) for s in doc.get("path", ())),
                   params=tuple(sorted(doc.get("params", {}).items())))


@dataclasses.dataclass
class Abstraction:
    """A named, parameter-holed rewrite subsequence mined from winners."""
    name: str
    steps: Tuple[AbsStep, ...]
    support: int = 0

    def to_doc(self) -> dict:
        return {"name": self.name, "support": self.support,
                "steps": [s.to_doc() for s in self.steps]}

    @classmethod
    def from_doc(cls, doc: dict) -> "Abstraction":
        return cls(name=str(doc["name"]),
                   steps=tuple(AbsStep.from_doc(s)
                               for s in doc.get("steps", ())),
                   support=int(doc.get("support", 0)))

    def describe(self) -> str:
        body = " ; ".join(
            s.rule + ("(" + ",".join(
                f"{k}={v}" for k, v in s.params) + ")" if s.params else "")
            + ("@" + "/".join(s.path) if s.path else "")
            for s in self.steps)
        return f"{self.name} [support={self.support}]: {body}"


# ---------------------------------------------------------------------------
# anti-unification
# ---------------------------------------------------------------------------

def _steps_of(trace) -> List[Tuple[str, Tuple[str, ...], Dict[str, object]]]:
    tr = StrategyTrace.from_doc(trace)
    return [(s.rule, s.path, dict(s.params)) for s in tr.steps]


def _merge_params(p1: Dict[str, object],
                  p2: Dict[str, object]) -> Tuple[Tuple[str, object], ...]:
    keys = set(p1) | set(p2)
    merged = {}
    for k in keys:
        v1, v2 = p1.get(k, HOLE), p2.get(k, HOLE)
        merged[k] = v1 if v1 == v2 else HOLE
    return tuple(sorted(merged.items()))


def anti_unify(t1, t2) -> Tuple[AbsStep, ...]:
    """Longest common ``(rule, path)`` subsequence of two traces, with
    differing parameters generalised to holes (classic LCS dynamic
    program; ties prefer earlier steps, so the result is deterministic)."""
    s1, s2 = _steps_of(t1), _steps_of(t2)
    n1, n2 = len(s1), len(s2)
    # lcs[i][j] = LCS length of s1[i:], s2[j:]
    lcs = [[0] * (n2 + 1) for _ in range(n1 + 1)]
    for i in range(n1 - 1, -1, -1):
        for j in range(n2 - 1, -1, -1):
            if s1[i][0] == s2[j][0] and s1[i][1] == s2[j][1]:
                lcs[i][j] = 1 + lcs[i + 1][j + 1]
            else:
                lcs[i][j] = max(lcs[i + 1][j], lcs[i][j + 1])
    out: List[AbsStep] = []
    i = j = 0
    while i < n1 and j < n2:
        if s1[i][0] == s2[j][0] and s1[i][1] == s2[j][1]:
            out.append(AbsStep(s1[i][0], s1[i][1],
                               _merge_params(s1[i][2], s2[j][2])))
            i, j = i + 1, j + 1
        elif lcs[i + 1][j] >= lcs[i][j + 1]:
            i += 1
        else:
            j += 1
    return tuple(out)


def matches(abstraction: Abstraction, trace) -> bool:
    """Does a trace instantiate the abstraction?  The abstraction's steps
    must appear as a subsequence, each step matching on (rule, path) with
    every non-hole param equal."""
    if not abstraction.steps:
        return False
    steps = _steps_of(trace)
    i = 0
    for rule_, path, params in steps:
        want = abstraction.steps[i]
        if rule_ == want.rule and path == want.path and all(
                v == HOLE or params.get(k) == v for k, v in want.params):
            i += 1
            if i == len(abstraction.steps):
                return True
    return False


def mine(records: Iterable, min_len: int = 2,
         min_support: int = 2, max_abstractions: int = 8
         ) -> List[Abstraction]:
    """Mine abstractions from tuning-cache records (or raw trace docs).

    ``records`` is a TuningCache, an iterable of cache record dicts, or an
    iterable of trace docs.  Pairwise anti-unification proposes
    generalisations of length >= ``min_len``; each is kept if at least
    ``min_support`` corpus traces instantiate it, ranked by (support,
    length) descending."""
    traces = _collect_traces(records)
    proposals: Dict[tuple, Tuple[AbsStep, ...]] = {}
    for i in range(len(traces)):
        for j in range(i + 1, len(traces)):
            g = anti_unify(traces[i], traces[j])
            if len(g) >= min_len:
                proposals.setdefault(g, g)
    scored = []
    for g in proposals.values():
        proto = Abstraction("?", g)
        support = sum(1 for t in traces if matches(proto, t))
        if support >= min_support:
            scored.append((support, len(g), g))
    # longer wins at equal support (more of the derivation captured);
    # the doc form of the steps is the deterministic tiebreak
    scored.sort(key=lambda s: (-s[0], -s[1],
                               json.dumps([a.to_doc() for a in s[2]],
                                          sort_keys=True)))
    out: List[Abstraction] = []
    for support, _, g in scored[:max_abstractions]:
        name = "mined/" + "+".join(dict.fromkeys(s.rule for s in g))
        if any(a.name == name for a in out):
            name = f"{name}#{sum(a.name.startswith(name) for a in out)}"
        out.append(Abstraction(name, g, support))
    return out


def _collect_traces(records) -> List[dict]:
    from repro_torch.autotune.cache import TuningCache
    if isinstance(records, TuningCache):
        records = [records.get(k) for k in records.keys()]
    traces = []
    for r in records:
        if r is None:
            continue
        if isinstance(r, dict) and "steps" in r and "params" not in r:
            doc = r  # already a trace doc
        elif isinstance(r, dict):
            doc = r.get("strategy_trace")
        else:
            doc = None
        if doc and doc.get("steps"):
            traces.append(doc)
    return traces


# ---------------------------------------------------------------------------
# seeding
# ---------------------------------------------------------------------------

def seeded_order(candidates: Sequence, abstractions: Sequence[Abstraction]
                 ) -> List:
    """Stable partition of autotune Candidates: those whose derivation
    matches a mined abstraction first, everything else after, original
    order preserved within each half."""
    if not abstractions:
        return list(candidates)
    hits, rest = [], []
    for c in candidates:
        try:
            doc = c.trace_doc()
        except Exception:
            doc = None
        if doc and any(matches(a, doc) for a in abstractions):
            hits.append(c)
        else:
            rest.append(c)
    return hits + rest


# ---------------------------------------------------------------------------
# persistence (beside the tuning cache)
# ---------------------------------------------------------------------------

def abstractions_path(cache_path: str) -> str:
    root, _ = os.path.splitext(cache_path)
    return root + ".abstractions.json"


def save_abstractions(path: str, abstractions: Sequence[Abstraction]) -> str:
    """Atomic, checksummed write (repro_torch.ft.artefacts) — a torn or
    bit-flipped abstractions file is detected and quarantined at load."""
    doc = {"version": ABSTRACTIONS_VERSION,
           "abstractions": [a.to_doc() for a in abstractions]}
    return artefacts.save_json(path, doc)


def load_abstractions(path: str) -> List[Abstraction]:
    """Read a mined-abstractions file; missing files are empty (an
    abstraction store is a cache, not a source of truth).  A CORRUPT file
    — unparseable, checksum-failed, or with malformed records — is
    quarantined to ``<path>.quarantine/`` and reported (warn-once log +
    always-on ``artefact.load_failed`` counter) instead of silently read
    as empty; the next ``mine()``+``save_abstractions`` rebuilds it."""
    doc = artefacts.load_json(path, what="strategy abstractions")
    if doc is None:
        return []
    if doc.get("version") != ABSTRACTIONS_VERSION:
        return []  # version skew: expected after an upgrade
    try:
        return [Abstraction.from_doc(a)
                for a in doc.get("abstractions", ())]
    except (ValueError, KeyError, TypeError, AttributeError) as e:
        artefacts.report_load_failure(
            path, "strategy abstractions", e,
            artefacts.quarantine(path))
        return []
