"""Deterministic fault injection for the compiler and serving spine.

The port's copy of ``repro.testing.faults`` (framework-neutral).  A fault
degrades what it hits instead of crashing the process only where a path
handles it: a NaN request is quarantined, a failed decode chunk is retried
or its in-flight requests fail, a corrupt block pool degrades the engine
paged -> dense, a corrupt artefact file is quarantined and rebuilt; a
failed executor build raises into its caller (the port has no kernel
degradation ladder).  Those paths are only trustworthy if they are exercised: this
module makes every fault a *scheduled, replayable event* instead of
something a test monkeypatches ad hoc.

A fault is ``(site, match, after, times, value)``: it fires at a named
injection **site** (a ``faults.should_fire("site", **ctx)`` call compiled
into the production code path), for the occurrences whose context matches
``match`` (fnmatch patterns over the ctx values), skipping the first
``after`` matches and firing ``times`` times (``-1``: every time).
``value`` is a free payload (e.g. seconds for ``serve.slow_chunk``).

Activation is scoped and composable::

    from repro_torch.testing import faults
    with faults.inject("executor.build(key=*dot*)"):
        ops.dot(x, y, impl="dpia-torch")      # raises InjectedFault

or process-wide via the ``REPRO_FAULTS`` environment variable (same spec
string), so CI and benches replay exact failure schedules without code.

Spec grammar (semicolon-separated faults)::

    site                          fire on the first matching occurrence
    site(k=v, k2=v2)              ctx match (fnmatch patterns: k=*dot*)
    site(times=3)                 fire on the first three occurrences
    site(after=2)                 skip the first two occurrences
    site(times=-1)                fire on every occurrence
    site(value=0.25)              payload (float if it parses, else str)

Sites wired into the port:

    serve.nan_prefill   ctx req_id: poison a request's admission logits
    serve.nan_decode    ctx req_id: poison a slot's KV cache after admit
    serve.chunk_error   ctx req_ids: raise a transient error before the
                        decode chunk is dispatched (req_ids: comma-joined
                        active ids)
    serve.slow_chunk    ctx req_ids: sleep ``value`` s before the chunk
    serve.pool_exhausted  ctx req_id: admission sees a block-starved pool
                        (deferral)
    serve.pool_corrupt  damage the KV block pool (validate() then catches)
    executor.build      ctx key: raise InjectedFault in executor staging
                        (``compiler.executors.ExecutorCache``)
    artefact.corrupt    ctx what, path: a JSON artefact reads as corrupt
                        (``ft.artefacts.load_json``)

The reference's mesh sites (``mesh.host_lost``, ``mesh.host_slow``,
``collective.timeout``) come with the port's sharded serving (ROADMAP.md
queue 1 item 7b).  A plan naming them parses and never fires.

When no plan is active (no ``inject`` scope, no ``REPRO_FAULTS``),
``should_fire`` is two dict lookups — the sites cost nothing in
production.  All firing decisions are counted (``faults.injected``) and
event-logged through ``repro_torch.obs`` so a faulted run's trace shows exactly
which faults fired where.
"""
from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import os
import threading
from typing import Dict, Iterable, List, Optional, Union

__all__ = ["Fault", "InjectedFault", "parse_spec", "inject", "active",
           "should_fire", "raise_if", "corrupt_json_file", "corrupt_pool",
           "ENV_VAR"]

ENV_VAR = "REPRO_FAULTS"

_META_KEYS = ("times", "after", "value")


class InjectedFault(RuntimeError):
    """The deterministic failure raised at an injected fault site."""


@dataclasses.dataclass
class Fault:
    """One scheduled fault (see module docstring for the semantics)."""
    site: str
    match: Dict[str, str] = dataclasses.field(default_factory=dict)
    after: int = 0
    times: int = 1              # -1: fire on every matching occurrence
    value: Optional[object] = None
    # runtime accounting (mutated under the module lock)
    seen: int = 0
    fired: int = 0

    def matches(self, ctx: Dict[str, object]) -> bool:
        return all(fnmatch.fnmatchcase(str(ctx.get(k)), pat)
                   for k, pat in self.match.items())

    def describe(self) -> str:
        args = [f"{k}={v}" for k, v in sorted(self.match.items())]
        if self.after:
            args.append(f"after={self.after}")
        if self.times != 1:
            args.append(f"times={self.times}")
        if self.value is not None:
            args.append(f"value={self.value}")
        return self.site + (f"({', '.join(args)})" if args else "")


def _parse_value(v: str):
    v = v.strip()
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def parse_spec(spec: str) -> List[Fault]:
    """Parse a ``REPRO_FAULTS``-style spec string into a fault plan."""
    plan: List[Fault] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        site, args = part, ""
        if "(" in part:
            if not part.endswith(")"):
                raise ValueError(f"malformed fault {part!r}: missing ')'")
            site, args = part[:-1].split("(", 1)
        site = site.strip()
        if not site:
            raise ValueError(f"malformed fault {part!r}: empty site")
        f = Fault(site=site)
        for kv in args.split(","):
            kv = kv.strip()
            if not kv:
                continue
            if "=" not in kv:
                raise ValueError(f"malformed fault arg {kv!r} in {part!r} "
                                 f"(expected k=v)")
            k, v = (s.strip() for s in kv.split("=", 1))
            if k == "times":
                f.times = int(v)
            elif k == "after":
                f.after = int(v)
            elif k == "value":
                f.value = _parse_value(v)
            else:
                f.match[k] = v
        plan.append(f)
    return plan


# ---------------------------------------------------------------------------
# activation: an inject() stack + the env plan
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_stack: List[List[Fault]] = []
_env_raw: Optional[str] = None
_env_plan: List[Fault] = []


def _env() -> List[Fault]:
    """The plan parsed from ``REPRO_FAULTS`` (re-parsed when it changes;
    firing counters persist for the lifetime of one env value)."""
    global _env_raw, _env_plan
    raw = os.environ.get(ENV_VAR) or None
    if raw != _env_raw:
        _env_raw = raw
        _env_plan = parse_spec(raw) if raw else []
    return _env_plan


def active() -> bool:
    """True when any fault plan (scoped or env) is in effect."""
    return bool(_stack) or bool(os.environ.get(ENV_VAR))


@contextlib.contextmanager
def inject(*faults: Union[str, Fault, Iterable[Fault]]):
    """Activate a fault plan for the dynamic extent of the ``with`` block.

    Arguments may be spec strings (parsed with :func:`parse_spec`),
    :class:`Fault` objects, or iterables of them; plans nest (all active
    plans are consulted, innermost first).  Yields the plan so callers can
    read ``fault.fired`` counts afterwards."""
    plan: List[Fault] = []
    for f in faults:
        if isinstance(f, str):
            plan.extend(parse_spec(f))
        elif isinstance(f, Fault):
            plan.append(f)
        else:
            plan.extend(f)
    with _lock:
        _stack.append(plan)
    try:
        yield plan
    finally:
        with _lock:
            _stack.remove(plan)


def should_fire(site: str, **ctx) -> Optional[Fault]:
    """The fault scheduled to fire at this occurrence of ``site``, or None.

    Deterministic: every call with a matching context advances the fault's
    occurrence counter, so a given call sequence always fires the same
    schedule.  Near-free when no plan is active."""
    if not _stack and not os.environ.get(ENV_VAR):
        return None
    with _lock:
        for plan in (*reversed(_stack), _env()):
            for f in plan:
                if f.site != site or not f.matches(ctx):
                    continue
                n = f.seen
                f.seen += 1
                if n < f.after:
                    continue
                if f.times >= 0 and n >= f.after + f.times:
                    continue
                f.fired += 1
                break
            else:
                continue
            break
        else:
            return None
    from repro_torch import obs
    obs.counter("faults.injected").inc()
    # the site ctx (req_id / req_ids / key / path) rides into the event so
    # traces and flight dumps attribute each firing to the request it hit
    obs.event("faults.injected", site=site, fault=f.describe(),
              **{k: str(v) for k, v in ctx.items()})
    return f


def raise_if(site: str, **ctx) -> None:
    """Raise :class:`InjectedFault` when a fault is scheduled here."""
    f = should_fire(site, **ctx)
    if f is not None:
        raise InjectedFault(f"injected fault at {site} "
                            f"({f.describe()}; occurrence {f.seen})")


# ---------------------------------------------------------------------------
# deterministic damage helpers (benches/tests corrupt state through these so
# "corruption" is one reproducible operation, not a hand-rolled mutation)
# ---------------------------------------------------------------------------

def corrupt_json_file(path: str, mode: str = "garbage") -> str:
    """Deterministically corrupt a JSON artefact file in place.

    ``garbage`` overwrites with non-JSON bytes; ``truncate`` drops the
    second half (syntactically broken); ``stale`` rewrites one top-level
    string value without refreshing the embedded checksum (semantically
    broken: valid JSON, failed integrity check).  Returns ``path``."""
    with open(path) as f:
        text = f.read()
    if mode == "garbage":
        out = "{ not json at all\x00"
    elif mode == "truncate":
        out = text[: len(text) // 2]
    elif mode == "stale":
        import json
        doc = json.loads(text)
        doc["version"] = "corrupted"
        out = json.dumps(doc)
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    with open(path, "w") as f:
        f.write(out)
    return path


def corrupt_pool(pool) -> str:
    """Deterministically damage a ``repro_torch.serve.paged.BlockPool`` so
    its ``validate()`` fails: double-book one block id (the bit-flip
    model).  Returns a description of the damage."""
    if pool._free:
        b = pool._free[-1]
        pool._free.append(b)
        return f"duplicated free block {b}"
    for owner, blocks in pool._owned.items():
        if blocks:
            pool._free.append(blocks[0])
            return f"freed block {blocks[0]} still owned by {owner}"
    pool._free.append(pool.n_blocks + 1)
    return "appended out-of-range block id"
