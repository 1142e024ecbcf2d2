"""Always-on flight recorder: the resilience layer's black box.

The port's copy of ``repro.obs.recorder``.

A bounded ring buffer (``collections.deque(maxlen=...)`` — appends are
atomic under CPython, so the steady-state cost is one deque append and a
couple of dict builds per *boundary* event, never per token) that passively
accumulates the most recent

  * point events (everything routed through ``obs.event``, enabled or not),
  * completed spans (tapped from the tracer when tracing is enabled),
  * counter deltas (tapped from the metrics registry),

so that when something goes wrong — a request reaches a ``failed`` /
``timeout`` terminal state, the degradation ladder fires, an artefact is
quarantined, or an unhandled exception escapes the serving step — the
process can :func:`dump` everything it saw in the moments before into one
JSON artefact::

    {"version": 1, "reason": "request_failed", "ctx": {...},
     "events": [...recent ring entries...],
     "metrics": {...snapshot...}, "provenance": [...recent decisions...],
     "drift": {...per-key drift stats...}}

Dumps always land in a bounded in-memory list (:func:`dumps`); when a
directory is configured (:func:`configure` or ``$REPRO_FLIGHT_DIR``) each
dump is also written to ``flight-<seq>-<reason>.json`` there (and nowhere
else: with no directory configured nothing is written to disk).

Unlike tracing there is no enable switch: like the metrics registry, the
recorder only runs at boundaries and its ring is bounded, so it is safe to
leave on in production — that is the point of a flight recorder.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Deque, Dict, List, Optional

from . import metrics, trace

__all__ = ["FlightRecorder", "recorder", "record", "emit", "dump", "dumps",
           "tail", "clear", "configure", "dump_dir"]

_DEFAULT_CAPACITY = 512
_DUMP_KEEP = 32          # in-memory dumps retained (bounded, like the ring)
_PROV_KEEP = 16          # most recent provenance decisions per dump


class FlightRecorder:
    """Bounded ring of recent observability entries + the dump machinery."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY,
                 dir: Optional[str] = None):
        self._ring: Deque[dict] = collections.deque(maxlen=capacity)
        self._dumps: Deque[dict] = collections.deque(maxlen=_DUMP_KEEP)
        self._paths: List[str] = []
        self._dir = dir
        self._seq = 0
        self._lock = threading.Lock()   # guards dumps/seq, not ring appends

    # -- recording (hot-ish: boundary events only) ---------------------------

    def record(self, entry_kind: str, name: str, **args) -> None:
        """Append one entry to the ring.  ``entry_kind`` is ``event`` /
        ``span`` / ``metric``; args are coerced JSON-safe so a dump can
        never fail.  (Positional-style name so event payloads may carry a
        ``kind`` arg of their own.)"""
        e: Dict[str, object] = {"t": time.time(), "kind": entry_kind,
                                "name": name}
        if args:
            e["args"] = trace._jsonable(args)
        self._ring.append(e)

    def _on_span(self, name: str, dur_us: float, args: Optional[dict],
                 error: Optional[str]) -> None:
        """Span sink: called by the tracer on span exit (enabled mode)."""
        e: Dict[str, object] = {"t": time.time(), "kind": "span",
                                "name": name, "dur_us": dur_us}
        if args:
            e["args"] = trace._jsonable(args)
        if error is not None:
            e["error"] = error
        self._ring.append(e)

    def _on_delta(self, name: str, delta: float) -> None:
        """Counter-delta sink: called by the metrics registry on inc()."""
        self._ring.append({"t": time.time(), "kind": "metric",
                           "name": name, "delta": delta})

    # -- inspection ----------------------------------------------------------

    def tail(self, n: Optional[int] = None) -> List[dict]:
        """The most recent ``n`` ring entries (all when ``n`` is None)."""
        entries = list(self._ring)
        return entries if n is None else entries[-n:]

    def __len__(self) -> int:
        return len(self._ring)

    def clear(self) -> None:
        self._ring.clear()
        with self._lock:
            self._dumps.clear()
            self._paths = []
            self._seq = 0

    # -- configuration -------------------------------------------------------

    def configure(self, dir: Optional[str] = None,
                  capacity: Optional[int] = None) -> None:
        """Set the dump directory (None keeps dumps in-memory only) and/or
        resize the ring (existing tail entries are preserved)."""
        with self._lock:
            self._dir = dir
        if capacity is not None and capacity != self._ring.maxlen:
            self._ring = collections.deque(self.tail(capacity),
                                           maxlen=capacity)

    @property
    def dir(self) -> Optional[str]:
        return self._dir

    # -- the black box -------------------------------------------------------

    def dump(self, reason: str, **ctx) -> dict:
        """Snapshot everything the process saw recently into one document;
        returns it, keeps it in memory, and writes it to the configured
        directory (atomic tmp+rename) when one is set."""
        doc = {
            "version": 1,
            "reason": reason,
            "ctx": trace._jsonable(ctx) if ctx else {},
            "t_wall": time.time(),
            "events": self.tail(),
            "metrics": metrics.snapshot(),
            "provenance": _recent_decisions(),
            "drift": _drift_snapshot(),
        }
        with self._lock:
            self._seq += 1
            doc["seq"] = self._seq
            self._dumps.append(doc)
            d = self._dir
        metrics.counter("obs.flight_dumps").inc()
        trace.instant("obs.flight_dump", reason=reason, seq=doc["seq"],
                      **(ctx or {}))
        if d:
            safe = "".join(c if c.isalnum() or c in "-_." else "_"
                           for c in reason)[:48]
            path = os.path.join(d, f"flight-{doc['seq']:04d}-{safe}.json")
            try:
                os.makedirs(d, exist_ok=True)
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(doc, f, indent=1, sort_keys=True)
                os.replace(tmp, path)
                with self._lock:
                    self._paths.append(path)
            except OSError:        # a full disk must never crash serving
                pass
        return doc

    def dumps(self) -> List[dict]:
        """The retained in-memory dumps, oldest first."""
        with self._lock:
            return list(self._dumps)

    def dump_paths(self) -> List[str]:
        with self._lock:
            return list(self._paths)


def _recent_decisions() -> List[dict]:
    from . import provenance
    ds = provenance.decisions()
    return [d.to_doc() for d in ds[-_PROV_KEEP:]]


def _drift_snapshot() -> dict:
    """Drift stats when the audit module is loaded (lazy: audit imports
    this module, so the dependency must stay one-directional at import)."""
    import sys
    mod = sys.modules.get("repro_torch.obs.audit")
    if mod is None:
        return {}
    try:
        return mod.auditor().snapshot()
    except Exception:
        return {}


# ---------------------------------------------------------------------------
# module-level singleton + convenience API
# ---------------------------------------------------------------------------

recorder = FlightRecorder()

record = recorder.record
dump = recorder.dump
dumps = recorder.dumps
tail = recorder.tail
configure = recorder.configure


def clear() -> None:
    recorder.clear()


def dump_dir() -> Optional[str]:
    return recorder.dir


def emit(name: str, **args) -> None:
    """``obs.event``: feed the flight-recorder ring *always* and the span
    tracer's instant stream when tracing is enabled."""
    recorder.record("event", name, **args)
    trace.instant(name, **args)


# wire the taps: span completions (tracing-enabled only) and counter deltas
trace.set_span_sink(recorder._on_span)
metrics.set_delta_sink(recorder._on_delta)

# $REPRO_FLIGHT_DIR: write dump artefacts there without code changes
_env = os.environ.get("REPRO_FLIGHT_DIR", "")
if _env:
    recorder.configure(dir=_env)
