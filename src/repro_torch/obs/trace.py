"""Span-based tracer with Chrome/Perfetto trace-event export.

The port's copy of ``repro.obs.trace`` (framework-neutral).

Design constraints, in priority order:

  1. **Near-zero overhead when disabled.**  ``span(...)`` returns a shared
     no-op context manager and ``@traced`` functions call straight through
     — the disabled cost is one attribute read and one ``if``.  Nothing is
     allocated, no generator frames, no locks.
  2. **Thread-safe when enabled.**  Each thread keeps its own span *stack*
     (``threading.local``) so nesting is per-thread; completed events are
     appended to one shared buffer under a lock (appends are rare — one per
     span exit, not per operation inside the span).
  3. **Standard output format.**  ``to_chrome()`` emits the Chrome
     trace-event JSON object form (``{"traceEvents": [...]}``) that
     ``chrome://tracing`` and https://ui.perfetto.dev load directly:
     complete events (``ph: "X"``) for spans, instant events (``ph: "i"``)
     for point events, microsecond timestamps relative to the trace epoch.

Spans nest lexically::

    with trace.span("serve.step_chunk", slots=4):
        with trace.span("serve.decode_chunk"):
            ...

and the exporter's ``X`` events reconstruct the hierarchy from the
timestamps; the explicit per-thread stack additionally gives each event its
parent's name (``args["parent"]``) so a flat JSON consumer can group
without interval math.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

__all__ = ["Tracer", "tracer", "span", "traced", "instant",
           "enable", "disable", "enabled", "events", "clear", "to_chrome",
           "export", "set_span_sink"]

# Optional tap on span completions (the flight recorder registers here).
# Only consulted from _record, i.e. when tracing is enabled — the disabled
# path stays one attribute read + one ``if``.
_span_sink = None


def set_span_sink(fn) -> None:
    """Register ``fn(name, dur_us, args, error)`` to observe every span
    completion while tracing is enabled; ``None`` unregisters."""
    global _span_sink
    _span_sink = fn


class _NullSpan:
    """The disabled-mode context manager: one shared instance, no state."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """A live span: records a complete ("ph": "X") event on exit."""
    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        self._tracer._stack().append(self.name)
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        stack = self._tracer._stack()
        stack.pop()
        self._tracer._record(self.name, self._t0, t1,
                             parent=stack[-1] if stack else None,
                             args=self.args,
                             error=exc_type.__name__ if exc_type else None)
        return False


class Tracer:
    """Process-wide event buffer + the enabled flag the hot paths read."""

    def __init__(self):
        self._enabled = False
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._epoch_ns = time.perf_counter_ns()
        self._pid = os.getpid()

    # -- state ---------------------------------------------------------------

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    @property
    def enabled(self) -> bool:
        return self._enabled

    def clear(self) -> None:
        with self._lock:
            self._events = []
            self._epoch_ns = time.perf_counter_ns()

    def _stack(self) -> List[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def depth(self) -> int:
        """Current span nesting depth on the calling thread."""
        return len(self._stack())

    # -- recording -----------------------------------------------------------

    def span(self, name: str, **args):
        """Context manager timing a region; a shared no-op when disabled."""
        if not self._enabled:
            return _NULL_SPAN
        return _Span(self, name, args or None)

    def instant(self, name: str, **args) -> None:
        """A point event ("ph": "i"); dropped (one if) when disabled."""
        if not self._enabled:
            return
        t = time.perf_counter_ns()
        ev = {"name": name, "ph": "i", "s": "t",
              "ts": (t - self._epoch_ns) / 1e3,
              "pid": self._pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = _jsonable(args)
        with self._lock:
            self._events.append(ev)

    def _record(self, name: str, t0_ns: int, t1_ns: int, *,
                parent: Optional[str], args: Optional[dict],
                error: Optional[str]) -> None:
        ev = {"name": name, "ph": "X",
              "ts": (t0_ns - self._epoch_ns) / 1e3,
              "dur": (t1_ns - t0_ns) / 1e3,
              "pid": self._pid, "tid": threading.get_ident()}
        extra = dict(args) if args else {}
        if parent is not None:
            extra["parent"] = parent
        if error is not None:
            extra["error"] = error
        if extra:
            ev["args"] = _jsonable(extra)
        with self._lock:
            self._events.append(ev)
        if _span_sink is not None:
            _span_sink(name, ev["dur"], args, error)

    # -- export --------------------------------------------------------------

    def events(self) -> List[dict]:
        """Snapshot of the recorded events (copies; safe to mutate)."""
        with self._lock:
            return [dict(e) for e in self._events]

    def to_chrome(self) -> Dict[str, object]:
        """The Chrome trace-event JSON document (Perfetto-loadable)."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Write the Chrome trace JSON to ``path`` (atomic tmp + rename)."""
        doc = self.to_chrome()
        d = os.path.dirname(path) or "."
        os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


def _jsonable(d: dict) -> dict:
    """Coerce span args to JSON-safe scalars (repr anything exotic) so a
    stray array/object in an arg can never make the export unloadable."""
    out = {}
    for k, v in d.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        elif isinstance(v, (list, tuple)):
            out[k] = [x if isinstance(x, (str, int, float, bool)) or x is None
                      else repr(x) for x in v]
        elif isinstance(v, dict):
            out[k] = _jsonable(v)
        else:
            out[k] = repr(v)
    return out


# ---------------------------------------------------------------------------
# module-level singleton + convenience API
# ---------------------------------------------------------------------------

tracer = Tracer()

span = tracer.span
instant = tracer.instant
enable = tracer.enable
disable = tracer.disable
events = tracer.events
clear = tracer.clear
to_chrome = tracer.to_chrome
export = tracer.export


def enabled() -> bool:
    return tracer._enabled


def traced(name: Optional[str] = None, **attrs):
    """Decorator: wrap calls in a span.  Disabled mode calls straight
    through — one attribute read + one ``if`` of overhead."""
    def deco(fn):
        label = name or fn.__qualname__
        import functools

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not tracer._enabled:
                return fn(*a, **kw)
            with tracer.span(label, **attrs):
                return fn(*a, **kw)
        return wrapper
    return deco


# $REPRO_TRACE=1 enables tracing at import; a path value ("…/trace.json")
# additionally registers an atexit export so ad-hoc runs need no code
_env = os.environ.get("REPRO_TRACE", "")
if _env and _env.lower() not in ("0", "false", "no", "off"):
    tracer.enable()
    if _env.lower() not in ("1", "true", "yes", "on"):
        import atexit
        atexit.register(lambda: tracer.export(_env))
