"""Strategy provenance: who picked what, from which inputs, and why.

The port's copy of ``repro.obs.provenance``.  The pipeline's claim is that
strategy decisions (kernel rewrite params, serving KV layout) are
*preserved* end to end.  This module makes each decision a record instead
of a side effect: the op layer (:mod:`repro_torch.kernels.ops`) and the
AOT loader (:mod:`repro_torch.compiler.executors`) ``record()`` here, and
``explain()`` renders the log as a human-readable "why did the compiler
pick this" report::

    from repro_torch import obs
    print(obs.explain())

Each :class:`Decision` carries the decision *inputs* (kernel, shape, dtype,
backend, mesh descriptor, KV layout), the chosen params, the predicted
cost terms and measured time where a tuner supplied them, and the
**origin**:

    analytic          ranked by the cost model (``autotune.tune``,
                      ``measure=False``)
    measured          timed on the device (``measure=True``)
    cache(<source>)   served from the persistent tuning cache
    default           the kernel's canonical default params (autotune off
                      in the options, or no tuned entry)
    aot-loaded        an executor rebuilt from the AOT program store

The reference's ``degraded(a->b)`` arrives with the resilience slice
(ROADMAP.md queue 1 item 4).

Recording is always on (it happens when the op layer stages an executor,
once per executor key, never on a hot call path) and keyed by the
canonical executor key, so one decision per (kernel, shape, dtype,
backend, mesh, layout) is retained with the latest origin.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

__all__ = ["Decision", "ProvenanceLog", "log", "record", "decisions",
           "get", "annotate", "clear", "explain"]


@dataclasses.dataclass(frozen=True)
class Decision:
    """One tuned choice, with everything needed to audit it."""
    kind: str                       # "kernel" | "mesh" | "kv_layout" | ...
    kernel: str
    key: str                        # the canonical tuning/executor cache key
    params: Dict[str, object]
    origin: str                     # see module docstring
    shape: Dict[str, object] = dataclasses.field(default_factory=dict)
    dtype: str = "float32"
    backend: str = "jnp"
    mesh: str = "single"
    layout: str = "dense"
    cost_s: Optional[float] = None        # predicted roofline seconds
    terms: Dict[str, float] = dataclasses.field(default_factory=dict)
    measured_us: Optional[float] = None
    n_candidates: int = 0
    note: str = ""
    strategy_trace: Optional[dict] = None  # serialised StrategyTrace doc
    t_wall: float = dataclasses.field(default_factory=time.time)

    def to_doc(self) -> dict:
        d = dataclasses.asdict(self)
        d["params"] = {k: _plain(v) for k, v in self.params.items()}
        return d

    def describe(self) -> str:
        shape_s = ",".join(f"{k}={v}" for k, v in sorted(self.shape.items()))
        params_s = ", ".join(f"{k}={v}" for k, v in
                             sorted(self.params.items())) or "(defaults)"
        lines = [f"[{self.kind}] {self.kernel} {shape_s} dtype={self.dtype} "
                 f"backend={self.backend} mesh={self.mesh} "
                 f"layout={self.layout}",
                 f"    picked {params_s}",
                 f"    origin {self.origin}"
                 + (f" over {self.n_candidates} candidates"
                    if self.n_candidates else "")]
        why = []
        if self.cost_s is not None:
            why.append(f"predicted {self.cost_s:.3g} s")
        if self.terms:
            why.append("roofline " + " ".join(
                f"{k}={v:.3g}" for k, v in sorted(self.terms.items()) if v))
        if self.measured_us is not None:
            why.append(f"measured {self.measured_us:.1f} us")
        if why:
            lines.append("    " + "; ".join(why))
        if self.strategy_trace and self.strategy_trace.get("steps"):
            lines.append("    derived by " + _trace_str(self.strategy_trace))
        if self.note:
            lines.append(f"    note: {self.note}")
        return "\n".join(lines)


def _trace_str(doc: dict) -> str:
    """Render a serialised StrategyTrace (lazy import: repro_torch.strategy
    is a consumer of obs, so the dependency must not run at module load)."""
    try:
        from repro_torch.strategy.lang import StrategyTrace
        return StrategyTrace.from_doc(doc).describe()
    except Exception:
        return " ; ".join(str(s.get("rule", "?"))
                          for s in doc.get("steps", ()))


def _plain(v):
    return v if isinstance(v, (str, int, float, bool)) or v is None else repr(v)


class ProvenanceLog:
    """Keyed store of the latest Decision per cache key, insert-ordered."""

    def __init__(self):
        self._decisions: Dict[str, Decision] = {}
        self._lock = threading.Lock()

    def record(self, d: Decision) -> None:
        with self._lock:
            self._decisions[d.key] = d

    def get(self, key: str) -> Optional[Decision]:
        return self._decisions.get(key)

    def annotate(self, key: str, **changes) -> Optional[Decision]:
        """Replace fields on the decision recorded under ``key`` (Decisions
        are frozen, so this installs a modified copy).  The drift audit uses
        it to mark entries ``stale``.  Returns the new Decision, or None
        when nothing is recorded under ``key``."""
        with self._lock:
            d = self._decisions.get(key)
            if d is None:
                return None
            d2 = dataclasses.replace(d, **changes)
            self._decisions[key] = d2
            return d2

    def decisions(self, kind: Optional[str] = None) -> List[Decision]:
        with self._lock:
            ds = list(self._decisions.values())
        if kind is not None:
            ds = [d for d in ds if d.kind == kind]
        return ds

    def clear(self) -> None:
        with self._lock:
            self._decisions.clear()

    def __len__(self) -> int:
        return len(self._decisions)

    def explain(self, key: Optional[str] = None,
                kind: Optional[str] = None) -> str:
        """The human-readable strategy report.

        ``key`` narrows to one decision (substring match on the cache key,
        so ``explain("matmul")`` works); ``kind`` filters by decision kind.
        """
        ds = self.decisions(kind)
        if key is not None:
            ds = [d for d in ds if key in d.key]
        if not ds:
            return ("strategy provenance — no decisions recorded"
                    + (f" matching {key!r}" if key else "")
                    + "\n(run a DPIA op through repro_torch.kernels.ops "
                      "first)")
        by_origin: Dict[str, int] = {}
        for d in ds:
            by_origin[d.origin] = by_origin.get(d.origin, 0) + 1
        head = (f"strategy provenance — {len(ds)} decision"
                f"{'s' if len(ds) != 1 else ''} ("
                + ", ".join(f"{n} {o}" for o, n in sorted(by_origin.items()))
                + ")")
        return "\n".join([head] + [d.describe() for d in ds])


_log: Optional[ProvenanceLog] = None
_log_lock = threading.Lock()


def log() -> ProvenanceLog:
    """The process-wide provenance log."""
    global _log
    with _log_lock:
        if _log is None:
            _log = ProvenanceLog()
        return _log


def record(kind: str, kernel: str, key: str, params: Dict[str, object],
           origin: str, **kw) -> Decision:
    """Build + record a Decision in the process log; returns it."""
    d = Decision(kind=kind, kernel=kernel, key=key,
                 params=dict(params or {}), origin=origin, **kw)
    log().record(d)
    return d


def decisions(kind: Optional[str] = None) -> List[Decision]:
    return log().decisions(kind)


def get(key: str) -> Optional[Decision]:
    return log().get(key)


def annotate(key: str, **changes) -> Optional[Decision]:
    return log().annotate(key, **changes)


def clear() -> None:
    log().clear()


def explain(key: Optional[str] = None, kind: Optional[str] = None) -> str:
    return log().explain(key, kind)
