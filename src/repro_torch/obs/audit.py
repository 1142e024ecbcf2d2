"""Drift audit: the cost model as a continuously validated component.

The port's copy of ``repro.obs.audit``.

**Ratio drift** (:meth:`DriftAuditor.observe`), ported whole: streaming
per-key statistics over ``log(measured / predicted)`` (or
``log(measured)`` when there is no prediction, e.g. per-chunk wall
times).  The audit is baseline-relative: the first ``min_samples``
observations establish the key's own baseline ratio, and only a later
shift beyond ``tolerance``x of that baseline fires.

**Ranking drift** (:meth:`DriftAuditor.audit_record`,
:meth:`DriftAuditor.audit_cache`) re-ranks a tuning-cache record's timed
candidates under the autotuner's cost model.  The port has no autotuner
yet (ROADMAP.md queue 1 item 3, strategy/ and autotune/), so both raise
``NotImplementedError`` naming it.

A firing emits a ``tune.drift`` event + counter, lands in the flight
recorder ring, and annotates the decision's provenance entry ``stale``
(origin suffix + note suggesting a re-tune) so ``obs.explain()`` shows it.
Each key fires once per process: drift is a state, not a
once-per-observation alarm.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional

from . import metrics, provenance, recorder

__all__ = ["DriftAuditor", "auditor", "observe", "audit_record",
           "audit_cache", "snapshot", "reset"]

_TINY = 1e-12

_NEEDS_AUTOTUNE = ("the ranking audit re-ranks candidates under the "
                   "autotuner's cost model, which is not ported yet "
                   "(ROADMAP.md queue 1 item 3, strategy/ and autotune/)")


class _KeyStats:
    """Welford accumulator over log-ratios, plus the baseline machinery."""
    __slots__ = ("n", "mean", "m2", "baseline", "fired", "last")

    def __init__(self):
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0
        self.baseline: Optional[float] = None
        self.fired = False
        self.last = 0.0

    def push(self, x: float) -> None:
        self.n += 1
        d = x - self.mean
        self.mean += d / self.n
        self.m2 += d * (x - self.mean)
        self.last = x

    @property
    def std(self) -> float:
        return math.sqrt(self.m2 / (self.n - 1)) if self.n > 1 else 0.0

    def to_doc(self) -> dict:
        return {"n": self.n, "mean_log": self.mean, "std_log": self.std,
                "baseline_log": self.baseline, "fired": self.fired,
                "drift_x": (math.exp(self.last - self.baseline)
                            if self.baseline is not None else None)}


class DriftAuditor:
    """Per-key drift statistics + the ``tune.drift`` firing policy."""

    def __init__(self, min_samples: int = 8, tolerance: float = 2.0):
        self.min_samples = min_samples
        self.tolerance = tolerance        # x-factor beyond baseline to fire
        self._stats: Dict[str, _KeyStats] = {}
        self._lock = threading.Lock()

    # -- ratio drift ---------------------------------------------------------

    def observe(self, key: str, measured_s: float,
                predicted_s: Optional[float] = None) -> Optional[float]:
        """Feed one measurement; returns the drift factor (measured vs the
        key's own baseline) once a baseline exists, else None.  Fires
        ``tune.drift`` (kind ``ratio``) the first time the factor leaves
        ``[1/tolerance, tolerance]``."""
        if measured_s <= 0:
            return None
        r = measured_s / predicted_s if predicted_s else measured_s
        x = math.log(max(r, _TINY))
        with self._lock:
            st = self._stats.get(key)
            if st is None:
                st = self._stats[key] = _KeyStats()
            st.push(x)
            if st.baseline is None:
                if st.n >= self.min_samples:
                    st.baseline = st.mean
                return None
            drift = math.exp(x - st.baseline)
            should_fire = (not st.fired
                           and (drift > self.tolerance
                                or drift < 1.0 / self.tolerance))
            if should_fire:
                st.fired = True
        if should_fire:
            self._fire("ratio", key, drift_x=round(drift, 3),
                       n=st.n, note=f"measured cost drifted {drift:.2f}x "
                                    f"from its baseline")
        return drift

    # -- ranking drift -------------------------------------------------------

    def audit_record(self, kernel: str, key: str, record: dict,
                     hw=None) -> Optional[dict]:
        """Re-rank a tuning-cache record's measured candidates under the
        cost model: needs the autotuner, which the port does not have
        yet."""
        raise NotImplementedError(_NEEDS_AUTOTUNE)

    def audit_cache(self, cache, hw=None) -> List[dict]:
        """:meth:`audit_record` over a tuning cache: needs the autotuner,
        which the port does not have yet."""
        raise NotImplementedError(_NEEDS_AUTOTUNE)

    # -- firing + export -----------------------------------------------------

    def _fire(self, kind: str, key: str, *, note: str, **detail) -> None:
        metrics.counter("tune.drift").inc()
        recorder.emit("tune.drift", kind=kind, key=key, **detail)
        # mark the provenance entry stale (suffix the origin once)
        dec = provenance.get(key)
        if dec is not None and not dec.origin.endswith("[stale]"):
            provenance.annotate(
                key, origin=dec.origin + "[stale]",
                note=(dec.note + "; " if dec.note else "")
                     + f"drift({kind}): {note} — consider re-tuning")

    def snapshot(self) -> dict:
        """JSON-able per-key stats + ranking findings (dump/report food)."""
        with self._lock:
            return {
                "tolerance": self.tolerance,
                "min_samples": self.min_samples,
                "keys": {k: st.to_doc() for k, st in self._stats.items()},
                "ranking": {},      # the ranking audit is not ported yet
                "fired": sum(1 for st in self._stats.values() if st.fired),
            }

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()


# ---------------------------------------------------------------------------
# module-level singleton + convenience API
# ---------------------------------------------------------------------------

_auditor: Optional[DriftAuditor] = None
_auditor_lock = threading.Lock()


def auditor() -> DriftAuditor:
    """The process-wide drift auditor."""
    global _auditor
    with _auditor_lock:
        if _auditor is None:
            _auditor = DriftAuditor()
        return _auditor


def observe(key: str, measured_s: float,
            predicted_s: Optional[float] = None) -> Optional[float]:
    return auditor().observe(key, measured_s, predicted_s)


def audit_record(kernel: str, key: str, record: dict, hw=None):
    return auditor().audit_record(kernel, key, record, hw=hw)


def audit_cache(cache, hw=None) -> List[dict]:
    return auditor().audit_cache(cache, hw=hw)


def snapshot() -> dict:
    return auditor().snapshot()


def reset() -> None:
    auditor().reset()
