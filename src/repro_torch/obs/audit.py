"""Drift audit: the cost model as a continuously validated component.

The port's copy of ``repro.obs.audit``.

**Ratio drift** (:meth:`DriftAuditor.observe`), ported whole: streaming
per-key statistics over ``log(measured / predicted)`` (or
``log(measured)`` when there is no prediction, e.g. per-chunk wall
times).  The audit is baseline-relative: the first ``min_samples``
observations establish the key's own baseline ratio, and only a later
shift beyond ``tolerance``x of that baseline fires.

**Ranking drift** (:meth:`DriftAuditor.audit_record`): for tuning-cache
records that carry measured ``timings`` per candidate, rebuild each
candidate (``space.candidate_from_params``), re-rank analytically under
the current ``HwModel``, and compare the predicted argmin against the
measured argmin.  Disagreement means the model would pick the wrong
strategy today.

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
        self._rank_fired: Dict[str, dict] = {}
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
        """Re-rank a tuning-cache record's measured candidates analytically;
        fire ``tune.drift`` (kind ``ranking``) when the roofline's best is
        not the measured best.  Returns a finding dict, or None when the
        record has fewer than two timed candidates (nothing to mis-rank)."""
        timings = record.get("timings") or {}
        if len(timings) < 2:
            return None
        from repro_torch.autotune import cost as cost_mod
        from repro_torch.autotune import space as space_mod
        if hw is None:
            hw = cost_mod.hw_model()
        shape = {k: v for k, v in (record.get("shape") or {}).items()}
        predicted: Dict[str, float] = {}
        for pk in timings:
            try:
                cand = space_mod.candidate_from_params(
                    kernel, _parse_params_key(pk), **shape)
                expr, _ = cand.build()
                predicted[pk] = cost_mod.predicted_seconds(expr, hw)
            except Exception:
                predicted[pk] = float("inf")
        if all(math.isinf(s) for s in predicted.values()):
            return None
        meas_best = min(timings, key=lambda pk: (timings[pk], pk))
        pred_best = min(predicted, key=lambda pk: (predicted[pk], pk))
        agree = meas_best == pred_best
        # how much slower the model's pick actually ran, measured
        slowdown = timings[pred_best] / max(timings[meas_best], _TINY)
        finding = {"key": key, "kernel": kernel, "agree": agree,
                   "measured_best": meas_best, "predicted_best": pred_best,
                   "slowdown_x": round(slowdown, 3),
                   "n_candidates": len(timings)}
        if not agree:
            with self._lock:
                first = key not in self._rank_fired
                self._rank_fired[key] = finding
            if first:
                self._fire("ranking", key, kernel=kernel,
                           predicted_best=pred_best,
                           measured_best=meas_best,
                           slowdown_x=finding["slowdown_x"],
                           note=f"roofline prefers [{pred_best}] but "
                                f"[{meas_best}] measured "
                                f"{slowdown:.2f}x faster")
        return finding

    def audit_cache(self, cache, hw=None) -> List[dict]:
        """Run :meth:`audit_record` over every record in a TuningCache that
        carries timings; returns the findings (agreeing ones included)."""
        findings = []
        for key in cache.keys():
            rec = cache.get(key)
            if not rec:
                continue
            kernel = rec.get("kernel") or key.split("|", 1)[0]
            f = self.audit_record(kernel, key, rec, hw=hw)
            if f is not None:
                findings.append(f)
        return findings

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
                "ranking": {k: dict(f) for k, f in self._rank_fired.items()},
                "fired": sum(1 for st in self._stats.values() if st.fired)
                + len(self._rank_fired),
            }

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()
            self._rank_fired.clear()


def _parse_params_key(pk: str) -> Dict[str, object]:
    """Invert ``space.params_key``: ``"bk=128,bm=64"`` -> typed dict."""
    params: Dict[str, object] = {}
    if not pk:
        return params
    for part in pk.split(","):
        k, _, v = part.partition("=")
        params[k] = _coerce(v)
    return params


def _coerce(v: str):
    if v == "None":
        return None
    if v == "True":
        return True
    if v == "False":
        return False
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


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
