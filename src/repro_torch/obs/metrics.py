"""Process-wide metrics registry: counters, gauges, histograms.

The port's copy of ``repro.obs.metrics`` (framework-neutral).

The registry is always on — unlike tracing there is no enable switch,
because every instrument is a couple of float ops under a per-instrument
lock and the serving spine only touches them at *boundaries* (per chunk,
per admission, per retire), never per token or per scan step.  That keeps
the disabled-tracing serving path within its <2% overhead budget while the
numbers (TTFT, decode tok/s, pool occupancy, recompile counts) are always
available to ``snapshot()`` without a special run.

Instruments:

  * :class:`Counter` — monotonically increasing float (``inc``);
  * :class:`Gauge` — last-write-wins value (``set``/``inc``);
  * :class:`Histogram` — streaming count/total/min/max plus base-2
    magnitude buckets, enough for the serving latency distributions
    without storing samples.

``snapshot()`` returns plain dicts (JSON-able as-is); ``reset()`` zeroes
every instrument but keeps them registered, so long-lived processes can
take per-interval readings.
"""
from __future__ import annotations

import json
import math
import os
import threading
from typing import Dict, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
           "counter", "gauge", "histogram", "snapshot", "reset", "export",
           "set_delta_sink"]

# Optional tap on counter increments (the flight recorder registers here so
# metric deltas land in its ring).  One global read + ``if`` per inc() —
# and increments only happen at boundaries, never in a hot loop.
_delta_sink = None


def set_delta_sink(fn) -> None:
    """Register ``fn(name, delta)`` to observe every counter increment;
    ``None`` unregisters."""
    global _delta_sink
    _delta_sink = fn


class Counter:
    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n
        if _delta_sink is not None:
            _delta_sink(self.name, n)

    @property
    def value(self) -> float:
        return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0.0

    def _snap(self) -> dict:
        return {"type": "counter", "value": self._value}


class Gauge:
    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0.0

    def _snap(self) -> dict:
        return {"type": "gauge", "value": self._value}


class Histogram:
    """Streaming summary + base-2 magnitude buckets.

    The bucket for observation ``v > 0`` is ``floor(log2(v))``; zero and
    negative values land in a dedicated underflow bucket.  That is coarse
    but monotone and unbounded — latencies from nanoseconds to minutes all
    bucket meaningfully with no a-priori range choice."""
    __slots__ = ("name", "_count", "_total", "_min", "_max", "_buckets",
                 "_lock")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._zero()

    def _zero(self) -> None:
        self._count = 0
        self._total = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._buckets: Dict[int, int] = {}

    def observe(self, v: float) -> None:
        v = float(v)
        b = math.floor(math.log2(v)) if v > 0 else -1024
        with self._lock:
            self._count += 1
            self._total += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            self._buckets[b] = self._buckets.get(b, 0) + 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def mean(self) -> float:
        return self._total / self._count if self._count else 0.0

    def _reset(self) -> None:
        with self._lock:
            self._zero()

    def percentile(self, q: float) -> Optional[float]:
        """Estimate the ``q``-quantile (``0 < q <= 1``) by linear
        interpolation inside the base-2 bucket holding it, clamped to the
        observed min/max (so single-value and edge buckets are exact).
        None when nothing has been observed."""
        with self._lock:
            return self._percentiles((q,))[0]

    def _percentiles(self, qs):
        """Quantile estimates for each q in ``qs``; call with lock held."""
        if not self._count:
            return [None] * len(qs)
        items = sorted(self._buckets.items())
        out = []
        for q in qs:
            target = q * self._count
            cum = 0
            val = self._max
            for k, n in items:
                if cum + n >= target:
                    # bucket k spans [2^k, 2^(k+1)); underflow bucket is 0
                    lo = 0.0 if k == -1024 else float(2.0 ** k)
                    hi = 0.0 if k == -1024 else float(2.0 ** (k + 1))
                    val = lo + (target - cum) / n * (hi - lo)
                    break
                cum += n
            out.append(min(max(val, self._min), self._max))
        return out

    def _snap(self) -> dict:
        with self._lock:
            p50, p95, p99 = self._percentiles((0.5, 0.95, 0.99))
            return {
                "type": "histogram", "count": self._count,
                "total": self._total,
                "mean": self._total / self._count if self._count else 0.0,
                "min": self._min if self._count else None,
                "max": self._max if self._count else None,
                "p50": p50, "p95": p95, "p99": p99,
                "buckets": {f"2^{k}" if k != -1024 else "<=0": v
                            for k, v in sorted(self._buckets.items())},
            }


class MetricsRegistry:
    """Name -> instrument, created on first use; type mismatches raise."""

    _TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {cls.__name__}")
            return m
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def names(self):
        return sorted(self._metrics)

    def snapshot(self) -> Dict[str, dict]:
        """{name: {"type": ..., ...}} for every registered instrument."""
        with self._lock:
            items = list(self._metrics.items())
        return {name: m._snap() for name, m in sorted(items)}

    def reset(self) -> None:
        """Zero every instrument (registrations survive)."""
        with self._lock:
            items = list(self._metrics.values())
        for m in items:
            m._reset()

    def export(self, path: str) -> str:
        """Write ``snapshot()`` as JSON to ``path`` (atomic tmp+rename)."""
        d = os.path.dirname(path) or "."
        os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path


_registry: Optional[MetricsRegistry] = None
_registry_lock = threading.Lock()


def registry() -> MetricsRegistry:
    """The process-wide registry the serving/compiler spine writes to."""
    global _registry
    with _registry_lock:
        if _registry is None:
            _registry = MetricsRegistry()
        return _registry


def counter(name: str) -> Counter:
    return registry().counter(name)


def gauge(name: str) -> Gauge:
    return registry().gauge(name)


def histogram(name: str) -> Histogram:
    return registry().histogram(name)


def snapshot() -> Dict[str, dict]:
    return registry().snapshot()


def reset() -> None:
    registry().reset()


def export(path: str) -> str:
    return registry().export(path)
