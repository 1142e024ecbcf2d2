"""repro_torch.obs: tracing, metrics, provenance, flight recorder, drift
audit.

The port's copy of ``repro.obs`` (framework-neutral, the same public
names).  The engines' invariants ("the same tokens, zero re-captures after
warm-up") are asserted by tests; this package makes them *observable* in
any run:

  trace       span tracer (thread-local stacks, monotonic host clocks,
              near-zero overhead disabled) with Chrome/Perfetto JSON
              export: ``obs.enable()``, ``with obs.span("name"): ...``,
              ``obs.export_trace("trace.json")``, load in
              https://ui.perfetto.dev
  metrics     always-on process registry of counters / gauges /
              histograms (with interpolated p50/p95/p99 in every
              snapshot): ``obs.counter("x").inc()``,
              ``obs.metrics_snapshot()``
  provenance  a record per strategy decision (kernel strategy, KV
              layout): inputs, params, origin (``analytic``,
              ``measured``, ``cache(...)``, ``default``, ``aot-loaded``):
              ``print(obs.explain())``
  recorder    always-on flight recorder: a bounded ring of recent
              boundary events / spans / counter deltas, dumped as one JSON
              black box when an artefact is quarantined (and, with the
              resilience slice, when a request fails):
              ``obs.flight_dump`` / ``obs.flight_dumps``
  audit       drift audit: baseline-relative per-key cost statistics
              that fire ``tune.drift`` (``obs.drift_observe``), and the
              ranking audit (``obs.audit_cache``): the cost model's order
              of a tuning record's candidates against their measured
              order
  report      one human-readable rendering of all of the above:
              ``python -m repro_torch.obs.report``

The instrumented spine: ``Program.check/lower/compile`` spans, executor
cache build / hit / AOT events, serving per-chunk spans, request-scoped
lifecycle events (submit / admit / first_token / retire carry ``req_id``;
decode chunks carry the co-batched ``req_ids``), per-request latency
histograms (queue wait, TTFT, decode tok/s), KV pool occupancy gauges,
and a detector that flags CUDA-graph re-captures after engine warm-up.
``Engine.stats()`` is the one-call summary.

Every clock here is the host's (``time.perf_counter``): a span around
work that ends in a host sync times the device's work, a span around an
enqueue times the enqueue.  Nothing here synchronises the device.

Tracing defaults off; enable programmatically or with ``REPRO_TRACE=1``
(a path value also exports at exit).  Metrics, provenance, the recorder,
and the audit are always on: they only run at boundaries (staging, chunk
edges), never in a hot loop.  ``REPRO_FLIGHT_DIR`` makes the recorder
write its dumps as ``flight-*.json`` artefacts.
"""
from __future__ import annotations

from . import metrics, provenance, trace  # noqa: F401
from . import audit, recorder, report  # noqa: F401  (after the base trio)
from .audit import audit_cache, audit_record, auditor  # noqa: F401
from .audit import observe as drift_observe  # noqa: F401
from .provenance import annotate  # noqa: F401
from .recorder import FlightRecorder  # noqa: F401
from .recorder import clear as flight_clear  # noqa: F401
from .recorder import configure as configure_flight  # noqa: F401
from .recorder import dump as flight_dump  # noqa: F401
from .recorder import dumps as flight_dumps  # noqa: F401
from .recorder import tail as flight_tail  # noqa: F401
from .metrics import (  # noqa: F401
    MetricsRegistry, counter, gauge, histogram, registry,
)
from .metrics import export as export_metrics  # noqa: F401
from .metrics import reset as metrics_reset  # noqa: F401
from .metrics import snapshot as metrics_snapshot  # noqa: F401
from .provenance import (  # noqa: F401
    Decision, ProvenanceLog, decisions, explain, record,
)
from .provenance import clear as clear_decisions  # noqa: F401
from .provenance import log as provenance_log  # noqa: F401
from .trace import (  # noqa: F401
    Tracer, disable, enable, enabled, instant, span, to_chrome, traced,
    tracer,
)
from .trace import clear as clear_trace  # noqa: F401
from .trace import events as trace_events  # noqa: F401
from .trace import export as export_trace  # noqa: F401

# ``event`` is the structured point event: always lands in the flight
# recorder's ring, additionally in the trace when tracing is enabled
from .recorder import emit as event  # noqa: F401, E402

__all__ = [
    # tracing
    "Tracer", "tracer", "enable", "disable", "enabled", "span", "traced",
    "instant", "event", "trace_events", "clear_trace", "to_chrome",
    "export_trace",
    # metrics
    "MetricsRegistry", "registry", "counter", "gauge", "histogram",
    "metrics_snapshot", "metrics_reset", "export_metrics",
    # provenance
    "Decision", "ProvenanceLog", "record", "decisions", "explain",
    "annotate", "clear_decisions", "provenance_log",
    # flight recorder
    "FlightRecorder", "flight_dump", "flight_dumps", "flight_tail",
    "flight_clear", "configure_flight",
    # drift audit
    "auditor", "drift_observe", "audit_record", "audit_cache",
    "metrics", "provenance", "trace", "recorder", "audit", "report",
]
