"""One human-readable system report: metrics + provenance + drift + recorder.

The port's copy of ``repro.obs.report``.

Two modes:

* **Live** — :func:`render` summarises the *current process* (the in-memory
  metrics registry, provenance log, drift auditor, and flight-recorder
  tail).  Engines and benches can print it at shutdown.

* **Artefact** — ``python -m repro_torch.obs.report`` renders previously
  exported files::

      python -m repro_torch.obs.report --metrics serve-metrics.json
      python -m repro_torch.obs.report --flight flight-dumps/   # dir or file
      python -m repro_torch.obs.report --trace trace.json --request r3
      python -m repro_torch.obs.report --history BENCH_history.json

  ``--request`` stitches the per-request timeline out of a Chrome trace:
  every span/instant whose args carry that ``req_id`` (or list it in
  ``req_ids``), ordered by timestamp — queue wait, TTFT, chunks, faults,
  retries, and the terminal state in one view.

Everything here is read-only rendering; the heavy imports are lazy so the
CLI works on artefacts without touching torch or the card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

__all__ = ["render", "render_metrics", "render_drift", "render_dump",
           "render_history", "request_timeline", "main"]


def _fmt(v: Optional[float]) -> str:
    if v is None:
        return "-"
    a = abs(v)
    if a != 0 and (a < 1e-3 or a >= 1e6):
        return f"{v:.3g}"
    return f"{v:.4g}"


# ---------------------------------------------------------------------------
# sections
# ---------------------------------------------------------------------------

def render_metrics(snap: Dict[str, dict], prefix: str = "") -> str:
    """Counters/gauges one per line; histograms with count/mean/p50/p95/p99."""
    names = [n for n in sorted(snap) if n.startswith(prefix)]
    if not names:
        return "metrics — none recorded"
    lines = [f"metrics — {len(names)} instruments"]
    w = max(len(n) for n in names)
    for n in names:
        m = snap[n]
        t = m.get("type")
        if t == "histogram":
            lines.append(
                f"  {n:<{w}}  n={m.get('count', 0):<6} "
                f"mean={_fmt(m.get('mean'))} p50={_fmt(m.get('p50'))} "
                f"p95={_fmt(m.get('p95'))} p99={_fmt(m.get('p99'))} "
                f"max={_fmt(m.get('max'))}")
        else:
            lines.append(f"  {n:<{w}}  {_fmt(m.get('value'))}")
    return "\n".join(lines)


def render_drift(doc: dict) -> str:
    """The drift auditor's snapshot() as a table of keys + findings."""
    keys = doc.get("keys") or {}
    ranking = doc.get("ranking") or {}
    if not keys and not ranking:
        return "drift audit — no observations"
    lines = [f"drift audit — {len(keys)} watched keys, "
             f"{doc.get('fired', 0)} fired "
             f"(tolerance {doc.get('tolerance')}x)"]
    for k in sorted(keys):
        st = keys[k]
        flag = " DRIFTED" if st.get("fired") else ""
        lines.append(f"  {k}: n={st.get('n')} "
                     f"drift={_fmt(st.get('drift_x'))}x{flag}")
    for k in sorted(ranking):
        f = ranking[k]
        lines.append(f"  {k}: MIS-RANKED — roofline prefers "
                     f"[{f.get('predicted_best')}] but "
                     f"[{f.get('measured_best')}] measured "
                     f"{_fmt(f.get('slowdown_x'))}x faster")
    return "\n".join(lines)


def render_dump(doc: dict) -> str:
    """One flight-recorder dump: reason, ctx, and the last ring entries."""
    ctx = doc.get("ctx") or {}
    ctx_s = " ".join(f"{k}={v}" for k, v in sorted(ctx.items()))
    events = doc.get("events") or []
    lines = [f"flight dump #{doc.get('seq', '?')} — "
             f"reason={doc.get('reason')}"
             + (f" ({ctx_s})" if ctx_s else "")
             + f" — {len(events)} ring entries"]
    for e in events[-20:]:
        kind = e.get("kind", "?")
        detail = ""
        if kind == "span":
            detail = f" dur={_fmt(e.get('dur_us'))}us"
            if e.get("error"):
                detail += f" error={e['error']}"
        elif kind == "metric":
            detail = f" +{_fmt(e.get('delta'))}"
        args = e.get("args") or {}
        if args:
            detail += " " + " ".join(f"{k}={v}"
                                     for k, v in sorted(args.items()))
        lines.append(f"  [{kind:<6}] {e.get('name')}{detail}")
    drift = doc.get("drift") or {}
    if drift.get("keys") or drift.get("ranking"):
        lines.append(render_drift(drift))
    return "\n".join(lines)


def render_history(entries: List[dict]) -> str:
    """The committed BENCH_history.json trajectory, one line per run."""
    if not entries:
        return "bench history — empty"
    lines = [f"bench history — {len(entries)} runs"]
    for e in entries:
        serve = e.get("serve") or {}
        faults = (e.get("resilience") or {}).get("faults_injected", "-")
        lines.append(
            f"  {e.get('t', '?')}: "
            f"fused={_fmt(serve.get('fused_tok_s'))} tok/s "
            f"continuous={_fmt(serve.get('continuous_tok_s'))} tok/s "
            f"recompiles={e.get('recompiles', '-')} "
            f"drift={e.get('drift', '-')} faults={faults}")
    return "\n".join(lines)


def request_timeline(events: List[dict], req_id: str) -> str:
    """Stitch one request's timeline from Chrome trace events: everything
    whose args carry ``req_id`` or list it in ``req_ids``."""
    mine = []
    for e in events:
        args = e.get("args") or {}
        rid = str(args.get("req_id", ""))
        rids = str(args.get("req_ids", ""))
        if rid == req_id or req_id in [r for r in rids.split(",") if r]:
            mine.append(e)
    if not mine:
        return f"request {req_id} — no events (was tracing enabled?)"
    mine.sort(key=lambda e: e.get("ts", 0.0))
    t0 = mine[0].get("ts", 0.0)
    lines = [f"request {req_id} — {len(mine)} events"]
    for e in mine:
        dt = (e.get("ts", 0.0) - t0) / 1e3            # us -> ms
        dur = f" ({e['dur'] / 1e3:.2f} ms)" if "dur" in e else ""
        args = e.get("args") or {}
        extra = " ".join(f"{k}={v}" for k, v in sorted(args.items())
                         if k not in ("req_id", "req_ids", "parent"))
        lines.append(f"  +{dt:9.2f} ms  {e.get('name')}{dur}"
                     + (f"  {extra}" if extra else ""))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# live mode
# ---------------------------------------------------------------------------

def render(tail: int = 12) -> str:
    """The current process: metrics, provenance, drift, recorder tail."""
    from . import audit, metrics, provenance, recorder
    parts = ["== repro_torch system report ==",
             render_metrics(metrics.snapshot()),
             provenance.log().explain(),
             render_drift(audit.auditor().snapshot())]
    entries = recorder.tail(tail)
    lines = [f"flight recorder — {len(recorder.recorder)} entries ringed, "
             f"{len(recorder.dumps())} dumps"]
    for e in entries:
        lines.append(f"  [{e.get('kind', '?'):<6}] {e.get('name')}")
    parts.append("\n".join(lines))
    return "\n\n".join(parts)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _load(path: str):
    with open(path) as f:
        return json.load(f)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render observability artefacts (or the live process) "
                    "as one human-readable report.")
    p.add_argument("--metrics", help="metrics snapshot JSON")
    p.add_argument("--flight", help="flight-recorder dump file, or a "
                                    "directory of flight-*.json dumps")
    p.add_argument("--trace", help="Chrome trace JSON (for --request)")
    p.add_argument("--request", help="render one request's timeline from "
                                     "--trace")
    p.add_argument("--history", help="BENCH_history.json trajectory")
    p.add_argument("--live", action="store_true",
                   help="render the current process state")
    args = p.parse_args(argv)

    out: List[str] = []
    if args.metrics:
        out.append(render_metrics(_load(args.metrics)))
    if args.flight:
        paths = [args.flight]
        if os.path.isdir(args.flight):
            paths = sorted(
                os.path.join(args.flight, n)
                for n in os.listdir(args.flight)
                if n.startswith("flight-") and n.endswith(".json"))
        if not paths:
            out.append(f"flight dumps — none under {args.flight}")
        for path in paths:
            out.append(render_dump(_load(path)))
    if args.request:
        if not args.trace:
            p.error("--request needs --trace")
        doc = _load(args.trace)
        out.append(request_timeline(doc.get("traceEvents", []),
                                    args.request))
    if args.history:
        out.append(render_history(_load(args.history)))
    if args.live or not out:
        out.append(render())
    print("\n\n".join(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
