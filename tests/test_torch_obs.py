"""The port's observability and fault-tolerance substrate on the CPU:
repro_torch.obs (trace, metrics, provenance, recorder, audit, report),
repro_torch.ft.artefacts and repro_torch.testing.faults, and the serving
spine's spans, events and counters.

The substrate cases mirror tests/test_obs.py and tests/test_resilience.py
where they need no JAX engine; where both packages compute the same
document (a metrics snapshot, a rendered report, a parsed fault plan) the
two are held equal.  The scheduler's observability is held against the
reference's ContinuousEngine on one tiny continuous run (smoke qwen3-4b,
2 layers, fp32, paged with a starved pool so admissions defer): the same
tokens, the same lifecycle events per ``req_id`` in order, and the same
counters."""
import dataclasses
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compiler as jcompiler
from repro import obs as jobs
from repro.configs import smoke_config as jax_smoke_config
from repro.models.transformer import Model as JaxModel
from repro.obs import report as jreport
from repro.serve.engine import ContinuousEngine as JaxContinuous
from repro.serve.engine import Request as JaxRequest
from repro.testing import faults as jfaults
from repro_torch import obs
from repro_torch.configs import smoke_config
from repro_torch.ft import artefacts
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import Model
from repro_torch.obs import audit, report
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.serve.engine import ContinuousEngine, Request
from repro_torch.testing import faults

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean():
    """Every test starts with tracing off, empty buffers and no flight
    directory, and ends the same (in both packages)."""
    for o in (obs, jobs):
        o.disable()
        o.clear_trace()
        o.configure_flight(dir=None)
        o.flight_clear()
    audit.reset()
    yield
    for o in (obs, jobs):
        o.disable()
        o.clear_trace()
        o.configure_flight(dir=None)
        o.flight_clear()
    audit.reset()


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------

def test_disabled_records_nothing():
    with obs.span("a", x=1):
        obs.event("b")
    assert obs.trace_events() == []
    assert obs.span("c") is obs.span("d")          # one shared no-op span


def test_span_event_shape():
    obs.enable()
    with obs.span("outer", label="L"):
        with obs.span("inner"):
            pass
        obs.event("point", n=3)
    by_name = {e["name"]: e for e in obs.trace_events()}
    assert set(by_name) == {"outer", "inner", "point"}
    inner, outer = by_name["inner"], by_name["outer"]
    assert inner["ph"] == outer["ph"] == "X"
    assert inner["args"]["parent"] == "outer"
    assert outer["args"]["label"] == "L"
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6
    point = by_name["point"]
    assert point["ph"] == "i" and point["s"] == "t"
    assert point["args"]["n"] == 3


def test_span_records_error_and_unwinds():
    obs.enable()
    with pytest.raises(RuntimeError):
        with obs.span("boom"):
            raise RuntimeError("x")
    (ev,) = obs.trace_events()
    assert ev["args"]["error"] == "RuntimeError"
    assert obs.tracer.depth() == 0


def test_traced_decorator():
    calls = []

    @obs.traced("deco.fn")
    def fn(x):
        calls.append(x)
        return x + 1

    assert fn(1) == 2                       # disabled: calls through
    assert obs.trace_events() == []
    obs.enable()
    assert fn(2) == 3
    assert [e["name"] for e in obs.trace_events()] == ["deco.fn"]
    assert calls == [1, 2]


def test_thread_safety():
    """16 threads x 50 nested span pairs with a short switch interval:
    every event lands, and each thread's parent links are its own."""
    obs.enable()
    n_threads, n_spans = 16, 50

    def work(tid):
        for _ in range(n_spans):
            with obs.span(f"outer-{tid}"):
                with obs.span(f"inner-{tid}"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    evs = obs.trace_events()
    assert len(evs) == n_threads * n_spans * 2
    for e in evs:
        if e["name"].startswith("inner-"):
            assert e["args"]["parent"] == "outer-" + e["name"].split("-")[1]


def test_chrome_json_round_trip(tmp_path):
    obs.enable()
    with obs.span("a", arr=torch.zeros(2), ids=[1, torch.ones(1)]):
        obs.event("b")
    path = obs.export_trace(str(tmp_path / "t" / "trace.json"))
    doc = json.loads(Path(path).read_text())
    assert doc["displayTimeUnit"] == "ms"
    assert {e["name"] for e in doc["traceEvents"]} == {"a", "b"}
    for ev in doc["traceEvents"]:
        assert isinstance(ev["ts"], (int, float))
        assert isinstance(ev["pid"], int) and isinstance(ev["tid"], int)
        assert ev["ph"] in ("X", "i")
        if ev["ph"] == "X":
            assert ev["dur"] >= 0
            assert ev["args"]["arr"].startswith("tensor(")   # repr'd


def test_repro_trace_env_enables_and_exports_at_exit(tmp_path):
    """REPRO_TRACE=<path> (the reference's meaning): tracing on at import,
    the Chrome trace written at exit."""
    path = tmp_path / "exit.json"
    code = ("from repro_torch import obs\n"
            "assert obs.enabled()\n"
            "with obs.span('at.exit'):\n    pass\n")
    env = dict(os.environ, REPRO_TRACE=str(path),
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]]
    assert names == ["at.exit"]


def test_repro_flight_dir_env_writes_dumps_there(tmp_path):
    """REPRO_FLIGHT_DIR (the reference's meaning): the recorder writes its
    dumps there without code changes."""
    code = ("from repro_torch import obs\n"
            "obs.flight_dump('env_drill', req_id=3)\n")
    env = dict(os.environ, REPRO_FLIGHT_DIR=str(tmp_path / "fl"),
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    (path,) = (tmp_path / "fl").glob("flight-*.json")
    assert path.name == "flight-0001-env_drill.json"
    assert json.loads(path.read_text())["ctx"] == {"req_id": 3}


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_counter_gauge_histogram():
    reg = obs.MetricsRegistry()
    reg.counter("c").inc()
    reg.counter("c").inc(2)
    assert reg.counter("c").value == 3
    reg.gauge("g").set(7)
    reg.gauge("g").inc(-2)
    assert reg.gauge("g").value == 5
    h = reg.histogram("h")
    for v in (0.5, 1.5, 3.0, 0.0):
        h.observe(v)
    snap = reg.snapshot()
    assert snap["c"] == {"type": "counter", "value": 3}
    assert snap["h"]["count"] == 4 and h.mean == pytest.approx(1.25)
    assert snap["h"]["min"] == 0.0 and snap["h"]["max"] == 3.0
    assert "<=0" in snap["h"]["buckets"]
    json.dumps(snap)
    reg.reset()
    assert reg.counter("c").value == 0 and reg.histogram("h").count == 0
    assert reg.names() == ["c", "g", "h"]


def test_type_mismatch_raises():
    reg = obs.MetricsRegistry()
    reg.counter("x")
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("x")


def test_metrics_export(tmp_path):
    reg = obs.MetricsRegistry()
    reg.counter("n").inc(5)
    path = tmp_path / "m" / "m.json"
    reg.export(str(path))
    assert json.loads(path.read_text())["n"]["value"] == 5


def test_concurrent_increments():
    reg = obs.MetricsRegistry()
    c = reg.counter("c")

    def work():
        for _ in range(1000):
            c.inc()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert c.value == 16000


@pytest.mark.parametrize("values", [
    [float(v) for v in range(1, 101)],            # interpolated quantiles
    [3.0],                                        # clamped to min / max
    [0.0] * 10,                                   # the underflow bucket
    [1e-9, 2.5e-4, 0.0, 7.0, 1e6, 0.03],          # wide magnitudes
], ids=["ramp", "one", "zeros", "wide"])
def test_histogram_snapshot_equals_the_reference(values):
    """The same observations give the same snapshot (buckets, quantiles)
    in both packages."""
    mine, theirs = obs.MetricsRegistry(), jobs.MetricsRegistry()
    for v in values:
        mine.histogram("h").observe(v)
        theirs.histogram("h").observe(v)
    snap = mine.snapshot()["h"]
    assert snap == theirs.snapshot()["h"]
    assert snap["p50"] <= snap["p95"] <= snap["p99"] <= snap["max"]
    assert snap["min"] <= mine.histogram("h").percentile(0.0)


def test_quantiles_plausible_clamped_and_empty():
    reg = obs.MetricsRegistry()
    h = reg.histogram("lat")
    for v in range(1, 101):
        h.observe(float(v))
    snap = reg.snapshot()["lat"]
    assert 25 <= snap["p50"] <= 75 and snap["p99"] >= 64.0
    one = reg.histogram("one")
    one.observe(3.0)
    assert reg.snapshot()["one"]["p50"] == reg.snapshot()["one"]["p99"] == 3.0
    z = reg.histogram("z")
    for _ in range(10):
        z.observe(0.0)
    assert reg.snapshot()["z"]["p99"] == 0.0
    assert reg.histogram("e").percentile(0.5) is None


# ---------------------------------------------------------------------------
# provenance
# ---------------------------------------------------------------------------

def test_provenance_record_annotate_explain():
    obs.clear_decisions()
    assert "no decisions recorded" in obs.explain()
    d = obs.record("kernel", "dot", "dot|n=8|k", {"block": 4}, "default",
                   shape={"n": 8}, backend="cuda",
                   strategy_trace={"steps": [{"rule": "split"},
                                             {"rule": "fuse"}]})
    assert obs.provenance.get("dot|n=8|k") is d
    text = obs.explain("dot")
    assert "picked block=4" in text and "origin default" in text
    assert "derived by split ; fuse" in text       # the plain fallback
    obs.annotate("dot|n=8|k", origin="default[stale]")
    assert obs.decisions("kernel")[0].origin == "default[stale]"
    assert json.dumps(obs.decisions()[0].to_doc())
    obs.clear_decisions()
    assert len(obs.provenance_log()) == 0


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def test_events_ring_with_tracing_disabled():
    obs.event("unit.boundary", x=1)
    assert obs.trace_events() == []
    (e,) = [e for e in obs.flight_tail() if e["name"] == "unit.boundary"]
    assert e["kind"] == "event" and e["args"]["x"] == 1


def test_spans_and_counter_deltas_tapped():
    obs.counter("unit.flight_c").inc(3)
    obs.enable()
    with obs.span("unit.flight_span"):
        pass
    seen = {(e["kind"], e["name"]) for e in obs.flight_tail()}
    assert ("metric", "unit.flight_c") in seen
    assert ("span", "unit.flight_span") in seen


def test_ring_bounded_and_resizable():
    r = FlightRecorder(capacity=8)
    for i in range(100):
        r.record("event", f"e{i}")
    assert len(r) == 8 and r.tail(1)[0]["name"] == "e99"
    r.configure(capacity=4)
    assert [e["name"] for e in r.tail()] == ["e96", "e97", "e98", "e99"]


def test_dump_document_and_artefact(tmp_path):
    obs.configure_flight(dir=str(tmp_path))
    obs.event("pre.failure", req=7)
    doc = obs.flight_dump("unit_reason", req_id=7, why="test")
    assert doc["version"] == 1 and doc["reason"] == "unit_reason"
    assert doc["ctx"] == {"req_id": 7, "why": "test"}
    assert any(e["name"] == "pre.failure" for e in doc["events"])
    assert {"metrics", "provenance", "drift"} <= set(doc)
    (path,) = tmp_path.glob("flight-*.json")
    loaded = json.loads(path.read_text())
    assert loaded["reason"] == "unit_reason" and loaded["seq"] == doc["seq"]
    assert obs.flight_dumps()[-1]["reason"] == "unit_reason"
    assert obs.recorder.recorder.dump_paths() == [str(path)]


def test_no_dump_written_without_a_directory(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    obs.flight_dump("in_memory_only")
    assert obs.flight_dumps()[-1]["reason"] == "in_memory_only"
    assert list(tmp_path.iterdir()) == []


# ---------------------------------------------------------------------------
# drift audit
# ---------------------------------------------------------------------------

def test_ratio_drift_fires_once_after_shift():
    obs.record("kernel", "k", "unit|k", {}, "default")
    before = obs.counter("tune.drift").value
    a = audit.DriftAuditor(min_samples=8, tolerance=2.0)
    for _ in range(8):
        assert a.observe("unit|k", 1.0) is None
    assert a.observe("unit|k", 1.1) == pytest.approx(1.1, rel=1e-6)
    assert obs.counter("tune.drift").value == before
    assert a.observe("unit|k", 5.0) == pytest.approx(5.0, rel=1e-6)
    assert obs.counter("tune.drift").value == before + 1
    a.observe("unit|k", 5.0)
    assert obs.counter("tune.drift").value == before + 1
    snap = a.snapshot()
    assert snap["keys"]["unit|k"]["fired"] is True and snap["fired"] == 1
    assert any(e["name"] == "tune.drift" for e in obs.flight_tail())
    assert obs.provenance.get("unit|k").origin == "default[stale]"


def test_stable_measurements_stay_quiet_and_match_the_reference():
    mine = audit.DriftAuditor(min_samples=8, tolerance=2.0)
    from repro.obs import audit as jaudit
    theirs = jaudit.DriftAuditor(min_samples=8, tolerance=2.0)
    for i in range(50):
        v = 1.0 + 0.1 * (i % 3)
        assert mine.observe("unit|stable", v) == \
            theirs.observe("unit|stable", v)
    assert mine.snapshot()["fired"] == 0
    assert mine.snapshot()["keys"] == theirs.snapshot()["keys"]
    assert mine.observe("unit|x", 0.0) is None       # non-positive: ignored


def test_ranking_audit_raises_naming_the_autotuner():
    with pytest.raises(NotImplementedError, match="ROADMAP.*autotune"):
        obs.audit_record("dot", "k", {"timings": {"a": 1.0, "b": 2.0}})
    with pytest.raises(NotImplementedError, match="autotune"):
        obs.audit_cache(object())


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

_SNAP = {"a.count": {"type": "counter", "value": 3},
         "a.lat": {"type": "histogram", "count": 4, "mean": 1.0,
                   "p50": 1.0, "p95": 2.0, "p99": 2.5, "max": 3.0,
                   "min": 0.5, "buckets": {}}}
_DRIFT = {"tolerance": 2.0, "fired": 1,
          "keys": {"k1": {"n": 9, "fired": True, "drift_x": 5.0}},
          "ranking": {"k2": {"predicted_best": "a", "measured_best": "b",
                             "slowdown_x": 3.0}}}
_DUMP = {"seq": 3, "reason": "request_failed", "ctx": {"req_id": 1},
         "events": [{"kind": "event", "name": "serve.submit", "t": 0.0,
                     "args": {"req_id": 1}},
                    {"kind": "span", "name": "serve.decode_chunk", "t": 0.0,
                     "dur_us": 12.5, "error": "ValueError"},
                    {"kind": "metric", "name": "c", "t": 0.0,
                     "delta": 1.0}],
         "drift": _DRIFT}
_HISTORY = [{"t": "2026-08-08T00:00:00Z", "serve": {"fused_tok_s": 5000.0},
             "recompiles": 0, "drift": 0,
             "resilience": {"faults_injected": 10}}]
_TRACE = [{"name": "serve.submit", "ph": "i", "ts": 1.0,
           "args": {"req_id": 0}},
          {"name": "serve.decode_chunk", "ph": "X", "ts": 5.0, "dur": 2e3,
           "args": {"req_ids": "0,1", "parent": "serve.step_chunk"}},
          {"name": "serve.retire", "ph": "i", "ts": 9e3,
           "args": {"req_id": 1, "state": "ok"}}]


@pytest.mark.parametrize("render,doc", [
    ("render_metrics", _SNAP), ("render_drift", _DRIFT),
    ("render_dump", _DUMP), ("render_history", _HISTORY),
    ("render_history", []), ("render_metrics", {}), ("render_drift", {})])
def test_renderings_equal_the_reference(render, doc):
    got = getattr(report, render)(doc)
    assert got == getattr(jreport, render)(doc)
    assert got


@pytest.mark.parametrize("req_id", ["0", "1", "42"])
def test_request_timeline_equals_the_reference(req_id):
    got = report.request_timeline(_TRACE, req_id)
    assert got == jreport.request_timeline(_TRACE, req_id)
    assert ("no events" in got) == (req_id == "42")


def test_report_contents_and_live_render():
    assert "p95=2" in report.render_metrics(_SNAP)
    drift = report.render_drift(_DRIFT)
    assert "DRIFTED" in drift and "MIS-RANKED" in drift
    assert "fused=5000" in report.render_history(_HISTORY)
    obs.counter("unit.report_c").inc()
    obs.event("unit.report_e")
    live = report.render()
    assert "repro_torch system report" in live and "flight recorder" in live


def test_report_cli_on_artefacts(tmp_path):
    """``python -m repro_torch.obs.report`` renders artefacts in a process
    that sees no card."""
    obs.configure_flight(dir=str(tmp_path / "fl"))
    obs.flight_dump("unit_cli", req_id=9)
    obs.configure_flight(dir=None)
    (tmp_path / "hist.json").write_text(json.dumps(_HISTORY))
    (tmp_path / "m.json").write_text(json.dumps(_SNAP))
    (tmp_path / "t.json").write_text(json.dumps({"traceEvents": _TRACE}))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report",
         "--flight", str(tmp_path / "fl"), "--history",
         str(tmp_path / "hist.json"), "--metrics", str(tmp_path / "m.json"),
         "--trace", str(tmp_path / "t.json"), "--request", "1"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for want in ("unit_cli", "bench history", "a.lat", "request 1 — 2"):
        assert want in proc.stdout
    (tmp_path / "empty").mkdir()
    assert report.main(["--flight", str(tmp_path / "empty")]) == 0


# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------

SPEC = ("serve.nan_prefill(req_id=3); executor.build(key=*cuda*, "
        "times=2, after=1); serve.slow_chunk(value=0.25); x(times=-1); "
        "y(value=abc)")


def test_spec_grammar_equals_the_reference():
    plan = faults.parse_spec(SPEC)
    assert [f.describe() for f in plan] == \
        [f.describe() for f in jfaults.parse_spec(SPEC)]
    assert [f.site for f in plan] == ["serve.nan_prefill", "executor.build",
                                      "serve.slow_chunk", "x", "y"]
    assert plan[1].times == 2 and plan[1].after == 1
    assert plan[1].match == {"key": "*cuda*"}
    assert plan[2].value == 0.25 and plan[4].value == "abc"
    assert plan[3].times == -1


@pytest.mark.parametrize("bad", ["site(unclosed", "site(keyvalue)", "(x=1)"])
def test_spec_rejects_malformed(bad):
    with pytest.raises(ValueError):
        faults.parse_spec(bad)


def test_schedule_match_nesting_and_raise_if():
    with faults.inject("s(after=1, times=2)") as plan:
        hits = [faults.should_fire("s") is not None for _ in range(5)]
    assert hits == [False, True, True, False, False]
    assert plan[0].fired == 2 and plan[0].seen == 5
    with faults.inject("s(k=*abc*, times=-1)"):
        assert faults.should_fire("s", k="xxabcyy") is not None
        assert faults.should_fire("s", k="nope") is None
    with faults.inject("a"):
        with faults.inject(faults.Fault(site="b")) as inner:
            assert faults.should_fire("b") is not None
            assert faults.should_fire("a") is not None
        assert inner[0].fired == 1
    assert not faults.active() and faults.should_fire("a") is None
    with faults.inject("boom"):
        with pytest.raises(faults.InjectedFault, match="boom"):
            faults.raise_if("boom")
    faults.raise_if("boom")


def test_env_var_plan(monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "envsite(times=1)")
    assert faults.active()
    assert faults.should_fire("envsite") is not None
    assert faults.should_fire("envsite") is None
    monkeypatch.delenv(faults.ENV_VAR)
    assert not faults.active()


def test_firing_is_counted_and_attributed():
    obs.enable()
    before = obs.counter("faults.injected").value
    with faults.inject("site.x(req_id=4)"):
        faults.should_fire("site.x", req_id=3)
        faults.should_fire("site.x", req_id=4)
    assert obs.counter("faults.injected").value == before + 1
    (ev,) = [e for e in obs.trace_events() if e["name"] == "faults.injected"]
    assert ev["args"]["req_id"] == "4" and ev["args"]["site"] == "site.x"


def test_corrupt_pool_damages_the_port_block_pool():
    from repro_torch.serve.paged import BlockPool
    pool = BlockPool(4, 16)
    assert "duplicated free block" in faults.corrupt_pool(pool)
    assert len(pool._free) == 5 and len(set(pool._free)) == 4


# ---------------------------------------------------------------------------
# artefacts
# ---------------------------------------------------------------------------

def test_artefact_round_trip_checksummed(tmp_path):
    p = str(tmp_path / "a" / "a.json")
    artefacts.save_json(p, {"version": 1, "entries": {"k": [1, 2]}})
    raw = json.loads(Path(p).read_text())
    assert raw["checksum"].startswith("sha256:")
    assert artefacts.load_json(p) == {"version": 1, "entries": {"k": [1, 2]}}
    assert not [n for n in os.listdir(tmp_path / "a") if n != "a.json"]


def test_artefact_checksum_equals_the_reference(tmp_path):
    from repro.ft import artefacts as jart
    doc = {"version": 3, "key": "dot|n=8", "program": {"cmd": [1, 2.5]}}
    artefacts.save_json(str(tmp_path / "mine.json"), doc)
    jart.save_json(str(tmp_path / "theirs.json"), doc)
    assert (tmp_path / "mine.json").read_text() == \
        (tmp_path / "theirs.json").read_text()
    assert jart.load_json(str(tmp_path / "mine.json")) == doc


def test_missing_artefact_is_silent_none(tmp_path):
    before = obs.counter("artefact.load_failed").value
    assert artefacts.load_json(str(tmp_path / "absent.json")) is None
    assert obs.counter("artefact.load_failed").value == before


@pytest.mark.parametrize("mode", ["garbage", "truncate", "stale"])
def test_corrupt_artefact_quarantined_and_reported(tmp_path, mode):
    p = str(tmp_path / "a.json")
    artefacts.save_json(p, {"version": 1, "x": mode})
    faults.corrupt_json_file(p, mode)
    before = obs.counter("artefact.load_failed").value
    assert artefacts.load_json(p, what="test store") is None
    assert obs.counter("artefact.load_failed").value == before + 1
    assert not os.path.exists(p)
    assert os.listdir(p + ".quarantine") == ["a.json"]
    (dump,) = obs.flight_dumps()
    assert dump["reason"] == "artefact_quarantine"
    assert dump["ctx"]["what"] == "test store"


def test_legacy_artefact_without_checksum_loads(tmp_path):
    p = tmp_path / "legacy.json"
    p.write_text(json.dumps({"version": 1, "old": True}))
    assert artefacts.load_json(str(p)) == {"version": 1, "old": True}


def test_artefact_corrupt_site_fires_under_a_scoped_plan(tmp_path):
    p = str(tmp_path / "a.json")
    artefacts.save_json(p, {"version": 1})
    with faults.inject("artefact.corrupt(what=drill*)") as plan:
        assert artefacts.load_json(p, what="other") == {"version": 1}
        assert artefacts.load_json(p, what="drill target") is None
    assert plan[0].fired == 1
    assert not os.path.exists(p)
    assert artefacts.quarantine(str(tmp_path / "gone.json")) is None


def test_journal_records_and_torn_tail(tmp_path):
    p = str(tmp_path / "j" / "journal.jsonl")
    for i in range(3):
        artefacts.append_record(p, {"i": i})
    assert artefacts.read_records(p) == ([{"i": 0}, {"i": 1}, {"i": 2}],
                                         True)
    with open(p, "a") as f:
        f.write('{"i": 3, "checks')              # a crash mid-append
    before = obs.counter("artefact.journal_torn").value
    records, clean = artefacts.read_records(p)
    assert records == [{"i": 0}, {"i": 1}, {"i": 2}] and not clean
    assert obs.counter("artefact.journal_torn").value == before + 1
    assert artefacts.read_records(str(tmp_path / "none")) == ([], True)


# ---------------------------------------------------------------------------
# the serving spine, held against the reference's engine
# ---------------------------------------------------------------------------

LENGTHS = (7, 21, 3, 12)                 # 21 > prefill_chunk: three chunks
MAX_NEW = (5, 3, 6, 4)
ENGINE = dict(max_seq=48, slots=2, chunk=4, min_bucket=8, prefill_chunk=8,
              kv_layout="paged", block_size=16, kv_blocks=2)
COUNTERS = ("serve.requests_submitted", "serve.requests_admitted",
            "serve.requests_retired", "serve.admission_deferrals")


def _lifecycle(events):
    """{req_id: [event names in time order]} for every event or span
    carrying a req_id."""
    out = {}
    for e in sorted(events, key=lambda e: e["ts"]):
        rid = (e.get("args") or {}).get("req_id")
        if rid is not None:
            out.setdefault(int(rid), []).append(e["name"])
    return out


@pytest.fixture(scope="module")
def served():
    """One tiny continuous run through each package, traced, the metrics
    reset just before: (reference, port) as (tokens, lifecycle, counters,
    snapshot, trace events)."""
    jcfg = dataclasses.replace(jax_smoke_config("qwen3_4b"), use_flash=True)
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = smoke_config("qwen3_4b", use_flash=True)
    params = params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 256, size=n) for n in LENGTHS]
    out = []
    for pkg in (jobs, obs):
        pkg.metrics_reset()
        pkg.clear_trace()
        pkg.enable()
        try:
            if pkg is jobs:
                engine = JaxContinuous(jmodel, jparams, **ENGINE)
                with jcompiler.options(backend="pallas"):
                    toks = engine.run(
                        [JaxRequest(prompt=jnp.asarray(p), max_new_tokens=n)
                         for p, n in zip(prompts, MAX_NEW)])
            else:
                engine = ContinuousEngine(Model(cfg), params, **ENGINE)
                toks = engine.run([Request(prompt=p.tolist(),
                                           max_new_tokens=n)
                                   for p, n in zip(prompts, MAX_NEW)])
        finally:
            pkg.disable()
        snap = pkg.metrics_snapshot()
        events = pkg.trace_events()
        pkg.clear_trace()
        out.append((toks, _lifecycle(events),
                    {c: snap[c]["value"] for c in COUNTERS}, snap, events,
                    engine.stats()))
    return out


def test_same_tokens_as_the_reference(served):
    (want, *_), (got, *_) = served
    assert got == want
    assert [len(t) for t in got] == list(MAX_NEW)


def test_same_lifecycle_events_per_request_as_the_reference(served):
    (_, want, *_), (_, got, *_) = served
    assert got == want
    assert set(got) == set(range(len(LENGTHS)))
    for rid, names in got.items():
        assert names[0] == "serve.submit" and names[-1] == "serve.retire"
        assert names.index("serve.admit") < names.index("serve.first_token")
        assert names.count("serve.prefill_chunk") == -(-LENGTHS[rid] // 8)
    assert any("serve.admission_deferred" in n for n in got.values())


def test_same_counters_as_the_reference(served):
    (_, _, want, *_), (_, _, got, *_) = served
    assert got == want
    n = len(LENGTHS)
    assert got["serve.requests_submitted"] == got[
        "serve.requests_admitted"] == got["serve.requests_retired"] == n
    assert got["serve.admission_deferrals"] > 0


def test_latency_histograms_and_stats(served):
    *_, (_, _, _, snap, _, stats) = served
    n = len(LENGTHS)
    for name in ("serve.queue_wait_s", "serve.ttft_s", "serve.e2e_s",
                 "serve.request_tokens", "serve.decode_tok_s"):
        assert snap[name]["count"] == n, name
    assert snap["serve.request_tokens"]["total"] == sum(MAX_NEW)
    assert snap["serve.chunk_s"]["count"] == stats["chunks"]
    # set at each boundary's admissions: the pool's two blocks either way
    assert snap["serve.kv_pool.free_blocks"]["value"] + \
        snap["serve.kv_pool.used_blocks"]["value"] == 2
    assert stats["latency"]["ttft_s"]["count"] == n
    assert set(stats["executor_cache"]) == {"entries", "hits", "builds",
                                            "aot_loads"}


def test_engine_spans_nest_and_export(served, tmp_path):
    *_, (_, _, _, _, events, _) = served
    names = [e["name"] for e in events]
    assert names.count("engine.warm") == 1
    for span in ("serve.step_chunk", "serve.decode_chunk",
                 "serve.prefill_chunk"):
        assert span in names, span
    by = {e["name"]: e for e in events if e["ph"] == "X"}
    assert by["serve.decode_chunk"]["args"]["parent"] == "serve.step_chunk"
    assert by["serve.prefill_chunk"]["args"]["parent"] == "serve.step_chunk"
    assert by["serve.step_chunk"]["args"]["parent"] == "engine.warm"
    assert any(e["args"].get("req_ids") for e in events
               if e["name"] == "serve.decode_chunk")
    path = tmp_path / "serve.json"
    path.write_text(json.dumps({"traceEvents": events}))
    tl = report.request_timeline(json.loads(path.read_text())["traceEvents"],
                                 "1")
    assert "serve.submit" in tl and "serve.decode_chunk" in tl


class _Graphs:
    """A stand-in for ChunkGraphs: its captures and keys only."""
    def __init__(self):
        self.keys = [(2, 4, False)]

    @property
    def captures(self):
        return len(self.keys)


def test_recapture_detector_feeds_the_counter_and_event(caplog):
    """A capture after warm-up: the reference's serve.recompiles_after_warm
    counter and serve.recompile_after_warm event, once per new key."""
    cfg = smoke_config("qwen3_4b", use_flash=True)
    model = Model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    engine = ContinuousEngine(model, params, max_seq=32, slots=2, chunk=4)
    engine._graphs = _Graphs()
    engine.mark_warm()
    before = obs.counter("serve.recompiles_after_warm").value
    engine._check_recaptures()
    assert obs.counter("serve.recompiles_after_warm").value == before
    engine._graphs.keys.append((2, 4, True))
    with caplog.at_level("WARNING", logger="repro_torch.serve.engine"):
        engine._check_recaptures()
        engine._check_recaptures()                # reported once
    assert obs.counter("serve.recompiles_after_warm").value == before + 1
    (ev,) = [e for e in obs.flight_tail()
             if e["name"] == "serve.recompile_after_warm"]
    assert ev["args"]["keys"] == ["(2, 4, True)"]
    assert engine.stats()["recaptures_after_warm"] == 1
    assert "(2, 4, True)" in caplog.text


def test_failed_request_dumps_the_flight_recorder(tmp_path):
    """A request that times out ends in a ``request_timeout`` dump naming
    it; a cancelled one (a caller's action) dumps nothing."""
    from repro_torch.serve.scheduler import Scheduler
    obs.configure_flight(dir=str(tmp_path))
    s = Scheduler(1)
    s.submit(0, 4, 2, deadline_s=0.0)
    s.submit(1, 4, 2)
    s.cancel(1)
    s.check_deadlines()
    (dump,) = obs.flight_dumps()
    assert dump["reason"] == "request_timeout" and dump["ctx"]["req_id"] == 0
    assert [p.name for p in tmp_path.iterdir()] == [
        "flight-0001-request_timeout.json"]
    assert s.evacuate(0) is None
