"""The port's serving resilience (repro_torch.serve.resilience, the
resilience paths of repro_torch.serve.engine, repro_torch.ft.resilience) on
the CPU, held against the reference.

Every engine drill of tests/test_resilience.py runs through both
packages' ``ContinuousEngine`` under the same fault plan, on the same tiny
model (2 layers, d_model 32, float32, greedy; the reference's params
converted through numpy) and the same prompts (numpy, seeded): the two
must give the same terminal states and reasons, the same tokens for every
request and the same ``stats()["resilience"]`` counters.  Port-only
checks: the trash page of a paged pool stays finite after every paged
drill, the chunk-failure rebuild keeps the chunk's tensors (a captured
graph reads them), the paged -> dense degradation replaces them, and an
exception from the chunk itself is neither retried nor quarantined."""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.ft.resilience import elastic_remesh as jelastic_remesh
from repro.ft.resilience import guard_update as jguard_update
from repro.models.common import ModelConfig as JaxConfig
from repro.models.transformer import Model as JaxModel
from repro.serve import domains as jdomains
from repro.serve.engine import BatchedEngine as JaxBatched
from repro.serve.engine import ContinuousEngine as JaxContinuous
from repro.serve.engine import Request as JaxRequest
from repro.serve.resilience import ResilienceConfig as JaxResilienceConfig
from repro.testing import faults as jfaults
from repro_torch import obs
from repro_torch.ft import resilience as ft
from repro_torch.ft.resilience import Watchdog
from repro_torch.models.common import ModelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import Model
from repro_torch.serve import domains
from repro_torch.serve.engine import BatchedEngine, ContinuousEngine, Request
from repro_torch.serve.paged import BlockPool
from repro_torch.serve.resilience import (STATES, RequestResult,
                                          ResilienceConfig,
                                          record_degradation)
from repro_torch.testing import faults

TINY = dict(name="resil-t", family="dense", n_layers=2, d_model=32,
            n_heads=4, n_kv_heads=2, d_ff=64, vocab=128, dtype="float32",
            remat=False, max_seq=64)
ENGINE = dict(max_seq=64, slots=2, chunk=4, min_bucket=8)


@pytest.fixture(scope="module")
def models():
    """(reference model, reference params, port model, port params)."""
    jmodel = JaxModel(JaxConfig(**TINY))
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = ModelConfig(**TINY)
    params = params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, Model(cfg), params


@pytest.fixture(autouse=True)
def _clean_obs():
    for o in (obs, jobs):
        o.flight_clear()
        o.clear_decisions()
    yield


def prompts(n=4):
    rng = np.random.RandomState(7)
    return [rng.randint(0, TINY["vocab"], size=5 + 3 * i) for i in range(n)]


def requests(n=4, **kw):
    """(reference requests, port requests): prompt i has 5 + 3 i tokens and
    asks for 4 + 3 i new ones."""
    ps = prompts(n)
    jr = [JaxRequest(prompt=jnp.asarray(p), max_new_tokens=4 + 3 * i, **kw)
          for i, p in enumerate(ps)]
    tr = [Request(prompt=p.tolist(), max_new_tokens=4 + 3 * i, **kw)
          for i, p in enumerate(ps)]
    return jr, tr


def drive(eng, reqs):
    """submit + step_chunk to idle; the requests' RequestResults."""
    rids = [eng.submit(r, stream=i) for i, r in enumerate(reqs)]
    while not eng.sched.idle:
        eng.step_chunk()
    return [eng.take_result(rid) for rid in rids]


def engines(models, resilience=None, **kw):
    jmodel, jparams, model, params = models
    kw = {**ENGINE, **kw}
    jr = JaxResilienceConfig(**resilience) if resilience else None
    tr = ResilienceConfig(**resilience) if resilience else None
    return (JaxContinuous(jmodel, jparams, resilience=jr, **kw),
            ContinuousEngine(model, params, resilience=tr, **kw))


@pytest.fixture(scope="module")
def oracle(models):
    """The port's fault-free tokens of the four requests (the reference's
    are equal: test_fault_free_run_equals_the_reference)."""
    _, eng = engines(models)
    return [list(r.tokens) for r in drive(eng, requests()[1])]


def trash_page_finite(eng) -> bool:
    k, v = eng.st.cache
    return bool(torch.isfinite(k[:, eng.kv_blocks]).all()
                and torch.isfinite(v[:, eng.kv_blocks]).all())


def assert_same(want, got):
    """Reference and port results: states, reasons and tokens."""
    assert [r.state for r in got] == [r.state for r in want]
    assert [r.reason for r in got] == [r.reason for r in want]
    assert [list(r.tokens) for r in got] == [
        [int(t) for t in r.tokens] for r in want]


def assert_clean_identical(results, oracle_out, poisoned=()):
    """Every request that ended ``ok`` (but one left ``poisoned`` with the
    guard off) has its fault-free tokens; request ids are 0, 1, ..."""
    for r in results:
        if r.state == "ok" and r.req_id not in poisoned:
            assert list(r.tokens) == oracle_out[r.req_id], r.req_id


# ---------------------------------------------------------------------------
# the engine drills, through both packages
# ---------------------------------------------------------------------------

# name: (engine kwargs, fault plan, ResilienceConfig kwargs, requests,
#        states the run must end in)
PAGED = dict(kv_layout="paged", block_size=16)
DRILLS = {
    "nan_prefill_dense": ({}, "serve.nan_prefill(req_id=1)", None, 4,
                          ["ok", "failed", "ok", "ok"]),
    "nan_prefill_paged": (PAGED, "serve.nan_prefill(req_id=1)", None, 4,
                          ["ok", "failed", "ok", "ok"]),
    "nan_decode_dense": ({}, "serve.nan_decode(req_id=2)", None, 4,
                         ["ok", "ok", "failed", "ok"]),
    # a tight pool: later requests MUST reuse the poisoned request's pages
    "nan_decode_paged_scrubbed": ({**PAGED, "kv_blocks": 8},
                                  "serve.nan_decode(req_id=0)", None, 4,
                                  ["failed", "ok", "ok", "ok"]),
    # no quarantine: the poisoned request runs to completion (garbage
    # tokens, the same in both packages: argmax of NaN rows agrees)
    "nan_guard_off": ({}, "serve.nan_decode(req_id=0)",
                      dict(nan_guard=False), 2, ["ok", "ok"]),
    "transient_chunk_error_retried": ({}, "serve.chunk_error(times=2)",
                                      dict(retry_backoff_s=0.001), 4,
                                      ["ok"] * 4),
    "retry_exhaustion_dense": ({}, "serve.chunk_error(times=3)",
                               dict(max_chunk_retries=1,
                                    retry_backoff_s=0.001), 4,
                               ["failed", "failed", "ok", "ok"]),
    "retry_exhaustion_paged": (PAGED, "serve.chunk_error(times=3)",
                               dict(max_chunk_retries=1,
                                    retry_backoff_s=0.001), 4,
                               ["failed", "failed", "ok", "ok"]),
    "slow_chunk_straggler": ({}, "serve.slow_chunk(times=1, value=0.2)",
                             dict(chunk_deadline_s=0.05), 4, ["ok"] * 4),
    "pool_corruption_degrades": (PAGED, "serve.pool_corrupt(after=1)", None,
                                 4, ["ok", "failed", "ok", "ok"]),
    "pool_exhaustion_defers": (PAGED, "serve.pool_exhausted(req_id=0)", None,
                               4, ["ok"] * 4),
}


@pytest.mark.parametrize("name", sorted(DRILLS))
def test_drill_matches_the_reference(models, oracle, name):
    kw, spec, rc, n, states = DRILLS[name]
    jeng, eng = engines(models, rc, **kw)
    jreqs, reqs = requests(n)
    with jfaults.inject(spec):
        want = drive(jeng, jreqs)
    st0 = eng.st
    ptrs0 = [t.data_ptr() for t in (*st0.cache, st0.tokens, st0.pos,
                                    st0.out)]
    with faults.inject(spec):
        got = drive(eng, reqs)
    assert [r.state for r in got] == states
    assert_same(want, got)
    assert_clean_identical(got, oracle,
                           poisoned=(0,) if name == "nan_guard_off" else ())
    jrs, rs = jeng.stats()["resilience"], eng.stats()["resilience"]
    # the straggler count reads the host's clock (the reference's first
    # chunk also compiles): both saw the slow chunk
    assert (rs.pop("stragglers") >= 1) == (jrs.pop("stragglers") >= 1) == (
        name == "slow_chunk_straggler")
    assert rs == jrs
    assert eng.sched.stats() == jeng.sched.stats()
    if eng.kv_layout == "paged":
        assert trash_page_finite(eng)
    if name.startswith("retry_exhaustion"):
        # the rebuild is in place: a captured graph keeps its buffers
        assert eng.st is st0 and [t.data_ptr() for t in (
            *st0.cache, st0.tokens, st0.pos, st0.out)] == ptrs0
        assert rs["chunk_quarantines"] == 1
    if name == "pool_corruption_degrades":
        assert eng.kv_layout == jeng.kv_layout == "dense"
        assert eng.pool is None and eng.sched.pool is None
        # the chunk's buffers have a new owner, dense-shaped
        assert eng.st is not st0 and eng.st.block_tables is None
        assert eng.st.cache.k.shape[1] == ENGINE["slots"]
        decs = [d for d in obs.decisions()
                if d.origin == "degraded(paged->dense)"]
        assert len(decs) == 1 and decs[0].kind == "kv_layout"
        assert [d["reason"] for d in obs.flight_dumps()].count(
            "degradation") == 1
    if name == "pool_exhaustion_defers":
        assert eng.sched.n_deferrals >= 1


def test_fault_free_run_equals_the_reference(models, oracle):
    jeng, _ = engines(models)
    want = drive(jeng, requests()[0])
    assert [[int(t) for t in r.tokens] for r in want] == oracle


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_run_after_a_drill_equals_the_fault_free_run(models, oracle, layout):
    """The quarantined engine keeps serving: a later run is the oracle."""
    _, eng = engines(models, **({} if layout == "dense" else PAGED))
    with faults.inject("serve.nan_decode(req_id=0)"):
        drive(eng, requests()[1])
    assert eng.run(requests()[1]) == oracle
    if layout == "paged":
        assert trash_page_finite(eng)


def test_quarantine_off_propagates(models):
    rc = dict(max_chunk_retries=0, quarantine_on_chunk_failure=False)
    jeng, eng = engines(models, rc)
    jreqs, reqs = requests(1)
    with jfaults.inject("serve.chunk_error(times=-1)"):
        with pytest.raises(jfaults.InjectedFault):
            jeng.run(jreqs)
    with faults.inject("serve.chunk_error(times=-1)"):
        with pytest.raises(faults.InjectedFault):
            eng.run(reqs)
    assert [d["reason"] for d in obs.flight_dumps()] == [
        "unhandled_exception"]


def test_chunk_exception_is_neither_retried_nor_quarantined(models,
                                                             monkeypatch):
    """The port's rule: the chunk writes the cache in place (and a CUDA
    error is sticky), so only a failure before dispatch is retried; one
    from the chunk itself propagates with the flight dump, whatever the
    quarantine policy says."""
    _, eng = engines(models)
    reqs = requests(2)[1]
    for i, r in enumerate(reqs):
        eng.submit(r, stream=i)

    def broken(st, sampled):
        raise RuntimeError("replay failed")
    monkeypatch.setattr(eng, "_decode_chunk", broken)
    with pytest.raises(RuntimeError, match="replay failed"):
        eng.step_chunk()
    rs = eng.stats()["resilience"]
    assert rs["chunk_retries"] == rs["chunk_quarantines"] == 0
    assert eng.sched.stats()["failed"] == 0
    assert [d["reason"] for d in obs.flight_dumps()] == [
        "unhandled_exception"]


def test_batched_engine_retries_like_the_reference(models):
    jmodel, jparams, model, params = models
    jreqs, reqs = requests()
    rc = dict(retry_backoff_s=0.001)
    jeng = JaxBatched(jmodel, jparams, max_seq=64, chunk=4,
                      resilience=JaxResilienceConfig(**rc))
    eng = BatchedEngine(model, params, max_seq=64, chunk=4,
                        resilience=ResilienceConfig(**rc))
    with jfaults.inject("serve.chunk_error(times=2)"):
        want = jeng.run(jreqs)
    with faults.inject("serve.chunk_error(times=2)"):
        got = eng.run(reqs)
    assert got == [[int(t) for t in o] for o in want]
    assert eng.stats()["resilience"] == jeng.stats()["resilience"]
    assert eng.stats()["resilience"]["chunk_retries"] == 2
    with faults.inject("serve.chunk_error(times=3)"):
        with pytest.raises(faults.InjectedFault):
            eng.run(reqs)


def test_env_fault_plan(models, oracle, monkeypatch):
    """The REPRO_FAULTS activation path: same schedule, no code."""
    monkeypatch.setenv(faults.ENV_VAR, "serve.nan_prefill(req_id=1)")
    jeng, eng = engines(models)
    jreqs, reqs = requests()
    want = drive(jeng, jreqs)
    got = drive(eng, reqs)
    monkeypatch.delenv(faults.ENV_VAR)
    assert [r.state for r in got] == ["ok", "failed", "ok", "ok"]
    assert_same(want, got)
    assert_clean_identical(got, oracle)


# ---------------------------------------------------------------------------
# deadlines and cancellation, through both packages
# ---------------------------------------------------------------------------

def test_deadlines_expire_at_chunk_boundary(models):
    jeng, eng = engines(models)
    ps = prompts(3)
    knobs = [dict(max_new_tokens=4, deadline_s=0.0),
             dict(max_new_tokens=4, ttft_deadline_s=0.0),
             dict(max_new_tokens=8)]
    want = drive(jeng, [JaxRequest(prompt=jnp.asarray(p), **k)
                        for p, k in zip(ps, knobs)])
    got = drive(eng, [Request(prompt=p.tolist(), **k)
                      for p, k in zip(ps, knobs)])
    assert [r.state for r in got] == ["timeout", "timeout", "ok"]
    assert "e2e" in got[0].reason and "ttft" in got[1].reason
    assert_same(want, got)
    assert eng.sched.stats()["timeouts"] == 2


def test_cancel_pending_and_in_flight(models, oracle):
    def script(eng, reqs):
        rids = [eng.submit(r, stream=i) for i, r in enumerate(reqs)]
        eng.cancel(rids[3])              # still pending: zero tokens
        eng.step_chunk()                 # admits 0, 1
        eng.cancel(rids[1])              # in flight: partial tokens
        while not eng.sched.idle:
            eng.step_chunk()
        return [eng.take_result(rid) for rid in rids]
    jeng, eng = engines(models)
    jreqs, reqs = requests()
    want, got = script(jeng, jreqs), script(eng, reqs)
    assert_same(want, got)
    assert got[3].state == "cancelled" and got[3].tokens == ()
    assert got[1].state == "cancelled" and got[1].tokens
    assert list(got[1].tokens) == oracle[1][:len(got[1].tokens)]
    assert [list(got[i].tokens) for i in (0, 2)] == [oracle[0], oracle[2]]


def test_cancel_unknown_raises_and_take_result_surfaces_state(models):
    _, eng = engines(models, slots=1)
    with pytest.raises(KeyError):
        eng.cancel(999)
    reqs = requests(2)[1]
    assert drive(eng, reqs[:1])[0].state == "ok"
    rid = eng.submit(reqs[1])
    eng.cancel(rid, "load shedding")
    eng.cancel(rid, "again")             # terminal: idempotent
    res = eng.take_result(rid)
    assert isinstance(res, RequestResult)
    assert res.state in STATES and not res.ok
    assert res.reason == "load shedding"
    with pytest.raises(KeyError):        # collected: records released
        eng.take_result(rid)


# ---------------------------------------------------------------------------
# the block pool's check and the damage it must catch
# ---------------------------------------------------------------------------

def _full_pool():
    pool = BlockPool(4, 16)
    pool.alloc(0, 4)
    return pool


def _empty_pool():
    """No page free and none owned: the only state in which corrupt_pool
    appends the out-of-range id ``n_blocks + 1``."""
    pool = BlockPool(4, 16)
    pool._free.clear()
    return pool


@pytest.mark.parametrize("make,damage,problem", [
    (lambda: BlockPool(8, 16), "duplicated free block",
     "on the free list twice"),
    (_full_pool, "freed block 0 still owned", "double-booked"),
    # one past the trash page (id n_blocks), which is never handed out
    (_empty_pool, "out-of-range block id", "out-of-range block 5"),
])
def test_validate_catches_each_kind_of_damage(make, damage, problem):
    pool = make()
    if pool.free_blocks or pool._owned:
        assert pool.validate() == []
    assert damage in faults.corrupt_pool(pool)
    assert any(problem in p for p in pool.validate())


def test_validate_rejects_the_trash_page_id():
    pool = BlockPool(4, 16)
    pool._free[0] = 4
    assert any("out-of-range block 4" in p for p in pool.validate())


# ---------------------------------------------------------------------------
# ResilienceConfig, record_degradation, guard_update, the stubs
# ---------------------------------------------------------------------------

def test_resilience_config_defaults_equal_the_reference():
    assert dataclasses.asdict(ResilienceConfig()) == dataclasses.asdict(
        JaxResilienceConfig())


def test_record_degradation_counter_event_and_dump():
    before = obs.counter("serve.degradations").value
    origin = record_degradation("kv_layout", "serve.engine", key="k",
                                frm="paged", to="dense", layout="dense",
                                note="why")
    assert origin == "degraded(paged->dense)"
    assert obs.counter("serve.degradations").value == before + 1
    assert obs.decisions()[-1].origin == origin
    assert [d["reason"] for d in obs.flight_dumps()] == ["degradation"]
    record_degradation("kv_layout", "serve.engine", key="k", frm="paged",
                       to="dense", dump=False)
    assert len(obs.flight_dumps()) == 1


@pytest.mark.parametrize("metrics", [
    {}, {"loss": 1.5, "grad_norm": 0.3}, {"loss": float("nan")},
    {"loss": 1.0, "grad_norm": float("inf")}, {"loss": -float("inf")}])
def test_guard_update_equals_the_reference(metrics):
    assert ft.guard_update(metrics) == jguard_update(metrics)


def _outcome(fn):
    """A call's value, or its error's type and message."""
    try:
        return ("ok", fn())
    except Exception as e:               # noqa: BLE001
        return (type(e).__name__, str(e))


_JFD, _TFD = jdomains.FailureDomains, domains.FailureDomains


@pytest.mark.parametrize("call,ref", [
    (lambda: ft.elastic_remesh("data=8", ("data",)),
     lambda: jelastic_remesh("data=8", ("data",))),
    (lambda: ft.elastic_remesh((4, 1)), lambda: jelastic_remesh((4, 1))),
    (lambda: ft.elastic_remesh("single"), lambda: jelastic_remesh("single")),
    (lambda: _TFD.partition(8, 3), lambda: _JFD.partition(8, 3)),
    (lambda: _TFD({"data": 8}, hosts=4).slots_of_host(2, 16),
     lambda: _JFD.slots_for(_JFD.partition(8, 4), [True] * 4, 2, 16)),
    (lambda: dataclasses.asdict(domains.HostEvent("lost", 1, "why")),
     lambda: dataclasses.asdict(jdomains.HostEvent("lost", 1, "why"))),
])
def test_mesh_pieces_equal_the_reference(call, ref):
    """The pieces of sharded serving this module's drills lean on, in
    process (their runs on 4 ranks: tests/test_torch_sharded.py):
    ``elastic_remesh``'s errors, the host partition and slot attribution
    of ``FailureDomains``, ``HostEvent``'s fields."""
    assert _outcome(call) == _outcome(ref)


# ---------------------------------------------------------------------------
# the Watchdog: the disarm race
# ---------------------------------------------------------------------------

def test_watchdog_disarm_race_no_spurious_straggler():
    """A step finishing at the deadline: the raced callback arriving after
    ``disarm()`` must be a no-op (simulated by invoking it by hand)."""
    w = Watchdog(deadline_s=60.0, on_straggler=lambda s, d: None)
    w.arm(step=1)
    stale_gen = w._gen
    w.disarm()
    w._fire(stale_gen)
    assert w.events == []


def test_watchdog_rearm_invalidates_older_generation():
    w = Watchdog(deadline_s=60.0, on_straggler=lambda s, d: None)
    w.arm(step=1)
    gen1 = w._gen
    w.arm(step=2)               # re-arm without disarm (next chunk)
    w._fire(gen1)               # step-1 timer firing late
    assert w.events == []
    w._fire(w._gen)             # the live generation may fire...
    assert [s for s, _ in w.events] == [2]
    w._fire(w._gen)             # ...but only once
    assert len(w.events) == 1
    w.disarm()


def test_watchdog_real_timer_still_fires_on_breach():
    fired = threading.Event()
    w = Watchdog(deadline_s=0.02, on_straggler=lambda s, d: fired.set())
    w.arm(step=7)
    assert fired.wait(timeout=2.0)
    w.disarm()
    assert [s for s, _ in w.events] == [7]
