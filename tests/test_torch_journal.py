"""The port's scheduler journal (repro_torch.serve.domains) on the CPU: its
checksummed records, the fold into ``JournalState``, ``replay`` into a
fresh engine against the fault-free run (mid-decode, mid-prefill, a
cancel racing the crash, twice, after a torn tail), and journals read
across the packages: one the port wrote folds, under the reference's
``SchedulerJournal.load``, into the state the port's load gives, and the
reverse.  The counterparts of tests/test_domains.py's journal tests."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.ft import artefacts as jartefacts
from repro.models.common import ModelConfig as JaxConfig
from repro.models.transformer import Model as JaxModel
from repro.serve.domains import SchedulerJournal as JaxJournal
from repro.serve.engine import ContinuousEngine as JaxContinuous
from repro.serve.engine import Request as JaxRequest
from repro_torch.ft import artefacts
from repro_torch.models.common import ModelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import Model
from repro_torch.serve.domains import (JOURNAL_KINDS, JournalState,
                                       SchedulerJournal, replay)
from repro_torch.serve.engine import ContinuousEngine, Request

TINY = dict(name="dom-t", family="dense", n_layers=2, d_model=32,
            n_heads=4, n_kv_heads=2, d_ff=64, vocab=128, dtype="float32",
            remat=False, max_seq=64)
ENGINE = dict(max_seq=64, slots=4, chunk=4)


@pytest.fixture(scope="module")
def models():
    """(reference model, reference params, port model, port params)."""
    jmodel = JaxModel(JaxConfig(**TINY))
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = ModelConfig(**TINY)
    params = params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, Model(cfg), params


def knobs(n):
    """Prompt, temperature and top-k of request i: 16 new tokens each
    (chunk 4), so nothing retires in the boundaries before a crash."""
    rng = np.random.RandomState(5)
    temps = [0.0, 0.9, 0.0]
    return [(rng.randint(0, TINY["vocab"], size=5 + 3 * i).tolist(),
             temps[i % 3], 5 if i % 3 == 1 else 0) for i in range(n)]


def port_requests(n=3):
    return [Request(prompt=p, max_new_tokens=16, temperature=t, top_k=k)
            for p, t, k in knobs(n)]


def jax_requests(n=3):
    return [JaxRequest(prompt=jnp.asarray(p), max_new_tokens=16,
                       temperature=t, top_k=k) for p, t, k in knobs(n)]


def abandon(eng, reqs, *, seed, chunks, cancel_rid=None):
    """Drive a journaled engine partway and walk away (the crash)."""
    eng._run_seed = seed
    for i, r in enumerate(reqs):
        eng.submit(r, stream=i)
    for _ in range(chunks):
        if eng.sched.idle:
            break
        eng.step_chunk()
    if cancel_rid is not None:
        eng.cancel(cancel_rid, "raced with the crash")
    return eng


def fresh(models, **kw):
    return ContinuousEngine(models[2], models[3], **ENGINE, **kw)


# ---------------------------------------------------------------------------
# records: round trip, torn tail, flipped bit (read by both packages)
# ---------------------------------------------------------------------------

def _journal(path):
    j = SchedulerJournal(path)
    j.record_submit(0, [1, 2, 3], max_new=4, temperature=0.0, top_k=0,
                    stream=0)
    j.record_progress(0, [7, 8])
    j.record_terminal(0, "ok")
    return path


@pytest.mark.parametrize("read", [artefacts.read_records,
                                  jartefacts.read_records],
                         ids=["port", "reference"])
def test_records_round_trip(tmp_path, read):
    recs, clean = read(_journal(str(tmp_path / "j.jsonl")))
    assert clean
    assert [r["kind"] for r in recs] == ["submit", "progress", "terminal"]
    assert recs[1]["tokens"] == [7, 8] and recs[1]["n"] == 2
    assert all(r["kind"] in JOURNAL_KINDS for r in recs)


@pytest.mark.parametrize("read", [artefacts.read_records,
                                  jartefacts.read_records],
                         ids=["port", "reference"])
def test_torn_tail_recovers_to_the_last_complete_record(tmp_path, read):
    p = _journal(str(tmp_path / "j.jsonl"))
    with open(p, "a") as f:
        f.write('{"kind": "progress", "rid": 0, "tok')   # crash mid-write
    recs, clean = read(p)
    assert not clean
    assert [r["kind"] for r in recs] == ["submit", "progress", "terminal"]


@pytest.mark.parametrize("read", [artefacts.read_records,
                                  jartefacts.read_records],
                         ids=["port", "reference"])
def test_flipped_bit_fails_the_checksum(tmp_path, read):
    p = _journal(str(tmp_path / "j.jsonl"))
    lines = open(p).read().splitlines()
    assert '"tokens":[7,8]' in lines[1]
    lines[1] = lines[1].replace('"tokens":[7,8]', '"tokens":[7,9]')
    with open(p, "w") as f:
        f.write("\n".join(lines) + "\n")
    recs, clean = read(p)
    # the tampered record AND everything after it are dropped: a journal's
    # order is part of its meaning
    assert [r["kind"] for r in recs] == ["submit"] and not clean


# ---------------------------------------------------------------------------
# folding
# ---------------------------------------------------------------------------

def test_fold_to_state(tmp_path):
    p = str(tmp_path / "j.jsonl")
    j = SchedulerJournal(p)
    j.record_submit(0, [1, 2, 3], max_new=4, temperature=0.0, top_k=0,
                    stream=0)
    j.record_submit(1, [4, 5], max_new=2, temperature=0.9, top_k=5,
                    stream=1)
    j.record_progress(0, [10, 11])
    j.record_progress(0, [10, 11, 12])      # delta append
    j.record_progress(0, [10, 11, 12])      # no new tokens: no record
    j.record_terminal(1, "cancelled", "caller")
    j.record_terminal(1, "cancelled", "again")   # deduplicated
    state = SchedulerJournal.load(p)
    assert state.clean
    assert state.requests[0]["emitted"] == [10, 11, 12]
    assert state.requests[0]["prompt"] == [1, 2, 3]
    assert state.requests[1]["stream"] == 1
    assert state.terminals == {1: ("cancelled", "caller")}
    assert sorted(state.live()) == [0]
    assert len(artefacts.read_records(p)[0]) == 5


def test_evacuate_resets_and_shrinks_collect(tmp_path):
    p = str(tmp_path / "j.jsonl")
    j = SchedulerJournal(p)
    j.record_submit(0, [1], max_new=4, temperature=0.0, top_k=0, stream=0)
    j.record_progress(0, [10, 11])
    j.record_evacuate(0, host=1)
    # after an evacuation the request re-decodes from its prompt: the
    # writer's snapshot resets, so the re-emitted tokens are re-recorded
    j.record_progress(0, [10, 11, 12])
    j.record_shrink("data=8", "data=4", host=1, cause="drill")
    state = SchedulerJournal.load(p)
    assert state.evacuations == 1
    assert state.requests[0]["emitted"] == [10, 11, 12]
    assert [(s["frm"], s["to"]) for s in state.shrinks] == [
        ("data=8", "data=4")]


# ---------------------------------------------------------------------------
# replay into a fresh engine: token identity with the fault-free run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_replay_matches_the_fault_free_run(models, tmp_path, layout):
    reqs = port_requests(3)
    oracle = fresh(models, kv_layout=layout).run(reqs, seed=7)
    jpath = str(tmp_path / "j.jsonl")
    abandon(fresh(models, kv_layout=layout, journal=jpath), reqs, seed=7,
            chunks=2)
    state = SchedulerJournal.load(jpath)
    assert sorted(state.live()) == [0, 1, 2]
    # the journal holds what the crashed engine had emitted: a prefix
    assert all(r["emitted"] == oracle[rid][:len(r["emitted"])]
               and r["emitted"] for rid, r in state.requests.items())
    got = replay(jpath, fresh(models, kv_layout=layout), seed=7)
    assert [got[i] for i in range(3)] == oracle


def test_replay_mid_prefill_submit_only(models, tmp_path):
    """A crash before the first boundary: the journal holds bare submits;
    replay still owes, and reproduces, every token."""
    reqs = port_requests(2)
    oracle = fresh(models).run(reqs, seed=9)
    jpath = str(tmp_path / "j.jsonl")
    abandon(fresh(models, journal=jpath), reqs, seed=9, chunks=0)
    state = SchedulerJournal.load(jpath)
    assert all(r["emitted"] == [] for r in state.requests.values())
    got = replay(jpath, fresh(models), seed=9)
    assert [got[i] for i in range(2)] == oracle


def test_replay_skips_a_cancel_raced_request(models, tmp_path):
    reqs = port_requests(3)
    oracle = fresh(models).run(reqs, seed=11)
    jpath = str(tmp_path / "j.jsonl")
    abandon(fresh(models, journal=SchedulerJournal(jpath)), reqs, seed=11,
            chunks=1, cancel_rid=1)
    state = SchedulerJournal.load(jpath)
    assert state.terminals[1] == ("cancelled", "raced with the crash")
    got = replay(jpath, fresh(models), seed=11)
    # the cancelled request is terminal: replay owes it nothing
    assert sorted(got) == [0, 2]
    assert got[0] == oracle[0] and got[2] == oracle[2]


def test_duplicate_replay_is_idempotent(models, tmp_path):
    jpath = str(tmp_path / "j.jsonl")
    abandon(fresh(models, journal=jpath), port_requests(3), seed=13,
            chunks=2)
    a = replay(jpath, fresh(models), seed=13)
    b = replay(SchedulerJournal(jpath), fresh(models), seed=13)
    assert a == b


def test_replay_survives_a_torn_tail(models, tmp_path):
    reqs = port_requests(2)
    oracle = fresh(models).run(reqs, seed=15)
    jpath = str(tmp_path / "j.jsonl")
    abandon(fresh(models, journal=jpath), reqs, seed=15, chunks=1)
    with open(jpath, "a") as f:
        f.write('{"kind": "termi')     # the crash tore the last write
    state = SchedulerJournal.load(jpath)
    assert not state.clean
    got = replay(state, fresh(models), seed=15)
    assert [got[i] for i in range(2)] == oracle


def test_a_finished_run_journals_every_terminal(models, tmp_path):
    """Run to the end: each request's progress records add up to its
    tokens, each has one terminal record, and nothing is left to replay."""
    jpath = str(tmp_path / "j.jsonl")
    eng = fresh(models, journal=jpath)
    outs = eng.run(port_requests(3), seed=3)
    state = SchedulerJournal.load(jpath)
    assert state.clean and state.live() == {}
    assert {rid: r["emitted"] for rid, r in state.requests.items()} == dict(
        enumerate(outs))
    assert state.terminals == {i: ("ok", "") for i in range(3)}
    assert replay(jpath, fresh(models), seed=3) == {}


# ---------------------------------------------------------------------------
# journals across the packages
# ---------------------------------------------------------------------------

def _asdict(state):
    return json.loads(json.dumps(dataclasses.asdict(state)))


def test_a_port_journal_loads_in_the_reference(models, tmp_path):
    jpath = str(tmp_path / "j.jsonl")
    abandon(fresh(models, journal=jpath), port_requests(3), seed=7,
            chunks=2, cancel_rid=2)
    mine = SchedulerJournal.load(jpath)
    theirs = JaxJournal.load(jpath)
    assert isinstance(mine, JournalState)
    assert theirs.clean and sorted(theirs.live()) == [0, 1]
    assert _asdict(theirs) == _asdict(mine)


def test_a_reference_journal_loads_in_the_port(models, tmp_path):
    jmodel, jparams = models[:2]
    jpath = str(tmp_path / "j.jsonl")
    eng = JaxContinuous(jmodel, jparams, **ENGINE, journal=jpath)
    for i, r in enumerate(jax_requests(3)):
        eng.submit(r, stream=i)
    for _ in range(2):
        eng.step_chunk()
    eng.cancel(2, "raced with the crash")
    theirs = JaxJournal.load(jpath)
    mine = SchedulerJournal.load(jpath)
    assert mine.clean and sorted(mine.live()) == [0, 1]
    assert _asdict(mine) == _asdict(theirs)
    # the greedy request replays in the port to the reference's tokens
    # (sampled streams differ by design: torch generators, not threefry)
    want = JaxContinuous(jmodel, jparams, **ENGINE).run(jax_requests(3))
    got = replay(jpath, fresh(models))
    assert got[0] == [int(t) for t in want[0]]
