"""The port's sharded serving (``repro_torch.serve.engine.ShardedEngine``,
``repro_torch.serve.domains.FailureDomains`` / ``HostEvent`` /
``retune_for_mesh``, ``repro_torch.ft.resilience.elastic_remesh``) on the
CPU, held against the reference.

The reference's own sharded drills (``tests/test_domains.py``, forced 8
devices) do not run under this JAX, so the oracle is the reference's
single-device ``ContinuousEngine`` (which the reference holds its
``ShardedEngine`` token-identical to) and the port's own
``ContinuousEngine``.  Greedy requests compare across the packages;
sampled ones only within the port (its streams are torch generators, not
threefry keys).

The model and traffic are the reference drills': 2 layers, d_model 32,
4 / 2 heads, d_ff 64, vocab 128, float32; 8 requests (prompts 3-12
tokens, 16 new tokens, chunk 4) on 8 slots.  The parent computes the
oracles; one spawn of 4 gloo ranks (``tests/_sharded_ranks.py``, which
imports only ``repro_torch``) runs the clean runs and every drill in
sequence, given the reference's weights as numpy arrays.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _sharded_ranks as R
from repro.autotune import TuningCache as JaxTuningCache
from repro.models.common import ModelConfig as JaxConfig
from repro.models.transformer import Model as JaxModel
from repro.serve import domains as jdomains
from repro.serve.engine import ContinuousEngine as JaxContinuous
from repro.serve.engine import Request as JaxRequest
from repro.testing import faults as jfaults
from repro_torch.autotune import TuningCache
from repro_torch.ft.resilience import elastic_remesh
from repro_torch.serve import domains
from repro_torch.serve.engine import ContinuousEngine
from repro_torch.testing import faults, ranks

WORLD = 4
GREEDY = [i for i, (_, t, _) in enumerate(R.SPEC) if t == 0.0]
LAYOUTS = ("dense", "paged")
DRILLS = ("loss", "loss_paged", "staged_dense", "staged_paged", "timeout",
          "slow", "nccl_dense", "nccl_paged")


@pytest.fixture(scope="module")
def weights():
    """(reference model, reference params, numpy params)."""
    jmodel = JaxModel(JaxConfig(**R.TINY))
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    return jmodel, jparams, jax.tree_util.tree_map(np.asarray, jparams)


@pytest.fixture(scope="module")
def reference(weights):
    """The reference ContinuousEngine's tokens on the drill traffic."""
    jmodel, jparams, _ = weights
    reqs = [JaxRequest(jnp.asarray(p, jnp.int32), max_new_tokens=R.MAX_NEW,
                       temperature=t, top_k=k)
            for p, (_, t, k) in zip(R.prompts(), R.SPEC)]
    eng = JaxContinuous(jmodel, jparams, **R.ENGINE)
    return eng.run(reqs, key=jax.random.PRNGKey(R.SEED))


def _single(np_params, plan=(), **kw):
    model, params = R.model_and_params(np_params)
    eng = ContinuousEngine(model, params, **{**R.ENGINE, **kw})
    with faults.inject(*plan):
        out = [(r.tokens, r.state, r.reason)
               for r in eng.run_results(R.requests(), seed=R.SEED)]
    return out, eng.stats()


@pytest.fixture(scope="module")
def oracle(weights):
    """The port's single-process ContinuousEngine on the same traffic:
    results by layout (and by layout with a prompt split into chunks of
    4), and under each serving fault plan."""
    np_params = weights[2]
    out = {layout: _single(np_params, kv_layout=layout)
           for layout in LAYOUTS}
    out.update({f"staged_{layout}": _single(np_params, kv_layout=layout,
                                            **R.STAGED)
                for layout in LAYOUTS})
    out["faults"] = _single(np_params, [R.FAULTS])
    out["chunk_error"] = _single(np_params, [R.CHUNK_ERROR])
    return out


@pytest.fixture(scope="module")
def port(weights, tmp_path_factory):
    """Every rank's results of ``_sharded_ranks.rank_work``, and the
    directory its journals went to."""
    tmp = str(tmp_path_factory.mktemp("sharded"))
    return ranks.spawn(R.rank_work, WORLD, args=(weights[2], tmp),
                       timeout=240), tmp


def tokens(results):
    return [list(t) for t, _, _ in results]


def oracle_of(drill):
    return "staged_" + drill.split("_")[1] if drill.startswith("staged") \
        else ("paged" if drill.endswith("paged") else "dense")


# ---------------------------------------------------------------------------
# the clean run on 4 ranks (data=4, hosts=2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
def test_clean_greedy_tokens_equal_the_reference(port, reference, layout):
    for res in port[0]:
        got = tokens(res[f"clean_{layout}"]["results"])
        assert [got[i] for i in GREEDY] == [reference[i] for i in GREEDY]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_clean_results_equal_the_ports_continuous_engine(port, oracle,
                                                         layout):
    """Every request, sampled ones included, on every rank: the scheduler's
    outputs are the same everywhere."""
    want, _ = oracle[layout]
    for res in port[0]:
        assert res[f"clean_{layout}"]["results"] == want


@pytest.mark.parametrize("layout", LAYOUTS)
def test_clean_run_is_silent(port, layout):
    """As the reference's ``CLEAN_OK``: no flight dump, no degradation, no
    loss, no evacuation; the mesh as built."""
    for res in port[0]:
        r = res[f"clean_{layout}"]
        assert r["dumps"] == [] and "degraded" not in r["explain"]
        assert r["resilience"]["host_losses"] == 0
        assert r["resilience"]["degradations"] == 0
        assert r["scheduler"]["evacuations"] == 0
        mesh = r["mesh"]
        assert (mesh["descriptor"], mesh["shards"], mesh["devices"],
                mesh["axis"], mesh["lanes"]) == ("data=4", 4, 4, "data", 2)
        assert mesh["index"] == res["rank"]
        assert mesh["hosts"]["alive"] == [0, 1]
        assert mesh["hosts"]["groups"] == [[0, 1], [2, 3]]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_one_all_gather_per_boundary(port, layout):
    """The boundary's exchange is the run's only collective: one
    ``all_gather`` a boundary, no other call into torch.distributed."""
    for res in port[0]:
        r = res[f"clean_{layout}"]
        assert r["collectives"] == {"all_gather": r["boundaries"]}
        assert r["mesh"]["boundary_gathers"] == r["boundaries"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_each_prompt_prefills_once_on_its_owner(port, oracle, layout):
    """Each rank prefills only its own slots: the ranks' prefill calls add
    up to the single engine's."""
    _, stats = oracle[layout]
    assert sum(res[f"clean_{layout}"]["prefills"]
               for res in port[0]) == stats["prefills"]


def test_run_and_auto_hosts(port, oracle):
    """``run()`` as a user calls it; ``hosts="auto"`` on one machine is
    one host."""
    want = tokens(oracle["dense"][0])
    for res in port[0]:
        assert res["run"] == want
        assert res["auto_hosts"]["n_hosts"] == 1
        assert res["auto_hosts"]["groups"] == [[0, 1, 2, 3]]


def test_mesh_from_the_context_and_a_second_axis(port, oracle):
    """``mesh=None`` takes the process mesh (``sharding.ctx``); on a
    ``(data=2, model=2)`` mesh the ranks of one data position hold the same
    slots and every rank serves the same tokens."""
    want, _ = oracle["dense"]
    for res in port[0]:
        assert res["ctx_mesh"] == "data=4"
        r = res["two_axes"]
        assert r["results"] == want
        assert (r["mesh"]["descriptor"], r["mesh"]["shards"],
                r["mesh"]["devices"], r["mesh"]["lanes"]) == \
            ("data=2,model=2", 2, 4, 4)
        assert r["mesh"]["index"] == res["rank"] // 2


def test_weights_that_differ_across_ranks_raise(port):
    """Rank 1 holds other weights: the build-time checksum gather makes
    every rank raise, naming the position that differs."""
    msgs = [res["other_weights"] for res in port[0]]
    assert all(m is not None and "weights differ" in m for m in msgs)
    assert "positions [1]" in msgs[0] and "positions [0, 2, 3]" in msgs[1]


def test_elastic_remesh_on_four_ranks(port):
    for res in port[0]:
        assert res["remesh"] == {"data=16": {"data": 4},
                                 "data=4": {"data": 4}}
        assert res["remesh_tuple"] == (4,)
        assert res["remesh_three"] == \
            ((3,), None if res["rank"] == 3 else (res["rank"],))


def test_failure_domains_on_the_live_mesh(port):
    for res in port[0]:
        d = res["domains"]
        assert d["groups"] == ((0, 1), (2, 3)) and d["ranks"] == [0, 1, 2, 3]
        assert d["slots_of_host"] == [[0, 1, 2, 3], [4, 5, 6, 7]]


# ---------------------------------------------------------------------------
# the reference's drills, carried over to 4 ranks
# ---------------------------------------------------------------------------

# drill -> (the lost host, the ranks that serve on)
LOST = {"loss": (1, [0, 1]), "loss_paged": (1, [0, 1]),
        "staged_dense": (1, [0, 1]), "staged_paged": (1, [0, 1]),
        "timeout": (1, [0, 1]), "slow": (0, [2, 3]),
        "nccl_dense": (1, [0, 1]), "nccl_paged": (1, [0, 1])}


def expected(oracle, drill):
    """The fault-free results a drill must end with."""
    want = list(oracle[oracle_of(drill)][0])
    if drill == "nccl_paged":           # request 0 ends at its 2nd token
        toks, state, reason = want[0]
        want[0] = (toks[:R.NCCL_SHORT], state, reason)
    return want


@pytest.mark.parametrize("drill", DRILLS)
def test_drill_survivors_end_token_identical(port, oracle, drill):
    """The evacuees re-decode on ``data=2`` to the fault-free tokens; the
    ranks of the lost host leave with no results."""
    host, alive = LOST[drill]
    want = expected(oracle, drill)
    for res in port[0]:
        r = res[drill]
        if res["rank"] in alive:
            assert r["results"] == want and not r["left"]
        else:
            assert r["results"] is None and r["left"]


@pytest.mark.parametrize("drill", DRILLS + ("faults", "chunk_error"))
def test_every_rank_sees_the_same_firings(port, drill):
    """A fault plan is each rank's own: given the same plan, every rank
    fires each fault as often, at the same boundary, and ends with the same
    host map and terminal states."""
    runs = [res[drill] for res in port[0]]
    for r in runs[1:]:
        assert r["fired"] == runs[0]["fired"]
        assert r["mesh"].get("hosts") == runs[0]["mesh"].get("hosts")
        assert r["resilience"] == runs[0]["resilience"]
    done = [r["results"] for r in runs if r["results"] is not None]
    assert done and all(d == done[0] for d in done)


@pytest.mark.parametrize("drill", DRILLS)
def test_drill_shrinks_the_mesh(port, drill):
    host, alive = LOST[drill]
    for res in port[0]:
        r = res[drill]
        # the straggler strikes twice before it escalates
        assert r["fired"] == [2 if drill == "slow" else 1]
        assert r["mesh"]["hosts"]["lost"] == [host]
        assert r["mesh"]["hosts"]["alive"] == [1 - host]
        assert r["resilience"]["host_losses"] == 1
        if res["rank"] in alive:
            assert r["mesh"]["descriptor"] == "data=2"
            # the survivors re-rank: the first alive rank is index 0
            assert r["mesh"]["index"] == alive.index(res["rank"])
            assert r["mesh"]["lanes"] == 4


@pytest.mark.parametrize("drill", DRILLS)
def test_drill_records_one_host_lost_dump_and_the_origin(port, drill):
    _, alive = LOST[drill]
    for res in port[0]:
        if res["rank"] not in alive:
            continue
        r = res[drill]
        assert r["dumps"] == ["host_lost"]
        assert r["dump_ctx"][0]["to"] == "data=2"
        assert "degraded(mesh(data=4)->mesh(data=2))" in r["explain"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_nccl_route_hands_every_gather_the_engines_device(port, layout):
    """With the groups taken for NCCL's, every gather (the build's weight
    checksum, each boundary's, the survivors' re-placement) gets its input
    and outputs on the engine's device, never a host tensor the engine's
    card could not send (on the card the device is a GPU:
    ``tests/test_torch_cuda.py``)."""
    for res in port[0]:
        r = res[f"nccl_{layout}"]
        assert len(r["gathers"]) == r["collectives"]["all_gather"] + 1
        for device, outs, _, _ in r["gathers"]:
            assert (device, outs) == (r["device"], [r["device"]])


def test_paged_handoff_sends_the_live_pages_only(port):
    """At the loss rank 0's slot 0 is free (its request ended), so it owns
    half the live pages rank 1 does: each survivor's re-placement buffer
    holds the most live pages a survivor owns (rank 0's padded), far less
    than the page pool, and the evacuee re-admitted into slot 0 ends
    token-identical (``test_drill_survivors_end_token_identical``)."""
    survivors = [res["nccl_paged"] for res in port[0] if res["rank"] < 2]
    handoffs = [[n for _, _, dtype, n in r["gathers"]
                 if dtype == "torch.uint8"] for r in survivors]
    assert all(len(h) == 1 for h in handoffs)
    assert handoffs[0] == handoffs[1]
    assert handoffs[0][0] < survivors[0]["pool_bytes"] / 4


def test_host_loss_evacuates_host_ones_slots(port):
    """``host_lost(host=1, after=3)``: all 8 requests in flight, host 1's
    four slots go back to the queue; one gather a boundary throughout."""
    for res in port[0]:
        r = res["loss"]
        assert r["scheduler"]["evacuations"] == 4
        # a survivor's re-placement gathers once more; a leaving rank's
        # last boundary gathers nothing
        assert r["collectives"] == {"all_gather": r["boundaries"]
                                    + (1 if res["rank"] in (0, 1) else -1)}


def test_uneven_loss_drops_hosts_from_the_tail(port, oracle):
    """One rank a host: losing host 3 leaves 3 positions for 8 slots, so
    host 2 goes too (the reference's tail-dropping loop): ``data=2`` on
    ranks 0 and 1, one host-loss event, two hosts marked lost."""
    want, _ = oracle["dense"]
    for res in port[0]:
        r = res["tail"]
        assert r["mesh"]["hosts"]["lost"] == [2, 3]
        assert r["mesh"]["hosts"]["losses"] == 2
        assert r["resilience"]["host_losses"] == 1
        if res["rank"] < 2:
            assert r["results"] == want
            assert r["mesh"]["descriptor"] == "data=2"
            assert r["scheduler"]["evacuations"] == 4
        else:
            assert r["results"] is None and r["left"]


def test_a_second_shrink_raises(port):
    """The ranks that left at the first shrink cannot take part in the
    second's ``new_group``: the survivors raise, naming the rendezvous it
    would need, instead of waiting on them."""
    for res in port[0]:
        err = res["second"]["error"]
        if res["rank"] < 2:
            assert err is not None and "new rendezvous" in err
        else:
            assert err is None and res["second"]["left"]


def test_host_loss_retunes_for_the_shrunk_descriptor(port):
    for res in port[0]:
        if res["rank"] in (0, 1):
            assert "data=2" in res["loss"]["tuned_descriptors"]


@pytest.mark.parametrize("drill", ("loss", "slow"))
def test_host_loss_journals(port, oracle, drill):
    """Each rank journals to a file of its own: a survivor's holds the
    whole run (one shrink record, the evacuations, every request ok with
    its fault-free tokens); a lost rank's stops before the loss."""
    host, alive = LOST[drill]
    want = tokens(oracle["dense"][0])
    for res in port[0]:
        j = res[drill]["journal"]
        assert j["clean"]
        if res["rank"] not in alive:
            assert j["shrinks"] == [] and j["terminals"] == {}
            continue
        assert j["evacuations"] == 4
        assert [(s["frm"], s["to"], s["host"]) for s in j["shrinks"]] == \
            [("data=4", "data=2", host)]
        assert j["terminals"] == {rid: "ok" for rid in range(8)}
        assert [j["emitted"][rid] for rid in range(8)] == want


@pytest.mark.parametrize("drill", ("faults", "chunk_error"))
def test_serving_faults_equal_the_single_engine(port, oracle, drill):
    """A NaN prompt and a NaN cache (quarantined), and a chunk failure past
    its retries (in-flight requests fail, the buffers are rebuilt): the
    same states, reasons, tokens and counters as one process."""
    want, stats = oracle[drill]
    for res in port[0]:
        r = res[drill]
        assert r["results"] == want
        assert {k: v for k, v in r["resilience"].items()
                if k != "host_losses"} == stats["resilience"]


def test_deadline_on_the_mesh_clock(port, oracle):
    """Request 3's deadline expires at the same boundary on every rank;
    the others are served as without it."""
    got = [res["deadline"] for res in port[0]]
    assert all(g == got[0] for g in got)
    want = oracle["dense"][0]
    assert got[0][3][1] == "timeout"
    assert [g for i, g in enumerate(got[0]) if i != 3] == \
        [w for i, w in enumerate(want) if i != 3]


# ---------------------------------------------------------------------------
# a journal written through a host loss, replayed in one process
# ---------------------------------------------------------------------------

def test_journal_after_host_loss_replays_in_the_port(port, oracle, weights):
    results, tmp = port
    assert not results[0]["replay_left"] and results[2]["replay_left"]
    path = os.path.join(tmp, "replay.jsonl.rank0")
    state = domains.SchedulerJournal.load(path)
    assert state.clean and len(state.shrinks) == 1
    assert len(state.live()) == 8
    model, params = R.model_and_params(weights[2])
    got = domains.replay(path, ContinuousEngine(model, params, **R.ENGINE),
                         seed=R.SEED)
    assert [got[rid] for rid in range(8)] == tokens(oracle["dense"][0])


def test_journal_after_host_loss_replays_in_the_reference(port, reference,
                                                          weights):
    """The reference reads the port's journal and replays it to its own
    tokens (the greedy ones are the port's too)."""
    jmodel, jparams, _ = weights
    path = os.path.join(port[1], "replay.jsonl.rank0")
    got = jdomains.replay(path, JaxContinuous(jmodel, jparams, **R.ENGINE),
                          key=jax.random.PRNGKey(R.SEED))
    assert [got[rid] for rid in range(8)] == reference


# ---------------------------------------------------------------------------
# FailureDomains' logic and HostEvent against the reference, in process
# ---------------------------------------------------------------------------

def _same(fn_port, fn_ref):
    """Both calls return equal values, or raise the same error type with
    the same message."""
    def run(fn):
        try:
            return ("ok", fn())
        except Exception as e:           # noqa: BLE001
            return (type(e).__name__, str(e))
    a, b = run(fn_port), run(fn_ref)
    assert a == b, (a, b)


JFD = jdomains.FailureDomains
TFD = domains.FailureDomains


@pytest.mark.parametrize("n,hosts", [(8, 2), (8, 4), (4, 1), (8, 8), (8, 3),
                                     (8, 0), (6, 4)])
def test_partition_equals_the_reference(n, hosts):
    _same(lambda: TFD.partition(n, hosts), lambda: JFD.partition(n, hosts))


@pytest.mark.parametrize("n,hosts,alive,host,slots", [
    (8, 2, [True, True], 0, 8), (8, 2, [True, True], 1, 16),
    (8, 4, [True, False, True, True], 2, 12),
    (8, 4, [True, False, True, True], 1, 12),
    (8, 2, [False, True], 1, 8), (4, 2, [True, False], 0, 7),
    (8, 4, [True, True, False, False], 0, 8),
    (8, 4, [False, False, True, True], 3, 8)])
def test_slots_for_equals_the_reference(n, hosts, alive, host, slots):
    """Attribution after losses re-ranks the surviving positions; an
    indivisible slot count raises alike."""
    _same(lambda: TFD.slots_for(TFD.partition(n, hosts), alive, host, slots),
          lambda: JFD.slots_for(JFD.partition(n, hosts), alive, host, slots))


def test_host_event_fields_equal_the_reference():
    import dataclasses
    assert [f.name for f in dataclasses.fields(domains.HostEvent)] == \
        [f.name for f in dataclasses.fields(jdomains.HostEvent)]
    assert dataclasses.asdict(domains.HostEvent("slow", 1, "c", 0.5)) == \
        dataclasses.asdict(jdomains.HostEvent("slow", 1, "c", 0.5))


def _pair(n=4, hosts=2, **kw):
    """Port domains on an axis -> size dict; the reference's on one
    device with the same groups, as its own tests build them."""
    t = TFD({"data": n}, hosts=hosts, **kw)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))
    j = JFD(mesh, hosts=1, **kw)
    j.groups = JFD.partition(n, hosts)
    j.alive = [True] * hosts
    return t, j


@pytest.mark.parametrize("spec", [
    "mesh.host_slow(host=0, times=3, value=0.01)",
    "mesh.host_lost(host=1, after=1)", "collective.timeout(value=0)",
    "collective.timeout", "mesh.host_slow(host=1, times=-1)"])
def test_poll_equals_the_reference(spec):
    """Four boundaries under the same plan: the same events in order (the
    slow strikes escalate at the threshold, the timeout's scapegoat is the
    last alive host unless named), the same marks."""
    t, j = _pair(slow_threshold=3)
    got = {}
    for side, dom, fx in (("port", t, faults), ("ref", j, jfaults)):
        evs = []
        with fx.inject(spec):
            for _ in range(4):
                ev = dom.poll()
                evs.append(None if ev is None else
                           (ev.kind, ev.host, ev.delay_s))
                if ev is not None and ev.kind == "lost" and \
                        len(dom.alive_hosts()) > 1:
                    dom.mark_lost(ev.host)
        got[side] = (evs, dom.describe())
    assert got["port"] == got["ref"]


def test_mark_lost_and_errors_equal_the_reference():
    t, j = _pair()
    for dom in (t, j):
        dom.mark_lost(1)
        dom.mark_lost(1)
    assert t.describe() == j.describe() and t.n_losses == 1
    _same(lambda: t.mark_lost(0), lambda: j.mark_lost(0))
    _same(lambda: TFD({"data": 4}, axis="model"),
          lambda: JFD(jax.sharding.Mesh(np.asarray(jax.devices()[:1]),
                                        ("data",)), axis="model"))
    _same(lambda: TFD({"data": 4}, slow_threshold=0),
          lambda: JFD(jax.sharding.Mesh(np.asarray(jax.devices()[:1]),
                                        ("data",)), slow_threshold=0))
    with pytest.raises(ValueError, match="single-axis"):
        TFD({"data": 2, "model": 2})
    with pytest.raises(ValueError, match="DeviceMesh"):
        t.shrunk_mesh()


def test_poll_is_none_without_a_plan():
    assert TFD({"data": 1}).poll() is None
    assert TFD({"data": 1}).describe()["groups"] == [[0]]


def test_retune_for_mesh_equals_the_reference(tmp_path):
    """The same shapes tuned for ``data=2`` (those with no placement
    skipped); a later tune of the shrunk mesh is a cache hit."""
    from repro_torch import autotune
    from repro_torch.models.common import ModelConfig
    cfg, jcfg = ModelConfig(**R.TINY), JaxConfig(**R.TINY)
    tc = TuningCache(str(tmp_path / "tc.json"))
    n = domains.retune_for_mesh(cfg, "data=2", max_seq=64,
                                batch_sizes=(1, 8), cache=tc)
    jn = jdomains.retune_for_mesh(
        jcfg, "data=2", max_seq=64, batch_sizes=(1, 8),
        cache=JaxTuningCache(str(tmp_path / "jtc.json")))
    assert n == jn > 0
    assert sorted({k.rsplit("|", 1)[-1] for k in tc._mem}) == ["data=2"]
    kernel, shape = next(iter(autotune.model_kernel_shapes(
        cfg, max_seq=64, batch_sizes=(8,))))
    assert autotune.tune(kernel, backend="shardmap", mesh="data=2", cache=tc,
                         measure=False, **shape).source == "cache"


@pytest.mark.parametrize("call,err", [
    (lambda: elastic_remesh("data=8", ("data",)), TypeError),
    (lambda: elastic_remesh((4, 1)), TypeError),
    (lambda: elastic_remesh("single"), ValueError)])
def test_elastic_remesh_errors_equal_the_reference(call, err):
    from repro.ft.resilience import elastic_remesh as jremesh
    ref = {TypeError: [lambda: jremesh("data=8", ("data",)),
                       lambda: jremesh((4, 1))],
           ValueError: [lambda: jremesh("single")]}[err]
    with pytest.raises(err) as got:
        call()
    for r in ref:
        try:
            r()
        except err as want:
            if str(want) == str(got.value):
                return
    raise AssertionError(f"no reference error reads {got.value}")
