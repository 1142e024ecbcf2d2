"""The port's continuous-batching engine (repro_torch.serve.engine.
ContinuousEngine) on the CPU: greedy tokens identical to the reference's
ContinuousEngine in both KV layouts with a prompt split by
``prefill_chunk``; continuous equal to static in greedy and sampled mode;
the two sides of chunked prefill; the engine's API and bookkeeping.

Smoke qwen3-4b in float32 with the reference's params converted through
numpy; the reference runs under ``compiler.options(backend="pallas")``.
The reference engines are few and small (one module-scoped fixture,
max_seq 48)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compiler
from repro.configs import smoke_config as jax_smoke_config
from repro.models.transformer import Model as JaxModel
from repro.serve.engine import ContinuousEngine as JaxContinuous
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention as attn
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import Model
from repro_torch.serve.engine import (BatchedEngine, ContinuousEngine,
                                      Request, ShardedEngine, sample_tokens)

MAX_SEQ = 48
LENGTHS = (7, 21, 3, 12, 5)              # 21 > prefill_chunk: three chunks
MAX_NEW = (5, 3, 6, 4, 7)
TEMPS = (0.9, 0.0, 1.3, 0.7, 0.0)
TOP_KS = (5, 0, 0, 3, 0)
ENGINE = dict(max_seq=MAX_SEQ, slots=2, chunk=4, min_bucket=8,
              prefill_chunk=8)


@pytest.fixture(scope="module")
def setup():
    """(port model, port params, prompts, the reference ContinuousEngine's
    greedy tokens by layout)."""
    jcfg = dataclasses.replace(jax_smoke_config("qwen3_4b"), use_flash=True)
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = smoke_config("qwen3_4b", use_flash=True)
    params = params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 256, size=n) for n in LENGTHS]
    want = {}
    for layout in ("dense", "paged"):
        engine = JaxContinuous(jmodel, jparams, kv_layout=layout, **ENGINE)
        with compiler.options(backend="pallas"):
            want[layout] = engine.run(
                [JaxRequest(prompt=jnp.asarray(p), max_new_tokens=n)
                 for p, n in zip(prompts, MAX_NEW)])
    return Model(cfg), params, prompts, want


def _requests(prompts, sampled=False):
    return [Request(prompt=p.tolist(), max_new_tokens=n,
                    temperature=t if sampled else 0.0,
                    top_k=k if sampled else 0)
            for p, n, t, k in zip(prompts, MAX_NEW, TEMPS, TOP_KS)]


# ---------------------------------------------------------------------------
# tokens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_greedy_tokens_identical_to_jax_continuous_engine(setup, layout):
    """Five requests over two slots (admissions mid-run), one prompt of 21
    tokens prefilled in chunks of 8 across three boundaries."""
    model, params, prompts, want = setup
    engine = ContinuousEngine(model, params, kv_layout=layout, **ENGINE)
    assert engine.buckets[-1] == 8
    got = engine.run(_requests(prompts))
    assert got == want[layout]
    assert [len(o) for o in got] == list(MAX_NEW)
    assert engine.run(_requests(prompts)) == got      # engine reuse


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_continuous_equals_static(setup, layout, sampled):
    model, params, prompts, _ = setup
    reqs = _requests(prompts, sampled)
    want = BatchedEngine(model, params, max_seq=MAX_SEQ,
                         chunk=4).run(reqs, seed=7)
    engine = ContinuousEngine(model, params, kv_layout=layout, **ENGINE)
    assert engine.run(reqs, seed=7) == want
    if sampled:                    # the seed reaches the sampled requests
        other = engine.run(reqs, seed=8)
        assert other[1] == want[1] and other != want


def test_sampled_tokens_independent_of_slot_and_neighbours(setup):
    """A sampled request alone, or queued behind two others in a one-slot
    engine, receives the same tokens: they depend on its own stream only."""
    model, params, prompts, _ = setup
    reqs = _requests(prompts, sampled=True)
    alone = ContinuousEngine(model, params, **ENGINE).run(reqs[:1], seed=3)
    engine = ContinuousEngine(model, params, **{**ENGINE, "slots": 1})
    engine.run(reqs[3:4], seed=3)             # another run first
    for i, r in enumerate(reqs[1:3]):
        engine.submit(r, stream=10 + i)
    rid = engine.submit(reqs[0], stream=0)
    while not engine.sched.idle:
        engine.step_chunk()
    assert engine.take_output(rid) == alone[0]


def test_sample_tokens_chunk_form_equals_host_form():
    logits = torch.tensor(np.random.RandomState(0).randn(3, 50),
                          dtype=torch.float32)
    temps, top_ks = [0.0, 0.8, 1.5], [0, 4, 0]
    mk = lambda: [torch.Generator().manual_seed(i)  # noqa: E731
                  for i in range(3)]
    host = sample_tokens(logits, mk(), temps, top_ks)
    dev = sample_tokens(logits, mk(), torch.tensor(temps),
                        torch.tensor(top_ks), sampled=True)
    assert torch.equal(host, dev)
    assert int(host[0]) == int(logits[0].argmax())
    assert int(host[1]) in logits[1].topk(4).indices.tolist()
    with pytest.raises(ValueError, match="sampled="):
        sample_tokens(logits, mk(), torch.tensor(temps), torch.tensor(top_ks))


# ---------------------------------------------------------------------------
# chunked prefill: both sides of the split
# ---------------------------------------------------------------------------

def _chunked(model, params, prompt, attend_cache):
    cache = model.init_cache(1, MAX_SEQ, device="cpu")
    logits = None
    for start in range(0, len(prompt), 8):
        chunk = torch.tensor(prompt[None, start:start + 8])
        logits, cache = model.prefill(params, chunk, cache, start=start,
                                      attend_cache=attend_cache and start > 0)
    return logits, cache


def test_chunked_prefill_attends_to_the_whole_cache(setup):
    """Continuation chunks with ``attend_cache=True`` (and paged
    ``first=False``) give the single-call prefill's logits and cache; the
    plain ``attention_prefill`` at start > 0 attends within its chunk only
    and does not."""
    model, params, prompts, _ = setup
    prompt = prompts[1][:16]
    one = model.init_cache(1, MAX_SEQ, device="cpu")
    want, one = model.prefill(params, torch.tensor(prompt[None]), one)
    got, cache = _chunked(model, params, prompt, attend_cache=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(cache.k, one.k, rtol=1e-5, atol=1e-5)
    within, _ = _chunked(model, params, prompt, attend_cache=False)
    assert (within - want).abs().max() > 1e-2
    bt = torch.tensor([2, 0, 1])
    pool = model.init_paged_cache(1, MAX_SEQ, n_blocks=3, block_size=16,
                                  device="cpu")
    for start in (0, 8):
        paged_logits, _, _ = model.prefill_paged(
            params, torch.tensor(prompt[None, start:start + 8]), pool, bt,
            None, start, torch.tensor([8]), first=start == 0)
    torch.testing.assert_close(paged_logits, want, rtol=1e-5, atol=1e-5)


def test_prefill_projects_qkv_once(setup, monkeypatch):
    """Every prefill form projects q/k/v once a layer (the reference's
    attention_prefill projects twice)."""
    model, params, prompts, _ = setup
    calls = []
    real = attn._project_qkv
    monkeypatch.setattr(attn, "_project_qkv",
                        lambda *a: calls.append(1) or real(*a))
    toks = torch.tensor(prompts[1][None, :8])
    cache = model.init_cache(1, MAX_SEQ, device="cpu")
    pool = model.init_paged_cache(1, MAX_SEQ, n_blocks=3, block_size=16,
                                  device="cpu")
    bt = torch.tensor([0, 1, 2])
    forms = [lambda: model.prefill(params, toks, cache),
             lambda: model.prefill(params, toks, cache, start=8,
                                   attend_cache=True),
             lambda: model.prefill_paged(params, toks, pool, bt, None, 0,
                                         torch.tensor([8]), first=True),
             lambda: model.prefill_paged(params, toks, pool, bt, None, 8,
                                         torch.tensor([8]), first=False)]
    for form in forms:
        calls.clear()
        form()
        assert len(calls) == model.cfg.n_layers


# ---------------------------------------------------------------------------
# the engine's API and bookkeeping
# ---------------------------------------------------------------------------

def test_stats_results_and_no_leak_across_runs(setup):
    model, params, prompts, _ = setup
    engine = ContinuousEngine(model, params, kv_layout="paged", **ENGINE)
    free0 = engine.pool.free_blocks
    for seed in range(2):
        results = engine.run_results(_requests(prompts, True), seed=seed)
        assert all(r.state == "ok" and r.ttft_s > 0 for r in results)
    st = engine.stats()
    assert st["scheduler"]["admits"] == st["scheduler"]["retires"] == 10
    # one prefill call a chunk of 8: 21 tokens take three
    assert st["prefills"] == 2 * sum(-(-n // 8) for n in LENGTHS)
    assert st["decode_steps"] == 4 * st["chunks"]
    assert "captures" not in st            # the CPU runs the chunk eagerly
    assert engine.pool.free_blocks == free0 == st["kv_pool"]["free"]
    assert engine._staging == {} and engine._admit_logits == {}
    assert engine._requests == {} and engine.sched.outputs == {}


def test_block_starved_pool_defers_but_stays_identical(setup):
    model, params, prompts, want = setup
    starved = ContinuousEngine(model, params, kv_layout="paged",
                               block_size=16, kv_blocks=2, **ENGINE)
    assert starved.run(_requests(prompts)) == want["paged"]
    assert starved.stats()["scheduler"]["deferrals"] > 0
    assert starved.pool.free_blocks == 2


def test_cancel_while_prefilling(setup):
    """Cancel mid-chunked-prefill: the slot is released with the prompt only
    partly cached, and a later request admits cleanly."""
    model, params, prompts, _ = setup
    engine = ContinuousEngine(model, params, **{**ENGINE, "slots": 1})
    long_req, short = _requests(prompts)[1], _requests(prompts)[0]
    solo = engine.run([short])[0]
    rid_long = engine.submit(long_req)
    engine.step_chunk()                       # prefills 8 of 21 tokens
    assert engine.sched.slots[0].prefilling
    engine.cancel(rid_long)
    assert engine.sched.slots[0].free
    assert int(engine.st.pos[0]) == MAX_SEQ   # the lane is parked
    rid_short = engine.submit(short, stream=0)
    while not engine.sched.idle:
        engine.step_chunk()
    res = engine.take_result(rid_long)
    assert res.state == "cancelled" and res.tokens == ()
    assert list(engine.take_result(rid_short).tokens) == solo


def test_expired_deadline_times_out_with_partial_tokens(setup):
    model, params, prompts, _ = setup
    engine = ContinuousEngine(model, params, **ENGINE)
    late = dataclasses.replace(_requests(prompts)[0], ttft_deadline_s=0.0)
    rid = engine.submit(late)
    assert engine.step_chunk() == [rid]
    res = engine.take_result(rid)
    assert res.state == "timeout" and res.tokens == () and not res.ok


def test_request_checks_and_unported_options_raise(setup):
    model, params, _, _ = setup
    paged = ContinuousEngine(model, params, kv_layout="paged", block_size=16,
                             kv_blocks=2, **{**ENGINE, "max_seq": 64})
    with pytest.raises(ValueError, match="KV blocks"):
        paged.submit(Request(prompt=list(range(40)), max_new_tokens=8))
    with pytest.raises(ValueError, match="max_seq"):
        paged.submit(Request(prompt=list(range(60)), max_new_tokens=8))
    with pytest.raises(ValueError, match="divide"):
        ContinuousEngine(model, params, max_seq=60, kv_layout="paged",
                         block_size=16)
    with pytest.raises(ValueError, match="kv_layout"):
        ContinuousEngine(model, params, kv_layout="sparse")
    for kw, item in (({"resilience": object()}, "item 4"),
                     ({"journal": "j.log"}, "item 4")):
        with pytest.raises(NotImplementedError, match=item):
            ContinuousEngine(model, params, **kw)
    with pytest.raises(NotImplementedError, match="item 6"):
        ShardedEngine(model, params)


def test_kv_layout_auto_and_tuning_cache(setup, tmp_path, monkeypatch):
    """``kv_layout="auto"`` takes the layout the reference's planner picks
    for this model and engine shape and serves that layout's tokens;
    ``tuning_cache=`` scopes the engine's runs to that cache and layout
    and audits the cache at the warm boundary.  The engine pre-tunes and
    stages nothing (its model path runs no DPIA row): the cache holds the
    layout decision alone and no AOT store is written."""
    from repro import autotune as jautotune
    from repro_torch import autotune, compiler
    model, params, prompts, want = setup
    # the reference plans for the CPU here: so does the port on any machine
    monkeypatch.setattr(autotune.cost, "default_platform", lambda: "cpu")
    cache = str(tmp_path / "t.json")
    engine = ContinuousEngine(model, params, kv_layout="auto",
                              tuning_cache=cache, **ENGINE)
    pick = autotune.pick_kv_layout(model.cfg, slots=ENGINE["slots"],
                                   max_seq=MAX_SEQ, cache=cache)
    jpick = jautotune.pick_kv_layout(
        jax_smoke_config("qwen3_4b"), slots=ENGINE["slots"],
        max_seq=MAX_SEQ, platform="cpu", cache=str(tmp_path / "j.json"))
    assert engine.kv_layout == pick["layout"] == jpick["layout"]
    seen = []
    real = model.decode_step

    def decode_step(*a, **kw):
        opts = compiler.current_options()
        seen.append((opts.tuning_cache, opts.kv_layout))
        return real(*a, **kw)
    monkeypatch.setattr(model, "decode_step", decode_step)
    assert engine.run(_requests(prompts)) == want[engine.kv_layout]
    assert seen and set(seen) == {(cache, engine.kv_layout)}
    assert [k.split("|")[0] for k in autotune.TuningCache(cache).keys()] \
        == ["kv_layout"]
    assert not (tmp_path / "t.json.aot").exists()
    assert engine._drift_audited


def test_launcher_serves_continuous_paged_on_the_cpu(capsys):
    outs = launch_serve.main([
        "--arch", "qwen3_4b", "--smoke", "--device", "cpu", "--engine",
        "continuous", "--kv-layout", "paged", "--slots", "2", "--batch",
        "3", "--prompt-len", "20", "--prefill-chunk", "8", "--max-new",
        "5", "--temperature", "0.7"])
    assert [len(o) for o in outs] == [5, 5, 5]
    out = capsys.readouterr().out
    assert "engine=continuous" in out and "kv_layout=paged" in out
    assert "time to first token" in out
