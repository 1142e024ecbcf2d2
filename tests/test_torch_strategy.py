"""The port's strategy language (repro_torch.strategy) and its strategy
spaces (repro_torch.autotune.space), held against the reference's
(repro.strategy, repro.autotune.space) on the CPU: the combinator laws, the
traversals, trace documents (JSON round trip, replay, and a document made
by one package replayed in the other), the spaces against the legacy
builders, mining and seeding, the hardened ``strategies.search``, and the
derivation carried through tune, Program and the AOT store.

Structural identity is ``strategy.fingerprint`` (binder-stable; equal
strings across the two packages for the same term).  Stage II texts are
compared after renumbering fresh-name suffixes, as in test_torch_dpia.py.
Every tuning cache is a file under ``tmp_path``."""
import json
import warnings

import numpy as np
import pytest
import torch

from repro import strategy as jst
from repro.autotune import space as jspace
from repro.core.dpia import phrases as jP
from repro.core.dpia import pretty as jpretty
from repro.core.dpia import stage1 as jstage1
from repro.core.dpia import stage2 as jstage2
from repro.core.dpia import types as jT
from repro.strategy import mine as jmine
from repro_torch import autotune, compiler, obs
from repro_torch import strategy as st
from repro_torch.autotune import space
from repro_torch.core.dpia import interp, phrases as P, strategies
from repro_torch.core.dpia import pretty as tpretty
from repro_torch.core.dpia import stage1 as tstage1
from repro_torch.core.dpia import stage2 as tstage2
from repro_torch.core.dpia import types as tT
from repro_torch.core.dpia.types import Arr, Num
from repro_torch.kernels import dpia_blas, ops
from repro_torch.strategy import mine
from test_torch_dpia import normalise


def fp(e):
    return st.fingerprint(e)


def naive_dot(n=64):
    return dpia_blas.naive_dot(n)


FUSE = st.rule("fuse_map_into_reduce")
BLOCK = st.rule("blocked_reduce", block=16, partial_level="grid(0)",
                combine="add")


# ---------------------------------------------------------------------------
# combinator laws (failure as a value, monoid structure)
# ---------------------------------------------------------------------------

def test_seq_identity_laws():
    e, _ = naive_dot()
    direct = FUSE.apply(e)
    left = st.seq(st.id_(), FUSE).apply(e)
    right = st.seq(FUSE, st.id_()).apply(e)
    assert direct.ok and left.ok and right.ok
    assert fp(direct.phrase) == fp(left.phrase) == fp(right.phrase)
    assert direct.trace.to_doc() == left.trace.to_doc() \
        == right.trace.to_doc()
    empty = st.seq().apply(e)
    assert empty.ok and fp(empty.phrase) == fp(e) and not empty.trace.steps


def test_seq_fails_when_any_half_fails():
    e, _ = naive_dot()
    assert not st.seq(st.fail_(), FUSE).apply(e)
    r = st.seq(FUSE, st.fail_()).apply(e)
    assert not r.ok and r.phrase is None and r.reason


def test_alt_is_left_biased_and_try_fail_is_identity():
    e, _ = naive_dot()
    both = st.alt(FUSE, st.id_()).apply(e)
    assert both.ok and both.trace.steps
    fell = st.alt(st.fail_(), st.id_()).apply(e)
    assert fell.ok and fp(fell.phrase) == fp(e)
    tried = st.try_(st.fail_()).apply(e)
    assert tried.ok and fp(tried.phrase) == fp(e) and not tried.trace.steps
    assert (FUSE >> st.id_()).name == st.seq(FUSE, st.id_()).name
    assert (st.fail_() | FUSE).apply(e).ok


def test_rule_failure_is_a_value_not_an_exception():
    e, _ = naive_dot()
    r = st.rule("tile_matmul", bm=8, bk=8).apply(e)
    assert not r.ok and r.reason
    with pytest.raises(ValueError, match="unknown rule"):
        st.rule("no_such_rule")


def test_repeat_terminates_and_repeat_n_counts():
    e, _ = naive_dot()
    r = st.repeat(st.id_()).apply(e)
    assert r.ok and fp(r.phrase) == fp(e)
    r2 = st.repeat(st.fail_()).apply(e)
    assert r2.ok and not r2.trace.steps
    r3 = st.repeat(FUSE).apply(e)
    assert [s.rule for s in r3.trace.steps] == ["fuse_map_into_reduce"]
    assert st.repeat_n(FUSE, 1).apply(e).ok
    assert not st.repeat_n(FUSE, 2).apply(e)


@pytest.mark.parametrize("level", ["seq", "par", "lanes", "grid(0)",
                                   "grid(2)", "mesh(x)"])
def test_par_strings_are_the_references(level):
    assert st.lang.par_to_str(st.lang.par_from_str(level)) == level
    assert repr(st.lang.par_from_str(level)) == repr(
        jst.lang.par_from_str(level))
    with pytest.raises(ValueError):
        st.lang.par_from_str("warp(0)")


# ---------------------------------------------------------------------------
# traversals: order, paths, HOAS binders
# ---------------------------------------------------------------------------

def test_topdown_vs_bottomup_first_match():
    e, _ = naive_dot(64)
    blocked = st.seq(FUSE, BLOCK).apply(e)
    top = st.topdown(st.rule("vpu_reduce")).apply(blocked.phrase)
    bot = st.bottomup(st.rule("vpu_reduce")).apply(blocked.phrase)
    assert top.ok and bot.ok
    assert top.trace.steps[-1].path == ()
    assert bot.trace.steps[-1].path == ("e", "f")
    assert fp(top.phrase) != fp(bot.phrase)


def test_bottomup_rewrites_under_binders():
    e, _ = naive_dot(64)
    res = st.seq(FUSE, BLOCK, st.bottomup(st.rule("vpu_reduce"))).apply(e)
    rng = np.random.RandomState(0)
    xs = rng.randn(64).astype("float32")
    ys = rng.randn(64).astype("float32")
    got = interp.interp(res.phrase, {"xs": torch.from_numpy(xs),
                                     "ys": torch.from_numpy(ys)})
    np.testing.assert_allclose(float(got), xs @ ys, rtol=1e-5)


def test_at_one_and_all():
    e, _ = naive_dot(64)
    blocked = st.seq(FUSE, BLOCK).apply(e)
    r = st.at(("e", "f"), st.rule("vpu_reduce")).apply(blocked.phrase)
    bot = st.bottomup(st.rule("vpu_reduce")).apply(blocked.phrase)
    assert r.ok and fp(r.phrase) == fp(bot.phrase)
    assert not st.at(("e",), st.rule("vpu_reduce")).apply(blocked.phrase)
    x = P.var_exp("x", Arr(8, Num()))
    assert not st.one(st.id_()).apply(x)
    assert st.all_(st.fail_()).apply(x).ok


# ---------------------------------------------------------------------------
# traces: JSON round trip, replay, and across the two packages
# ---------------------------------------------------------------------------

def _program(S):
    return S.seq(S.rule("fuse_map_into_reduce"),
                 S.rule("blocked_reduce", block=16, partial_level="grid(0)",
                        combine="add"),
                 S.bottomup(S.rule("vpu_reduce")))


def test_trace_json_round_trip_and_replay():
    e, _ = naive_dot(64)
    res = _program(st).apply(e)
    doc = json.loads(json.dumps(res.trace.to_doc()))
    assert st.is_trace_doc(doc) and doc["version"] == 1
    assert st.StrategyTrace.from_doc(doc).to_doc() == res.trace.to_doc()
    replayed = st.replay(doc, e)
    assert replayed.ok and fp(replayed.phrase) == fp(res.phrase)
    assert replayed.trace.to_doc() == res.trace.to_doc()
    bad = {"version": 1, "steps": [{"rule": "no_such_rule", "path": [],
                                    "params": {}}]}
    assert not st.replay(bad, e)


@pytest.mark.parametrize("origin", ["ref", "port"])
def test_trace_documents_replay_across_packages(origin):
    """The same program traces the same document in both packages, and a
    document made by one replays in the other to the same term."""
    je, _ = jblas_naive_dot(64)
    te, _ = naive_dot(64)
    jres, tres = _program(jst).apply(je), _program(st).apply(te)
    assert jres.trace.to_doc() == tres.trace.to_doc()
    assert jst.fingerprint(jres.phrase) == fp(tres.phrase)
    doc = json.loads(json.dumps((jres if origin == "ref" else tres)
                                .trace.to_doc()))
    assert fp(st.replay(doc, te).phrase) == jst.fingerprint(
        jst.replay(doc, je).phrase)


def jblas_naive_dot(n):
    from repro.kernels import dpia_blas as jblas
    return jblas.naive_dot(n)


# ---------------------------------------------------------------------------
# the kernel spaces: legacy builders, the reference's params, Stage II text
# ---------------------------------------------------------------------------

SHAPES = {
    "dot": [{"n": 512}, {"n": 4096}, {"n": 3 * 1024}],
    "asum": [{"n": 512}, {"n": 4096}, {"n": 2 * 8192}],
    "scal": [{"n": 512}, {"n": 4096}, {"n": 640}],
    "matmul": [{"m": 64, "k": 64, "n": 64}, {"m": 96, "k": 256, "n": 32},
               {"m": 512, "k": 128, "n": 8}],
    "rmsnorm": [{"rows": 16, "d": 64}, {"rows": 24, "d": 32},
                {"rows": 128, "d": 8}],
    "softmax": [{"rows": 16, "d": 64}, {"rows": 12, "d": 40},
                {"rows": 256, "d": 4}],
}


@pytest.mark.parametrize("kernel", sorted(SHAPES))
def test_space_candidates_equal_legacy_builders(kernel):
    """Every enumerated candidate, derived by its strategy program, is the
    pre-strategy-language hand-built term."""
    shape = SHAPES[kernel][0]
    for cand in space.enumerate_space(kernel, **shape):
        legacy = space.legacy_candidate(kernel, cand.params_dict, **shape)
        (e_new, a_new), (e_old, a_old) = cand.build(), legacy.build()
        assert fp(e_new) == fp(e_old), cand.params_key()
        assert [v.name for v in a_new] == [v.name for v in a_old]
        if cand.params_dict.get("block") is not None or \
                kernel in ("matmul", "rmsnorm", "softmax"):
            assert cand.trace_doc()["steps"]


@pytest.mark.parametrize("kernel", sorted(SHAPES))
def test_space_params_and_terms_equal_the_references(kernel):
    """At three shapes: the same candidates in the same order, the same
    default, and each candidate the reference's term (fingerprint) with
    the reference's derivation (trace document)."""
    for shape in SHAPES[kernel]:
        mine_, theirs = (space.enumerate_space(kernel, **shape),
                         jspace.enumerate_space(kernel, **shape))
        assert [c.params for c in mine_] == [c.params for c in theirs]
        assert space.default_params(kernel, **shape) == \
            jspace.default_params(kernel, **shape)
        for a, b in zip(mine_, theirs):
            assert fp(a.build()[0]) == jst.fingerprint(b.build()[0])
            assert a.trace_doc() == b.trace_doc()


def _stage2(pkg, cand):
    P_, T_, s1, s2, pretty = pkg
    e, _ = cand.build()
    out = P_.Var("out#", T_.AccT(P_.exp_data(e)))
    return normalise(pretty.show(s2.expand(s1.translate(e, out))))


@pytest.mark.parametrize("kernel", sorted(SHAPES))
def test_candidate_stage2_text_equals_the_references(kernel):
    shape = SHAPES[kernel][0]
    port = (P, tT, tstage1, tstage2, tpretty)
    ref = (jP, jT, jstage1, jstage2, jpretty)
    for a, b in zip(space.enumerate_space(kernel, **shape),
                    jspace.enumerate_space(kernel, **shape)):
        assert _stage2(port, a) == _stage2(ref, b), a.params_key()


def test_generic_space_covers_fused_term():
    expr, _ = st.fused_rmsnorm_matmul(32, 64, 32)
    got = st.generic_space(expr, blocks=(8, 16, 32), tiles=(16, 32, 64))
    jexpr, _ = jst.fused_rmsnorm_matmul(32, 64, 32)
    want = jst.generic_space(jexpr, blocks=(8, 16, 32), tiles=(16, 32, 64))
    assert [p for p, _, _ in got] == [p for p, _, _ in want]
    assert {p["rewrite"] for p, _, _ in got} >= {"id", "tile_matmul"}
    for _, _, res in got:
        P.type_of(res.phrase)


def test_rewrite_candidates_and_expr_signature_equal_the_references():
    e, argv = naive_dot(1024)
    from repro.kernels import dpia_blas as jblas
    je, jargv = jblas.naive_dot(1024)
    assert space.expr_signature(e) == jspace.expr_signature(je)
    assert [c.params for c in space.rewrite_candidates(e, argv)] == \
        [c.params for c in jspace.rewrite_candidates(je, jargv)]
    assert strategies.enumerate_dot_strategies(4096) == \
        space.dot_param_grid(4096)


# ---------------------------------------------------------------------------
# mining + seeding
# ---------------------------------------------------------------------------

def _trace(steps):
    return {"version": 1, "steps": steps}


def _step(rule, block):
    return [{"rule": "fuse_map_into_reduce", "path": [], "params": {}},
            {"rule": rule, "path": [],
             "params": {"block": block, "combine": "add"}}]


def test_anti_unify_holes_differing_params():
    t1, t2 = (_trace(_step("blocked_reduce", 128)),
              _trace(_step("blocked_reduce", 256)))
    g = mine.anti_unify(t1, t2)
    assert [s.to_doc() for s in g] == [s.to_doc()
                                       for s in jmine.anti_unify(t1, t2)]
    assert dict(g[1].params)["block"] == mine.HOLE
    a = mine.Abstraction("a", g)
    assert mine.matches(a, t1) and mine.matches(a, t2)
    assert not mine.matches(a, _trace(_step("split_join", 128)))


def test_mine_equals_the_reference_and_persists(tmp_path):
    traces = [_trace(_step("blocked_reduce", b)) for b in (128, 256, 512)]
    traces.append(_trace([{"rule": "tile_matmul", "path": [],
                           "params": {"bm": 32, "bk": 32}}]))
    for support in (2, 3):
        got = mine.mine(traces, min_support=support)
        assert [a.to_doc() for a in got] == [
            a.to_doc() for a in jmine.mine(traces, min_support=support)]
    abstractions = mine.mine(traces, min_support=3)
    path = str(tmp_path / "cache.abstractions.json")
    mine.save_abstractions(path, abstractions)
    assert [a.to_doc() for a in mine.load_abstractions(path)] == \
        [a.to_doc() for a in abstractions]
    # the file is the reference's: its loader reads it
    assert [a.to_doc() for a in jmine.load_abstractions(path)] == \
        [a.to_doc() for a in abstractions]
    assert mine.load_abstractions(str(tmp_path / "absent.json")) == []


def test_seeded_order_equals_the_reference():
    abstraction = mine.Abstraction("a", mine.anti_unify(
        _trace(_step("blocked_reduce", 128)),
        _trace(_step("blocked_reduce", 256))))
    jabstraction = jmine.Abstraction("a", jmine.anti_unify(
        _trace(_step("blocked_reduce", 128)),
        _trace(_step("blocked_reduce", 256))))
    cands = space.enumerate_space("dot", n=512)
    ordered = mine.seeded_order(cands, [abstraction])
    want = jmine.seeded_order(jspace.enumerate_space("dot", n=512),
                              [jabstraction])
    assert [c.params for c in ordered] == [c.params for c in want]
    assert ordered[0].params_dict != cands[0].params_dict


def test_mined_corpus_seeds_tune(tmp_path):
    cache = str(tmp_path / "tuning_cache.json")
    for n in (512, 1024, 2048):
        autotune.tune("dot", n=n, cache=cache, measure=False)
        autotune.tune("asum", n=n, cache=cache, measure=False)
    abstractions = mine.mine(autotune.TuningCache(cache))
    assert abstractions
    mine.save_abstractions(mine.abstractions_path(cache), abstractions)
    obs.enable()
    try:
        res = autotune.tune("dot", n=4096, cache=cache, measure=True,
                            iters=1, top_k=1, device="cpu")
        names = [e["name"] for e in obs.trace_events()]
    finally:
        obs.disable()
        obs.clear_trace()
    assert res.source == "measured" and res.strategy_trace
    assert "autotune.seeded" in names


# ---------------------------------------------------------------------------
# strategies.search
# ---------------------------------------------------------------------------

def test_search_skips_raising_cost_fn_with_warning():
    a, b, c = P.lit(1.0), P.lit(2.0), P.lit(3.0)
    costs = {id(a): 5.0, id(c): 1.0}

    def cost_fn(x):
        if x is b:
            raise RuntimeError("unpriceable term")
        return costs[id(x)]

    strategies._warned_cost_failure = False
    before = len([e for e in obs.flight_tail()
                  if e["name"] == "strategies.search.cost_error"])
    with pytest.warns(RuntimeWarning, match="cost_fn raised"):
        assert strategies.search([a, b, c], cost_fn) is c
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert strategies.search([a, b, c], cost_fn) is c
    assert len([e for e in obs.flight_tail()
                if e["name"] == "strategies.search.cost_error"]) == before + 2
    strategies._warned_cost_failure = False
    with pytest.warns(RuntimeWarning):
        def always(_):
            raise ValueError("nope")
        assert strategies.search([a, b], always) is a
    with pytest.raises(ValueError, match="empty candidate list"):
        strategies.search([], always)


# ---------------------------------------------------------------------------
# provenance: tune -> cache / obs, Program, AOT
# ---------------------------------------------------------------------------

def test_tune_records_strategy_trace_and_explains_it(tmp_path):
    cache = str(tmp_path / "tuning_cache.json")
    res = autotune.tune("dot", n=1024, cache=cache, measure=False)
    assert "blocked_reduce" in [s["rule"] for s in
                                res.strategy_trace["steps"]]
    hit = autotune.tune("dot", n=1024, cache=cache, measure=False)
    assert hit.source == "cache" and hit.strategy_trace == res.strategy_trace
    d = obs.provenance.get(res.key)
    assert d is not None and d.strategy_trace == res.strategy_trace
    assert "derived by" in d.describe()
    assert "blocked_reduce(block=" in obs.explain(res.key)


def test_tune_with_explicit_strategy_programs(tmp_path):
    cache = str(tmp_path / "tuning_cache.json")
    progs = [st.named("fuse+block", st.seq(
        FUSE, st.rule("blocked_reduce", block=256,
                      partial_level="grid(0)", combine="add")))]
    res = autotune.tune("dot", n=1024, cache=cache, measure=False,
                        strategies=progs)
    assert res.params in ({"strategy": "fuse+block"}, {"strategy": "id"})
    assert res.strategy_trace is not None


def test_program_lower_accepts_strategy_and_trace():
    prog = compiler.Program.from_kernel(
        "dot", params={"block": None, "leaf": "seq"}, n=256)
    s = st.seq(FUSE, st.rule("blocked_reduce", block=64,
                             partial_level="grid(0)", combine="add"))
    p2 = prog.lower(s)
    assert p2.strategy_trace and p2.strategy_trace["steps"]
    p3 = prog.lower(p2.strategy_trace)
    assert fp(p2.expr) == fp(p3.expr)
    assert p3.strategy_trace == p2.strategy_trace
    with pytest.raises(ValueError, match="failed"):
        prog.lower(st.fail_())


def test_program_export_round_trips_strategy_trace(tmp_path):
    prog = compiler.Program.from_kernel("matmul", m=64, k=64, n=64)
    assert prog.strategy_trace["steps"][0]["rule"] == "tile_matmul"
    path = str(tmp_path / "mm.json")
    prog.check().export(path)
    assert compiler.Program.load(path).strategy_trace == prog.strategy_trace


def test_aot_loaded_executor_reports_derivation(tmp_path):
    cache = str(tmp_path / "tuning_cache.json")
    aot = str(tmp_path / "aot")
    ops.clear_caches()
    try:
        with compiler.options(backend="dpia-torch", tuning_cache=cache):
            x, w = torch.ones((8, 64)), torch.ones(64)
            torch.testing.assert_close(ops.rmsnorm(x, w), x, rtol=1e-5,
                                       atol=1e-5)
            assert compiler.executor_cache().save_aot(aot) >= 1
            compiler.executor_cache().clear()
            obs.provenance.clear()
            assert compiler.executor_cache().load_aot(aot) >= 1
        loaded = [d for d in obs.provenance.decisions()
                  if d.origin == "aot-loaded"]
        assert loaded and any(d.strategy_trace and d.strategy_trace["steps"]
                              for d in loaded)
    finally:
        ops.clear_caches()
