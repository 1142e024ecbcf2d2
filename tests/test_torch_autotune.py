"""The port's autotuner (repro_torch.autotune) held against the reference's
(repro.autotune) on the CPU: the cost model and its presets, the analytic
ranking and ``get_tuned`` under the ``cpu`` preset, cache keys and files,
the KV-layout planner, ``Program.from_kernel(...).lower(params | trace |
"autotune")``, the op rows under ``options(autotune=True)``; and the port's
own rule on measurement failures: only a candidate the backend refuses
(``NotImplementedError``) or one whose output misses the default's
(``verify``) is dropped, with its event; anything else propagates.

Inputs are drawn from numpy seeds; every tuning cache is a file under
``tmp_path``.  The reference picks its cost preset from
``jax.default_backend()`` ("cpu" under ``JAX_PLATFORMS=cpu``) and the port
from its device ("gpu" where CUDA is available): the tests pin the port's
platform to "cpu", so the presets they hold equal are the same ones on
any machine."""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import autotune as jautotune
from repro import compiler as jcompiler
from repro.autotune import cache as jcache
from repro.autotune import cost as jcost
from repro.autotune import measure as jmeasure
from repro.autotune import space as jspace
from repro.configs import config as jconfig
from repro.configs import smoke_config as jsmoke
from repro.kernels import ops as jops
from repro_torch import autotune, compiler, obs
from repro_torch.autotune import cache, cost, measure, space
from repro_torch.configs import config, smoke_config
from repro_torch.core.dpia import phrases as P
from repro_torch.core.dpia.types import Arr, Num
from repro_torch.kernels import ops
from test_torch_dpia import normalise

SHAPES = [("dot", {"n": 4096}), ("asum", {"n": 2048}), ("scal", {"n": 4096}),
          ("matmul", {"m": 64, "k": 128, "n": 32}),
          ("rmsnorm", {"rows": 16, "d": 256}),
          ("softmax", {"rows": 32, "d": 64})]
IDS = [k for k, _ in SHAPES]


DEVICE_PLATFORM = cost.default_platform


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setattr(cost, "default_platform", lambda: "cpu")
    ops.clear_caches()
    yield
    ops.clear_caches()


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------

def test_presets_are_the_references_word_for_word():
    assert set(cost.HW_PRESETS) == set(jcost.HW_PRESETS)
    for name, hw in cost.HW_PRESETS.items():
        assert dataclasses.asdict(hw) == dataclasses.asdict(
            jcost.HW_PRESETS[name])
    assert DEVICE_PLATFORM() == ("gpu" if torch.cuda.is_available()
                                 else "cpu")
    assert cost.hw_model() == cost.HW_PRESETS["cpu"]
    assert cost.hw_model("gpu") == cost.HW_PRESETS["gpu"]
    a, b = torch.ones(64, 32), torch.ones(32, 16)
    secs = cost.xla_cost(lambda x, y: x @ y, (a, b))
    hw = cost.DEFAULT_HW
    assert secs == max(2 * 64 * 32 * 16 / hw.peak_flops,
                       (64 * 32 + 32 * 16 + 64 * 16) * 4 / hw.hbm_bw)


@pytest.mark.parametrize("kernel,shape", SHAPES, ids=IDS)
def test_estimates_equal_the_references_on_every_candidate(kernel, shape):
    for a, b in zip(space.enumerate_space(kernel, **shape),
                    jspace.enumerate_space(kernel, **shape)):
        ea, eb = cost.estimate(a.build()[0]), jcost.estimate(b.build()[0])
        for f in dataclasses.fields(ea):
            assert math.isclose(getattr(ea, f.name), getattr(eb, f.name),
                                rel_tol=1e-9), (a.params_key(), f.name)
        for name in cost.HW_PRESETS:
            assert math.isclose(
                cost.predicted_seconds(a.build()[0], cost.HW_PRESETS[name]),
                jcost.predicted_seconds(b.build()[0],
                                        jcost.HW_PRESETS[name]),
                rel_tol=1e-9)


@pytest.mark.parametrize("kernel,shape", SHAPES, ids=IDS)
def test_analytic_ranking_and_get_tuned_equal_the_references(tmp_path,
                                                            kernel, shape):
    mine_ = measure.rank_by_cost(space.enumerate_space(kernel, **shape))
    theirs = jmeasure.rank_by_cost(jspace.enumerate_space(kernel, **shape))
    assert [c.params for c, _ in mine_] == [c.params for c, _ in theirs]
    got = autotune.get_tuned(kernel, cache=str(tmp_path / "t.json"), **shape)
    want = jautotune.get_tuned(kernel, cache=str(tmp_path / "j.json"),
                               **shape)
    assert got == want == mine_[0][0].params_dict


def test_kv_layout_cost_equals_the_references():
    kw = dict(slots=4, max_seq=512, kv_heads=8, head_dim=128, layers=36,
              dtype_bytes=2, block_size=16)
    for layout in ("dense", "paged"):
        a = cost.kv_layout_cost(layout, **kw)
        b = jcost.kv_layout_cost(layout, **kw)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        for name in cost.HW_PRESETS:
            assert a.seconds(cost.HW_PRESETS[name]) == b.seconds(
                jcost.HW_PRESETS[name])


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args,kw", [
    (("dot", {"n": 4096}), {}),
    (("matmul", {"n": 16, "m": 32, "k": 64}, "float32", "cuda"), {}),
    (("rmsnorm", {"rows": 8, "d": 32}), {"layout": "paged"}),
    (("kv_layout", {"slots": 4, "max_seq": 512}, "bfloat16", "gpu",
      "single"), {}),
])
def test_make_key_equals_the_references(args, kw):
    assert cache.make_key(*args, **kw) == jcache.make_key(*args, **kw)
    assert cache.VERSION == jcache.VERSION


def test_cache_files_are_the_references_layout(tmp_path, monkeypatch):
    """A file the reference wrote loads in the port (and back): the same
    record layout, the same checksummed envelope."""
    path = str(tmp_path / "t.json")
    jautotune.tune("dot", n=1024, cache=path, measure=False)
    key = jcache.make_key("dot", {"n": 1024}, "float32", "jnp", "single")
    mine_ = autotune.TuningCache(path)
    assert mine_.get(key)["params"] == jcache.TuningCache(path).get(
        key)["params"]
    autotune.tune("dot", n=1024, cache=mine_, measure=False)
    assert cache.make_key("dot", {"n": 1024}, backend="torch") in \
        jcache.TuningCache(path).keys()
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "env.json"))
    assert cache.default_path() == str(tmp_path / "env.json")
    assert cache.default_cache().path == str(tmp_path / "env.json")
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE")
    assert cache.default_path().endswith(".cache/repro_torch/autotune.json")


def test_corrupt_cache_is_quarantined_and_rebuilt(tmp_path):
    path = tmp_path / "t.json"
    autotune.tune("asum", n=1024, cache=str(path), measure=False)
    path.write_text(path.read_text()[:-20])          # torn write
    before = obs.counter("artefact.load_failed").value
    res = autotune.tune("asum", n=1024, cache=str(path), measure=False)
    assert res.source == "analytic"
    assert obs.counter("artefact.load_failed").value == before + 1
    assert list((tmp_path / "t.json.quarantine").iterdir())


# ---------------------------------------------------------------------------
# tune, get_tuned, the planner, Program
# ---------------------------------------------------------------------------

def test_measured_tune_then_cache_hit(tmp_path):
    """On the CPU (the torch Stage III), every measured candidate verified
    against the default; the second call is served from the cache."""
    path = str(tmp_path / "t.json")
    obs.enable()
    try:
        dropped = {}
        res = autotune.tune("rmsnorm", rows=16, d=64, cache=path, top_k=2,
                            iters=1, verify=True, device="cpu",
                            dropped=dropped)
        assert res.source == "measured" and dropped == {}
        assert res.params_key() in res.timings and len(res.timings) >= 2
        obs.clear_trace()
        hit = autotune.tune("rmsnorm", rows=16, d=64, cache=path, top_k=2,
                            iters=1, device="cpu")
        names = [e["name"] for e in obs.trace_events()]
    finally:
        obs.disable()
        obs.clear_trace()
    assert (hit.source, hit.params) == ("cache", res.params)
    assert "autotune.measure" not in names
    assert obs.provenance.get(res.key).origin == "cache(measured)"


def test_measuring_needs_a_device():
    """Measurement runs on the card unless the CPU is asked for."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure.args_for(space.enumerate_space("dot", n=512)[0]
                         .program().arg_vars)


def test_args_for_draws_the_references_inputs():
    cand = space.enumerate_space("matmul", m=8, k=16, n=4)[0]
    jcand = jspace.enumerate_space("matmul", m=8, k=16, n=4)[0]
    got = measure.args_for(cand.program().arg_vars, seed=3, device="cpu")
    want = jmeasure.args_for(jcand.program().arg_vars, seed=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("mesh,backend", [("data=8", "torch"),
                                          (None, "shardmap")])
def test_mesh_tuning_raises_naming_item_6(tmp_path, mesh, backend):
    """Mesh tuning (ported with the mesh slice) as the reference's: the
    same ``tune`` call gives the same key and params in both packages, or
    the same error (``mesh=None`` with ``backend="shardmap"`` resolves the
    single-device descriptor, whose mesh space is empty)."""
    def run(tuner, path):
        try:
            r = tuner.tune("dot", n=1024, mesh=mesh, backend=backend,
                           measure=False, cache=str(path))
            return r.key, r.params
        except ValueError as e:
            return "ValueError", str(e)
    got = run(autotune, tmp_path / "t.json")
    assert got == run(jautotune, tmp_path / "j.json")
    if backend == "shardmap":
        assert got[0] == "ValueError" and "on mesh 'single'" in got[1]
    else:
        assert got[0].endswith("|data=8")


@pytest.mark.parametrize("cfg_fn,jcfg_fn,slots,max_seq", [
    (config, jconfig, 4, 512), (smoke_config, jsmoke, 2, 64)],
    ids=["qwen3-4b", "tiny"])
@pytest.mark.parametrize("platform", ["cpu", "gpu", "tpu"])
def test_pick_kv_layout_equals_the_references(tmp_path, cfg_fn, jcfg_fn,
                                              slots, max_seq, platform):
    got = autotune.pick_kv_layout(cfg_fn("qwen3_4b"), slots=slots,
                                  max_seq=max_seq, platform=platform,
                                  cache=str(tmp_path / "t.json"))
    want = jautotune.pick_kv_layout(jcfg_fn("qwen3_4b"), slots=slots,
                                    max_seq=max_seq, platform=platform,
                                    cache=str(tmp_path / "j.json"))
    assert got == want
    again = autotune.pick_kv_layout(cfg_fn("qwen3_4b"), slots=slots,
                                    max_seq=max_seq, platform=platform,
                                    cache=str(tmp_path / "t.json"))
    assert again == got and obs.provenance.get(
        cache.make_key("kv_layout", {
            "slots": slots, "max_seq": max_seq, "block": 16, "expected": 0,
            "layers": cfg_fn("qwen3_4b").n_layers,
            "kv": cfg_fn("qwen3_4b").n_kv_heads, "hd": cfg_fn("qwen3_4b").hd},
            cfg_fn("qwen3_4b").dtype, platform, "single")).origin == \
        "cache(analytic)"


def _stage2(prog):
    return normalise(prog.show())


@pytest.mark.parametrize("kernel,shape", SHAPES, ids=IDS)
def test_from_kernel_lower_equals_the_references(tmp_path, kernel, shape):
    """``Program.from_kernel`` and its ``lower`` by params, by trace
    document and by ``"autotune"``: the reference's Stage II text, and
    the reference's derivation."""
    mine_ = compiler.Program.from_kernel(kernel, **shape)
    theirs = jcompiler.Program.from_kernel(kernel, **shape)
    assert _stage2(mine_) == _stage2(theirs)
    assert mine_.strategy_trace == theirs.strategy_trace
    params = space.enumerate_space(kernel, **shape)[-1].params_dict
    a, b = mine_.lower(params), theirs.lower(params)
    assert _stage2(a) == _stage2(b) and a.strategy_trace == b.strategy_trace
    # a trace document replays on the naive spec
    from repro import strategy as jst
    from repro_torch import strategy as st
    naive = compiler.Program(*st.spec_builder(kernel, **shape)())
    jnaive = jcompiler.Program(*jst.spec_builder(kernel, **shape)())
    a2, b2 = naive.lower(a.strategy_trace), jnaive.lower(a.strategy_trace)
    assert _stage2(a2) == _stage2(b2) == _stage2(a)
    with compiler.options(tuning_cache=str(tmp_path / "t.json")):
        a3 = mine_.lower("autotune")
    with jcompiler.options(tuning_cache=str(tmp_path / "j.json")):
        b3 = theirs.lower("autotune")
    assert _stage2(a3) == _stage2(b3)


def test_autotuned_decorator_runs_the_tuned_program(tmp_path, rng):
    @autotune.autotuned("dot", cache=str(tmp_path / "t.json"))
    def dot(x, y):
        """x . y"""
    x = torch.from_numpy(rng.randn(2048).astype(np.float32))
    y = torch.from_numpy(rng.randn(2048).astype(np.float32))
    np.testing.assert_allclose(float(dot(x, y)), float(x @ y), rtol=1e-4)
    assert len(dot.compiled) == 1
    with pytest.raises(ValueError, match="unknown kernel"):
        autotune.autotuned("gemv")


def test_warm_for_model_equals_the_references(tmp_path):
    got = autotune.warm_for_model(smoke_config("qwen3_4b"), max_seq=64,
                                  cache=str(tmp_path / "t.json"))
    want = jautotune.warm_for_model(jsmoke("qwen3_4b"), max_seq=64,
                                    cache=str(tmp_path / "j.json"))
    assert {k.replace("|torch|", "|jnp|"): v for k, v in got.items()} == want
    assert autotune.model_kernel_shapes(config("qwen3_4b")) == \
        jautotune.model_kernel_shapes(jconfig("qwen3_4b"))


# ---------------------------------------------------------------------------
# the op rows under options(autotune=True)
# ---------------------------------------------------------------------------

def _op_inputs(kernel, shape, rng):
    r = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    if kernel == "scal":
        return [np.float32(1.3), r(shape["n"])]
    if kernel == "asum":
        return [r(shape["n"])]
    if kernel == "dot":
        return [r(shape["n"]), r(shape["n"])]
    if kernel == "matmul":
        return [r(shape["m"], shape["k"]), r(shape["k"], shape["n"])]
    if kernel == "rmsnorm":
        return [r(shape["rows"], shape["d"]), r(shape["d"])]
    return [r(shape["rows"], shape["d"])]


@pytest.mark.parametrize("kernel,shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("impl", ["dpia-torch", "dpia-cuda"])
def test_tuned_ops_equal_the_references(tmp_path, rng, kernel, shape, impl):
    """The tuned params are the reference's, the values its op's (1e-4:
    fp32 sums in other orders), and the executor key carries the params.
    The ``dpia-cuda`` row takes only a measured record: here the record
    the ``cuda`` analytic ranking writes, marked measured."""
    vals = _op_inputs(kernel, shape, rng)
    fallbacks = obs.counter("kernels.fallbacks").value
    with jcompiler.options(backend="dpia-jnp", autotune=True,
                           tuning_cache=str(tmp_path / "j.json")) as jopts:
        want = getattr(jops, kernel)(*[jnp.asarray(v) for v in vals])
        jparams = jops._tuned(kernel, "jnp", jopts, **shape)
    if impl == "dpia-cuda":
        _mark_measured(str(tmp_path / "t.json"), kernel, shape)
    with compiler.options(backend=impl, autotune=True,
                          tuning_cache=str(tmp_path / "t.json")) as opts:
        got = getattr(ops, kernel)(*[torch.from_numpy(np.asarray(v))
                                     for v in vals])
        params = ops._tuned(kernel, impl[len("dpia-"):], opts, **shape)
    assert params == jparams and params is not None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    (key,) = compiler.executor_cache().keys()
    assert key.endswith("|" + space.params_key(params))
    assert obs.counter("kernels.fallbacks").value == fallbacks


def _mark_measured(path, kernel, shape):
    """Write the ``cuda`` analytic record of ``kernel`` at ``shape`` into
    the cache at ``path`` as a measured one."""
    res = autotune.tune(kernel, backend="cuda", cache=path, measure=False,
                        **shape)
    tc = autotune.TuningCache(path)
    tc.put(res.key, {**tc.get(res.key), "source": "measured"})
    ops.clear_caches()


@pytest.mark.parametrize("kernel,shape", SHAPES, ids=IDS)
def test_cuda_row_runs_the_defaults_without_a_measured_record(
        tmp_path, rng, kernel, shape):
    """Under the tuner's default options the ``dpia-cuda`` row takes no
    analytic pick: with an empty cache, or one holding only the analytic
    record, it runs the default point (key ``default``, the values of
    ``autotune=False``) and writes nothing; a measured record it takes."""
    vals = [torch.from_numpy(np.asarray(v))
            for v in _op_inputs(kernel, shape, rng)]
    path = str(tmp_path / "t.json")
    with compiler.options(autotune=False):
        want = getattr(ops, kernel)(*vals, impl="dpia-cuda")
    ops.clear_caches()
    for analytic in (False, True):
        if analytic:
            autotune.tune(kernel, backend="cuda", cache=path, measure=False,
                          **shape)
        with compiler.options(autotune=True, tuning_cache=path) as opts:
            got = getattr(ops, kernel)(*vals, impl="dpia-cuda")
            assert ops._tuned(kernel, "cuda", opts, **shape) is None
        (key,) = compiler.executor_cache().keys()
        assert key.endswith("|default") and torch.equal(got, want)
        assert len(autotune.TuningCache(path)) == int(analytic)
        assert [d.note for d in obs.decisions() if d.key == key][-1] == \
            "no measured record (the cuda row takes no analytic pick)"
        ops.clear_caches()
    _mark_measured(path, kernel, shape)
    with compiler.options(autotune=True, tuning_cache=path) as opts:
        params = ops._tuned(kernel, "cuda", opts, **shape)
    assert params == autotune.TuningCache(path).get(
        cache.make_key(kernel, shape, backend="cuda"))["params"]


def test_failed_lookup_falls_back_to_the_defaults_once(tmp_path, rng,
                                                       monkeypatch):
    """A lookup that raises runs the default params (the same kernel, the
    same device), counts ``kernels.fallbacks`` every time and warns once."""
    def broken(*a, **kw):
        raise OSError("disk gone")
    monkeypatch.setattr(autotune, "get_tuned", broken)
    x = torch.from_numpy(rng.randn(2048).astype(np.float32))
    before = obs.counter("kernels.fallbacks").value
    with compiler.options(autotune=True):
        with pytest.warns(RuntimeWarning, match="autotune lookup failed"):
            ops.asum(x, impl="dpia-torch")
        ops._tuned_memo.clear()              # look up again
        ops.asum(x, impl="dpia-torch")       # warned already: counted only
    assert obs.counter("kernels.fallbacks").value == before + 2
    assert compiler.executor_cache().keys() == [
        "asum|n=2048|float32|torch|single|dense|default"]


# ---------------------------------------------------------------------------
# the port's rule on measurement failures
# ---------------------------------------------------------------------------

def _mesh_candidate():
    """A candidate the CUDA generator refuses: a MESH-level map."""
    def build():
        xs = P.var_exp("xs", Arr(64, Num()))
        return P.Join(P.Map(lambda blk: P.Map(lambda x: P.mul(x, x), blk),
                            P.Split(16, xs), level=P.MESH("x"))), [xs]
    return space._cand("scal", {"mesh": "x"}, build)


def _wrong_candidate():
    """An asum candidate that sums x, not |x|: it misses the default."""
    def build():
        xs = P.var_exp("xs", Arr(1024, Num()))
        return P.Reduce(lambda x, a: P.add(a, x), P.lit(0.0), xs), [xs]
    return space._cand("asum", {"wrong": True}, build)


def test_refused_candidate_is_dropped_with_its_event():
    ok = space._cand("scal", {"square": True}, lambda: _square(64))
    obs.flight_clear()
    dropped = {}
    before = obs.counter("autotune.dropped.unsupported").value
    got = measure.measure_candidates([_mesh_candidate(), ok],
                                     backend="cuda", iters=1, device="cpu",
                                     dropped=dropped)
    assert list(got) == ["square=True"]
    assert dropped == {"mesh=x": "unsupported"}
    assert obs.counter("autotune.dropped.unsupported").value == before + 1
    (ev,) = [e for e in obs.flight_tail()
             if e["name"] == "autotune.candidate_failed"]
    assert ev["args"]["reason"] == "unsupported" and \
        "MESH" in ev["args"]["detail"]


def _square(n):
    xs = P.var_exp("xs", Arr(n, Num()))
    return P.Map(lambda x: P.mul(x, x), xs), [xs]


def test_verify_mismatch_is_dropped():
    default = space.candidate_from_params(
        "asum", space.default_params("asum", n=1024), n=1024)
    dropped = {}
    got = measure.measure_candidates(
        [default, _wrong_candidate()], backend="torch", iters=1,
        device="cpu", verify_against=default, dropped=dropped)
    assert list(got) == [default.params_key()]
    assert dropped == {"wrong=True": "verify"}


def test_any_other_failure_propagates():
    def broken():
        raise RuntimeError("builder broke")
    bad = space._cand("dot", {"broken": True}, broken)
    with pytest.raises(RuntimeError, match="builder broke"):
        measure.measure_candidates([bad], backend="torch", device="cpu")


def test_vectorised_scal_runs_in_the_plain_version(rng):
    """The torch Stage III writes a vectorised block's lanes through
    ``joinAcc`` (a slice inside one chunk); the reference's jnp Stage III
    refuses that write (a known reference gap the freeze on ``src/repro``
    leaves standing), so its tuner drops every vectorised scal candidate
    without a word."""
    params, shape = {"block": 128, "vector": 128}, {"n": 4096}
    prog = space.candidate_from_params("scal", params, **shape).program()
    alpha = torch.tensor(1.7)
    x = torch.from_numpy(rng.randn(4096).astype(np.float32))
    got = prog.check().lower().compile("torch")(alpha, x)
    torch.testing.assert_close(got, alpha * x, rtol=0, atol=0)
    jprog = jspace.candidate_from_params("scal", params, **shape).program()
    with pytest.raises(TypeError, match="joinAcc"):
        jprog.check().lower().compile("jnp", jit=False)(
            jnp.float32(1.7), jnp.asarray(x.numpy()))
