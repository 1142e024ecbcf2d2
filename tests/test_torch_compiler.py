"""The port's compiler services (repro_torch.compiler) on the CPU: the
backend registry, CompileOptions scopes, the op layer's dispatch through
them, the executor cache with its AOT store and fault site, and Program
serialisation held against the reference's (repro.compiler).

Inputs are made with numpy from a seed.  The AOT reload runs in a fresh
Python process.  Held against the reference: ``Program.to_doc`` is
JSON-equal between the packages (both fresh-name counters started at 0),
and a document the reference exported computes in the port within
``rtol=1e-5`` of the reference on the same inputs."""
import itertools
import json
import os
import subprocess
import sys
import textwrap
import threading
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.dpia.phrases as jax_phrases
import repro_torch.core.dpia.phrases as torch_phrases
from repro import compiler as jcompiler
from repro.kernels import dpia_blas as jax_blas
from repro_torch import compiler, obs
from repro_torch.compiler import executors
from repro_torch.core.dpia import interp
from repro_torch.kernels import _build, ops, ref
from repro_torch.testing import faults

ROOT = Path(__file__).resolve().parents[1]

# chip_smoke's seven DPIA programs at small sizes
CASES = [("scal", dict(n=4096)), ("asum", dict(n=4096)),
         ("dot", dict(n=4096)), ("gemv", dict(m=256, n=128)),
         ("rmsnorm", dict(rows=16, d=64, eps=1e-6)),
         ("softmax", dict(rows=16, d=48)),
         ("matmul", dict(m=32, k=64, n=16))]

# fp32 on both sides in another summation order (jnp's blocked sums against
# the port's): within 1e-5 of each other, as the issue's contract states
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _clean():
    """Every test starts with an empty executor cache, tracing off and the
    default options, and ends the same."""
    ops.clear_caches()
    obs.disable()
    obs.clear_trace()
    yield
    ops.clear_caches()
    obs.disable()
    obs.clear_trace()


def _inputs(kernel, shape, rng):
    """numpy inputs of ``kernel`` at ``shape`` (float32)."""
    def r(*s):
        return rng.randn(*s).astype(np.float32)
    if kernel == "scal":
        return [np.float32(1.7), r(shape["n"])]
    if kernel in ("asum",):
        return [r(shape["n"])]
    if kernel == "dot":
        return [r(shape["n"]), r(shape["n"])]
    if kernel == "gemv":
        return [r(shape["m"], shape["n"]), r(shape["n"])]
    if kernel == "rmsnorm":
        return [r(shape["rows"], shape["d"]), r(shape["d"])]
    if kernel == "softmax":
        return [r(shape["rows"], shape["d"])]
    return [r(shape["m"], shape["k"]), r(shape["k"], shape["n"])]


def _torch(vals):
    return [torch.from_numpy(np.asarray(v)) for v in vals]


def _call(kernel, args, shape, **kw):
    """The port's op for ``kernel`` on torch tensors ``args``."""
    if kernel == "rmsnorm":
        return ops.rmsnorm(*args, eps=shape["eps"], **kw)
    return getattr(ops, kernel)(*args, **kw)


def _spans(name):
    return [e for e in obs.trace_events() if e["name"] == name]


# ---------------------------------------------------------------------------
# backend registry
# ---------------------------------------------------------------------------

def test_builtins_and_aliases():
    assert set(compiler.backend_names()) == {"torch", "cuda"}
    assert compiler.get_backend("dpia-cuda").name == "cuda"
    b = compiler.get_backend("torch")
    assert compiler.get_backend(b) is b
    with pytest.raises(ValueError, match="torch"):
        compiler.get_backend("not-a-backend")


def test_ops_impls_derived_from_registry():
    assert compiler.ops_impls() == ("plain", "cuda", "dpia-cuda",
                                    "dpia-torch")


def test_registered_backend_drives_ops_and_unregisters(rng):
    """A user backend is a 'dpia-<name>' impl of every op, by impl=, by
    options= and by scope; unregistering removes it (and its alias)."""
    def compile_interp(expr, arg_vars, **kw):
        names = [v.name for v in arg_vars]
        return lambda *args: interp.interp(expr, dict(zip(names, args)))

    compiler.register_backend(compiler.Backend(
        name="interp-test", compile=compile_interp), aliases=("it",))
    try:
        with pytest.raises(ValueError, match="already registered"):
            compiler.register_backend(compiler.Backend(
                name="interp-test", compile=compile_interp))
        assert "dpia-interp-test" in compiler.ops_impls()
        x, y = (torch.from_numpy(rng.randn(128).astype(np.float32))
                for _ in range(2))
        want = ref.dot(x, y)
        for got in (ops.dot(x, y, impl="dpia-interp-test"),
                    ops.dot(x, y, options=compiler.CompileOptions(
                        backend="dpia-interp-test"))):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        with compiler.options(backend="dpia-interp-test"):
            torch.testing.assert_close(ops.dot(x, y), want, rtol=1e-5,
                                       atol=1e-5)
    finally:
        compiler.unregister_backend("interp-test")
    with pytest.raises(ValueError):
        compiler.get_backend("it")
    assert "dpia-interp-test" not in compiler.ops_impls()


# ---------------------------------------------------------------------------
# options: explicit, scoped, thread-local
# ---------------------------------------------------------------------------

def test_option_defaults():
    opts = compiler.current_options()
    assert opts == compiler.default_options() == compiler.CompileOptions()
    assert (opts.backend, opts.autotune, opts.tuning_cache, opts.mesh,
            opts.kv_layout) == (None, False, None, None, "dense")
    assert opts.mesh_descriptor() == "single" and opts.resolved_mesh() is None


def test_option_validation():
    with pytest.raises(ValueError, match="valid backends"):
        compiler.CompileOptions(backend="garbage")
    with pytest.raises(ValueError, match="valid backends"):
        with compiler.options(backend="xla"):   # the reference's name
            pass  # pragma: no cover
    with pytest.raises(ValueError, match="kv_layout"):
        compiler.CompileOptions(kv_layout="auto")
    with pytest.raises(TypeError, match="not both"):
        with compiler.options(compiler.CompileOptions(), backend="cuda"):
            pass  # pragma: no cover


@pytest.mark.parametrize("field,value,item", [
    ("autotune", True, "autotune"), ("tuning_cache", "x.json", "autotune"),
    ("mesh", object(), "mesh")])
def test_unported_option_fields_raise_naming_their_item(field, value, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
        compiler.CompileOptions(**{field: value})
    with pytest.raises(NotImplementedError):
        with compiler.options(**{field: value}):
            pass  # pragma: no cover


def test_scoping_and_nesting():
    assert compiler.current_options().backend is None
    with compiler.options(backend="dpia-torch") as outer:
        assert compiler.current_options() is outer
        with compiler.options(kv_layout="paged"):
            inner = compiler.current_options()
            assert (inner.backend, inner.kv_layout) == ("dpia-torch",
                                                        "paged")
        assert compiler.current_options().kv_layout == "dense"
    assert compiler.current_options().backend is None


def test_thread_locality():
    seen = {}

    def probe():
        seen["other"] = compiler.current_options().backend
        with compiler.options(backend="dpia-cuda"):
            seen["scoped"] = compiler.current_options().backend

    with compiler.options(backend="dpia-torch"):
        t = threading.Thread(target=probe)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        assert compiler.current_options().backend == "dpia-torch"
    assert seen == {"other": None, "scoped": "dpia-cuda"}


@pytest.mark.parametrize("backend,stage3", [
    (None, "torch"), ("plain", "torch"), ("cuda", "torch"),
    ("dpia-torch", "torch"), ("dpia-cuda", "cuda")])
def test_dpia_backend_mapping(backend, stage3):
    assert compiler.CompileOptions(backend=backend).dpia_backend == stage3


def test_set_default_options_and_deprecated_shim(rng):
    x, y = (torch.from_numpy(rng.randn(256).astype(np.float32))
            for _ in range(2))
    try:
        with pytest.warns(DeprecationWarning, match="set_default_impl"):
            ops.set_default_impl("dpia-torch")
        assert compiler.current_options().backend == "dpia-torch"
        via_shim = ops.dot(x, y)
        with pytest.warns(DeprecationWarning):
            with pytest.raises(ValueError, match="valid backends"):
                ops.set_default_impl("garbage")
        assert compiler.current_options().backend == "dpia-torch"
    finally:
        compiler.set_default_options(backend=None)
    assert compiler.current_options().backend is None
    with compiler.options(backend="dpia-torch"):
        assert torch.equal(ops.dot(x, y), via_shim)
    assert len(compiler.executor_cache()) == 1


# ---------------------------------------------------------------------------
# the op layer under options
# ---------------------------------------------------------------------------

def test_default_options_keep_the_model_path_on_its_kernels(monkeypatch):
    """No impl and the default options: rmsnorm and flash_attention take
    their kernel rows (K1, K3), the other ops the plain row."""
    called = []
    monkeypatch.setattr(ops._rms, "rmsnorm",
                        lambda *a, **k: called.append("K1") or ref.rmsnorm(
                            *a, **k))
    monkeypatch.setattr(ops._fa, "flash_attention",
                        lambda *a, **k: called.append("K3")
                        or ref.flash_attention(*a, **k))
    monkeypatch.setattr(ops._mm, "matmul",
                        lambda *a, **k: called.append("K2") or ref.matmul(
                            *a, **k))
    x = torch.randn(4, 64)
    ops.rmsnorm(x, torch.ones(64))
    q = torch.randn(2, 8, 16)
    ops.flash_attention(q, q, q)
    ops.matmul(x, torch.randn(64, 8))
    assert called == ["K1", "K3"]
    with compiler.options(backend="cuda"):
        ops.matmul(x, torch.randn(64, 8))
        ops.rmsnorm(x, torch.ones(64))
    assert called == ["K1", "K3", "K2", "K1"]
    with compiler.options(backend="plain"):
        ops.rmsnorm(x, torch.ones(64))
        ops.flash_attention(q, q, q)
    assert called == ["K1", "K3", "K2", "K1"]


def test_dispatch_precedence_impl_then_options_then_scope(rng):
    x = torch.from_numpy(rng.randn(2048).astype(np.float32))
    with compiler.options(backend="dpia-cuda"):
        ops.asum(x)                                         # scope
        ops.asum(x, options=compiler.CompileOptions(
            backend="dpia-torch"))                          # options=
        ops.asum(x, impl="plain",
                 options=compiler.CompileOptions(backend="dpia-cuda"))
    keys = compiler.executor_cache().keys()
    assert sorted(k.split("|")[3] for k in keys) == ["cuda", "torch"]


@pytest.mark.parametrize("kernel,shape", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("backend", ["dpia-torch", "dpia-cuda"])
def test_scoped_dpia_backend_drives_every_op(rng, kernel, shape, backend):
    """Each DPIA op under ``options(backend=...)`` without impl= equals the
    same op with impl= bit for bit (one executor, staged once), and the
    plain row within 1e-4 (fp32 sums in another order)."""
    args = _torch(_inputs(kernel, shape, rng))
    with compiler.options(backend=backend):
        scoped = _call(kernel, args, shape)
    explicit = _call(kernel, args, shape, impl=backend)
    assert torch.equal(scoped, explicit)
    torch.testing.assert_close(scoped, _call(kernel, args, shape,
                                             impl="plain"),
                               rtol=1e-4, atol=1e-4)
    st = compiler.executor_cache().stats()
    assert (st["entries"], st["builds"], st["hits"]) == (1, 1, 1)


def test_unknown_impl_names_the_valid_ones():
    with pytest.raises(ValueError, match="valid impls.*plain"):
        ops.dot(torch.zeros(4), torch.zeros(4), impl="dpia-nothing")


# ---------------------------------------------------------------------------
# the executor cache
# ---------------------------------------------------------------------------

def test_make_key_is_canonical():
    k = executors.make_key("matmul", {"n": 16, "m": 32, "k": 64}, "cuda")
    assert k == "matmul|k=64,m=32,n=16|float32|cuda|single|dense|default"
    assert executors.make_key("dot", {"n": 8}, "torch", params={"b": 2},
                              layout="paged") == \
        "dot|n=8|float32|torch|single|paged|b=2"
    # the reference's key is this one plus its interpret and jit bits
    from repro.compiler import executors as jexec
    assert jexec.make_key("dot", {"n": 8}, "jnp", params={"b": 2},
                          layout="paged").startswith(
        "dot|n=8|float32|jnp|single|paged|b=2|")


def test_ops_build_once_then_hit_and_record_provenance(rng):
    obs.clear_decisions()
    x = torch.from_numpy(rng.randn(4096).astype(np.float32))
    for _ in range(3):
        ops.asum(x, impl="dpia-cuda")
    ops.asum(x, impl="dpia-cuda", options=compiler.CompileOptions(
        kv_layout="paged"))                 # a layout is a key dimension
    st = compiler.executor_cache().stats()
    assert st == {"entries": 2, "hits": 2, "builds": 2, "aot_loads": 0}
    key = executors.make_key("asum", {"n": 4096}, "cuda")
    fn = ops.compiled("asum", "cuda", n=4096)
    assert compiler.executor_cache().get(key) is fn
    assert (fn.program.kernel, fn.program.shape) == ("asum", {"n": 4096})
    (d,) = [d for d in obs.decisions() if d.key == key]
    assert (d.origin, d.params, d.layout) == ("default", {"block": 2048},
                                              "dense")
    assert "asum" in obs.explain("asum") and "origin default" in \
        obs.explain("asum")
    assert ops.warm_kernel("asum", backend="cuda", n=4096) is fn
    assert ops.warm_kernel("rmsnorm", rows=8, d=32).backend == "torch"


def test_reset_launch_counts_walks_the_cache(rng):
    x = torch.from_numpy(rng.randn(2048).astype(np.float32))
    ops.asum(x, impl="dpia-cuda")
    fn = ops.compiled("asum", "cuda", n=2048)
    fn._fn.launches = 5                    # as a card run would leave it
    ops.reset_launch_counts()
    assert fn.launches == 0


def test_executor_build_fault_fires_under_a_scoped_plan(rng):
    x = torch.from_numpy(rng.randn(2048).astype(np.float32))
    before = obs.counter("faults.injected").value
    with faults.inject("executor.build(key=asum*)") as plan:
        with pytest.raises(faults.InjectedFault, match="executor.build"):
            ops.asum(x, impl="dpia-torch")
        ops.dot(x, x, impl="dpia-torch")   # another key: no fault
    assert plan[0].fired == 1
    assert obs.counter("faults.injected").value == before + 1
    assert len(compiler.executor_cache()) == 1        # nothing half-built
    ops.asum(x, impl="dpia-torch")                    # the plan is gone
    assert len(compiler.executor_cache()) == 2


def test_stage_spans_and_options_backend():
    obs.enable()
    prog = ops.program("dot", n=4096)
    with compiler.options(backend="dpia-cuda"):
        fn = prog.check().lower().compile()
    assert fn.backend == "cuda"
    assert prog.compile(options=compiler.CompileOptions()).backend == "torch"
    assert [e["name"] for e in obs.trace_events()] == [
        "compiler.lower", "compiler.check", "compiler.compile",
        "compiler.compile"]
    assert _spans("compiler.compile")[0]["args"]["backend"] == "cuda"


def test_unported_strategies_raise_naming_the_autotuner():
    prog = ops.program("dot", n=4096)
    for strategy in ("autotune", {"block": 1024}, {"steps": []}):
        with pytest.raises(NotImplementedError, match="autotune"):
            prog.lower(strategy)
    with pytest.raises(NotImplementedError, match="autotune"):
        compiler.Program.from_kernel("dot", n=4096)


# ---------------------------------------------------------------------------
# Program serialisation, held against the reference
# ---------------------------------------------------------------------------

def _reference_program(kernel, shape):
    params = ops.default_params(kernel, **shape)
    expr, argv = getattr(jax_blas, f"strategy_{kernel}")(**shape, **params)
    return jcompiler.Program(expr, argv, name=ops.program_name(kernel,
                                                               **shape),
                             kernel=kernel, shape=shape)


@pytest.mark.parametrize("kernel,shape", CASES, ids=[c[0] for c in CASES])
def test_to_doc_is_json_equal_to_the_reference(monkeypatch, kernel, shape):
    monkeypatch.setattr(jax_phrases, "_counter", itertools.count())
    want = _reference_program(kernel, shape).check().to_doc()
    monkeypatch.setattr(torch_phrases, "_counter", itertools.count())
    got = ops.program(kernel, **shape).check().to_doc()
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


@pytest.mark.parametrize("kernel,shape", CASES, ids=[c[0] for c in CASES])
def test_reference_document_computes_in_the_port(rng, tmp_path, kernel,
                                                 shape):
    """The reference exports; the port loads the file and runs it through
    both Stage III backends (on CPU tensors the CUDA program runs its
    plain version) within RTOL of the reference's jnp program."""
    jprog = _reference_program(kernel, shape).check()
    path = jprog.export(str(tmp_path / f"{kernel}.json"))
    vals = _inputs(kernel, shape, rng)
    want = np.asarray(jprog.compile("jnp", jit=False)(
        *[jnp.asarray(v) for v in vals]))
    prog = compiler.Program.load(path)
    assert prog.expr is None and prog._checked
    assert (prog.name, prog.kernel, prog.shape) == (jprog.name, kernel, shape)
    obs.enable()
    for backend in ("torch", "cuda"):
        got = prog.compile(backend)(*_torch(vals))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL)
    assert not _spans("compiler.lower") and not _spans("compiler.check")


def test_document_round_trip_and_version_check(tmp_path, rng, monkeypatch):
    def doc(p):              # binders get fresh names at each serialisation
        monkeypatch.setattr(torch_phrases, "_counter", itertools.count())
        return p.to_doc()

    prog = ops.program("gemv", m=256, n=128).check()
    path = prog.export(str(tmp_path / "sub" / "gemv.json"))
    back = compiler.Program.load(path)
    assert doc(back) == doc(prog)
    # the same command: the generated CUDA source (hence its library's
    # name) is the same, so a card finds the library built
    a, b = prog.compile("cuda"), back.compile("cuda")
    assert a.source == b.source
    assert _build.generated_target(a.name, a.source) == \
        _build.generated_target(b.name, b.source)
    args = _torch(_inputs("gemv", {"m": 256, "n": 128}, rng))
    assert torch.equal(a(*args), b(*args))
    doc = prog.to_doc()
    doc["version"] = 99
    with pytest.raises(ValueError, match="export version"):
        compiler.Program.from_doc(doc)
    dot = ops.program("dot", n=4096)
    assert compiler.program(dot.expr, dot.arg_vars, name="p").name == "p"


# ---------------------------------------------------------------------------
# the AOT store
# ---------------------------------------------------------------------------

_CHILD = textwrap.dedent("""
    import json, sys
    import torch
    from repro_torch import compiler, obs
    from repro_torch.kernels import _build, ops
    directory, inputs, outputs = sys.argv[1:4]
    obs.enable()
    cache = compiler.executor_cache()
    loaded = cache.load_aot(directory)
    cases = json.loads(sys.argv[4])
    args = torch.load(inputs)
    outs = []
    with compiler.options(backend="dpia-cuda"):
        for (kernel, shape), a in zip(cases, args):
            if kernel == "rmsnorm":
                outs.append(ops.rmsnorm(*a, eps=shape["eps"]))
            else:
                outs.append(getattr(ops, kernel)(*a))
    torch.save(outs, outputs)
    names = [e["name"] for e in obs.trace_events()]
    print(json.dumps({
        "loaded": loaded, "stats": cache.stats(),
        "lower": names.count("compiler.lower"),
        "check": names.count("compiler.check"),
        "compile": names.count("compiler.compile"),
        "nvcc_runs": _build.nvcc_runs,
        "targets": sorted(_build.generated_target(fn.name, fn.source).name
                          for fn in cache.values()),
        "origins": sorted({d.origin for d in obs.decisions()})}))
""")


def test_aot_reload_in_a_fresh_process(rng, tmp_path):
    """save_aot here, load_aot in a new process: the same outputs bit for
    bit, no Stage I/II and no SCIR check there, and the same generated
    sources (on the card: the libraries built here, no nvcc)."""
    args = [_torch(_inputs(k, sh, rng)) for k, sh in CASES]
    with compiler.options(backend="dpia-cuda"):
        want = [_call(k, a, sh) for (k, sh), a in zip(CASES, args)]
    cache = compiler.executor_cache()
    assert cache.save_aot(str(tmp_path / "aot")) == len(CASES)
    assert cache.save_aot(str(tmp_path / "aot")) == 0    # content-addressed
    torch.save(args, tmp_path / "in.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, str(tmp_path / "aot"),
         str(tmp_path / "in.pt"), str(tmp_path / "out.pt"),
         json.dumps(CASES)], capture_output=True, text=True, env=env,
        timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    rep = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rep["loaded"] == len(CASES)
    assert rep["stats"] == {"entries": len(CASES), "hits": len(CASES),
                            "builds": 0, "aot_loads": len(CASES)}
    assert (rep["lower"], rep["check"], rep["compile"]) == (0, 0, len(CASES))
    assert rep["nvcc_runs"] == 0 and rep["origins"] == ["aot-loaded"]
    assert rep["targets"] == sorted(
        _build.generated_target(fn.name, fn.source).name
        for fn in cache.values())
    for g, w in zip(torch.load(tmp_path / "out.pt"), want):
        assert torch.equal(g, w)


def test_corrupt_aot_files_are_quarantined(rng, tmp_path):
    x = torch.from_numpy(rng.randn(4096).astype(np.float32))
    ops.dot(x, x, impl="dpia-torch")
    ops.asum(x, impl="dpia-torch")
    d = tmp_path / "aot"
    compiler.executor_cache().save_aot(str(d))
    files = sorted(d.glob("prog-*.json"))
    assert len(files) == 2
    faults.corrupt_json_file(str(files[0]), "stale")   # checksum breaks
    skew = json.loads(files[1].read_text())
    before = obs.counter("artefact.load_failed").value
    ops.clear_caches()
    fresh = executors.ExecutorCache()
    assert fresh.load_aot(str(d)) == 1
    assert obs.counter("artefact.load_failed").value == before + 1
    assert not files[0].exists()
    assert (d / ".quarantine" / files[0].name).exists()
    # version skew is a silent skip
    skew["version"] = executors.AOT_VERSION - 1
    from repro_torch.ft import artefacts
    artefacts.save_json(str(files[1]), skew)
    assert executors.ExecutorCache().load_aot(str(d)) == 0
    assert obs.counter("artefact.load_failed").value == before + 1
    assert executors.ExecutorCache().load_aot(str(tmp_path / "none")) == 0


def test_artefact_corrupt_fault_quarantines_a_healthy_file(rng, tmp_path):
    x = torch.from_numpy(rng.randn(4096).astype(np.float32))
    ops.dot(x, x, impl="dpia-torch")
    d = tmp_path / "aot"
    compiler.executor_cache().save_aot(str(d))
    with faults.inject("artefact.corrupt(what=AOT program)") as plan:
        assert executors.ExecutorCache().load_aot(str(d)) == 0
    assert plan[0].fired == 1
    assert list((d / ".quarantine").glob("prog-*.json"))
    assert any(dump["reason"] == "artefact_quarantine"
               for dump in obs.flight_dumps())


# ---------------------------------------------------------------------------
# the quickstart
# ---------------------------------------------------------------------------

def test_quickstart_runs_on_the_cpu(capsys):
    from repro_torch.examples import quickstart
    res = quickstart.main(["--device", "cpu"])
    assert set(res["backends"]) == {"torch", "cuda"}
    for v in (*res["backends"].values(), res["scoped"]):
        np.testing.assert_allclose(v, res["oracle"], rtol=quickstart.RTOL)
    assert "== oracle OK" in capsys.readouterr().out


def test_no_warning_from_the_port_on_the_dpia_path(rng):
    """The port's modules trigger no DeprecationWarning of their own."""
    x = torch.from_numpy(rng.randn(4096).astype(np.float32))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with compiler.options(backend="dpia-torch"):
            ops.dot(x, x)
