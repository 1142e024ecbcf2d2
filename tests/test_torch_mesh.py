"""The port's pipeline on a mesh (``repro_torch.mesh``, the Stage III
``shardmap`` backend over ``torch.distributed``, the ``dpia-shardmap`` op
rows and ``tune(backend="shardmap")``) held against the reference's
(``repro.mesh``, ``repro.core.dpia.stage3_shardmap``) on the CPU.

* In process, no ranks: descriptors, ``MeshStrategy``, the six builders'
  terms (pretty text), the mesh spaces, cost estimates of every candidate
  under each preset, ``tune(..., backend="shardmap", measure=False)`` and
  the tuner's errors, each held to the reference's.
* The reference's values: one JAX subprocess on 4 forced CPU devices
  (``conftest.forced_devices``) runs the mesh programs on ``data=4`` and on
  ``(data=2, model=2)`` sharded over ``data``, each at its default placement
  and at one chunked placement, on numpy inputs from a seed, and writes an
  ``.npz`` under ``tmp_path``.
* The port's values: one spawn of 4 gloo ranks
  (``repro_torch.testing.ranks``) runs the same programs on the same meshes
  through ``Program.compile("shardmap", inner="torch")`` (and
  ``inner="cuda"``, whose shards run K4's plain version on CPU tensors), and
  the ops under ``options(backend="dpia-shardmap", mesh=...)``.  Each rank
  returns the gathered outputs, whether its ``to_local()`` is its slice of
  the plain version, the ``all_reduce`` calls ``torch.profiler`` saw, the
  executor keys, what ``save_aot`` wrote and the measured tuner's pick.

Both runs happen once per module.  Values are held at ``TOL = 1e-4``, as
``test_torch_dpia.py`` holds the single-device pipeline (the two sum fp32
terms in other orders).
"""
import dataclasses
import math
import os
import re
import types
import warnings

import numpy as np
import pytest
import torch

from repro import autotune as jautotune
from repro import compiler as jcompiler
from repro import mesh as jmesh
from repro.autotune import cost as jcost
from repro.core.dpia import phrases as jP
from repro.core.dpia import pretty as jpretty
from repro.core.dpia import types as jT
from repro.kernels import dpia_blas as jblas
from repro.kernels import ops as jops
from repro_torch import autotune, compiler, mesh, obs
from repro_torch.autotune import cost
from repro_torch.core.dpia import phrases as tP
from repro_torch.core.dpia import pretty as tpretty
from repro_torch.core.dpia import stage3_shardmap
from repro_torch.core.dpia import types as tT
from repro_torch.kernels import dpia_blas as tblas
from repro_torch.kernels import ops
from repro_torch.launch import mesh as launch_mesh
from repro_torch.sharding import ctx
from repro_torch.testing import ranks
from _build_drill import build_same_program
from test_torch_dpia import normalise

TOL = 1e-4

REF = types.SimpleNamespace(P=jP, T=jT, mesh=jmesh, pretty=jpretty)
PORT = types.SimpleNamespace(P=tP, T=tT, mesh=mesh, pretty=tpretty)

# kernel, shape, a chunk for the chunked placement (the builder's block /
# row_block / bk); "amax" is a mesh reduce that combines with max
CASES = [("dot", {"n": 1024}, 64), ("asum", {"n": 1024}, 64),
         ("scal", {"n": 1024}, 64), ("rmsnorm", {"rows": 32, "d": 16}, 4),
         ("softmax", {"rows": 32, "d": 16}, 4),
         ("matmul", {"m": 16, "k": 32, "n": 8}, 8), ("amax", {"n": 256}, None)]
OPS = [k for k, _, _ in CASES if k != "amax"]
REDUCES = ("dot", "asum", "amax")
# descriptor -> (shape, axis names); every program shards over "data"
MESHES = {"data=4": ((4,), ("data",)),
          "data=2,model=2": ((2, 2), ("data", "model"))}
WORLD = 4
TUNE_N = 4096


def _term(pkg, kernel, shards, chunk, shape):
    """A mesh term of either package, sharded over ``data``."""
    if kernel == "amax":
        P, T = pkg.P, pkg.T
        n = shape["n"]
        xs = P.var_exp("xs", T.Arr(n, T.Num()))
        return P.Reduce(
            lambda x, a: P.fmax(a, x), P.lit(0.0),
            P.Map(lambda blk: P.Reduce(
                lambda x, a: P.fmax(a, P.UnOp("abs", x)), P.lit(0.0), blk,
                level=P.SEQ), P.Split(n // shards, xs), level=P.MESH("data")),
            level=P.MESH("data")), [xs]
    build, _ = pkg.mesh.MESH_KERNELS[kernel]
    kw = {} if chunk is None else {pkg.mesh.space._CHUNK_PARAM[kernel]: chunk}
    return build("data", shards, **kw, **shape)


def _inputs(kernel, shape):
    """The numpy inputs of a case, in the term's argument order."""
    rng = np.random.RandomState(sum(map(ord, kernel)))
    f = np.float32
    if kernel in ("dot",):
        return [rng.randn(shape["n"]).astype(f),
                rng.randn(shape["n"]).astype(f)]
    if kernel in ("asum", "amax"):
        return [rng.randn(shape["n"]).astype(f)]
    if kernel == "scal":
        return [np.asarray(2.5, f), rng.randn(shape["n"]).astype(f)]
    if kernel == "rmsnorm":
        return [rng.randn(shape["rows"], shape["d"]).astype(f),
                (1 + 0.1 * rng.randn(shape["d"])).astype(f)]
    if kernel == "softmax":
        return [rng.randn(shape["rows"], shape["d"]).astype(f)]
    return [rng.randn(shape["m"], shape["k"]).astype(f),
            rng.randn(shape["k"], shape["n"]).astype(f)]


def _placements(kernel, chunk):
    return [None] if chunk is None else [None, chunk]


# ---------------------------------------------------------------------------
# the reference's values: one forced-4-device JAX subprocess
# ---------------------------------------------------------------------------

ORACLE = r"""
import sys, types, numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, "tests")
from repro import compiler, mesh as jmesh
from repro.core.dpia import phrases as jP, types as jT
from test_torch_mesh import CASES, MESHES, _term, _placements
REF = types.SimpleNamespace(P=jP, T=jT, mesh=jmesh)
src, dst = sys.argv[1], sys.argv[2]
ins = np.load(src)
out = {}
for desc, (shape, axes) in MESHES.items():
    m = jax.make_mesh(shape, axes)
    for kernel, kshape, chunk in CASES:
        for c in _placements(kernel, chunk):
            expr, argv = _term(REF, kernel, shape[0], c, kshape)
            fn = compiler.Program(expr, argv).compile("shardmap", mesh=m)
            args = [jnp.asarray(ins[f"{kernel}_{i}"])
                    for i in range(len(argv))]
            out[f"{desc}|{kernel}|{c}"] = np.asarray(fn(*args))
np.savez(dst, **out)
print("ORACLE_OK")
"""

_ORACLE: dict = {}


@pytest.fixture
def oracle(forced_devices, tmp_path):
    """The reference's shardmap values, computed once per module."""
    if not _ORACLE:
        src, dst = tmp_path / "inputs.npz", tmp_path / "oracle.npz"
        np.savez(src, **{f"{k}_{i}": a for k, sh, _ in CASES
                         for i, a in enumerate(_inputs(k, sh))})
        script = ORACLE.replace("sys.argv[1], sys.argv[2]",
                                f"{str(src)!r}, {str(dst)!r}")
        r = forced_devices(script, n=WORLD, timeout=300)
        assert "ORACLE_OK" in r.stdout, r.stdout + r.stderr
        with np.load(dst) as z:
            _ORACLE.update({k: z[k] for k in z.files})
    return _ORACLE


# ---------------------------------------------------------------------------
# the port's values: one spawn of 4 gloo ranks
# ---------------------------------------------------------------------------

def _count_allreduce(call):
    """(result, all_reduce calls torch.profiler saw, the shardmap module's
    count) of ``call()``."""
    from torch.profiler import ProfilerActivity, profile
    before = stage3_shardmap.collectives
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = call()
    seen = sum(e.name == "c10d::allreduce_" for e in prof.events())
    return out, seen, stage3_shardmap.collectives - before


def _plain(kernel, args):
    """The plain version of a case on whole tensors."""
    from repro_torch.kernels import ref
    if kernel == "amax":
        return args[0].abs().max()
    if kernel == "rmsnorm":
        return ref.rmsnorm(*args, eps=1e-6)
    if kernel == "softmax":
        return ref.softmax(args[0], dim=-1)
    return {"dot": ref.dot, "asum": ref.asum, "scal": ref.scal,
            "matmul": ref.matmul}[kernel](*args)


def _op(kernel, args):
    return {"dot": lambda: ops.dot(*args), "asum": lambda: ops.asum(*args),
            "scal": lambda: ops.scal(*args),
            "rmsnorm": lambda: ops.rmsnorm(*args),
            "softmax": lambda: ops.softmax(*args),
            "matmul": lambda: ops.matmul(*args)}[kernel]


def _holds_its_shard(out, want, rank_index, shards, reduce):
    """Whether this rank's ``to_local()`` is its slice of the plain value
    (the whole value, for a mesh reduce)."""
    loc = out.to_local()
    if not reduce:
        c = want.shape[0] // shards
        want = want[rank_index * c:(rank_index + 1) * c]
    return bool(torch.allclose(loc, want, rtol=TOL, atol=TOL))


def _rank_work(rank, world, tmp):
    """Everything the port runs across ranks; returns what the tests read."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    res = {"full": {}, "held": {}, "allreduce": {}, "ops": {},
           "ops_allreduce": {}, "tune": {}, "desc": [], "dtensor": {},
           "ctx": {}}
    ins = {k: [torch.from_numpy(a) for a in _inputs(k, sh)]
           for k, sh, _ in CASES}
    # a mesh without dim names has no axis to bind
    try:
        mesh.descriptor(init_device_mesh("cpu", (world,)))
    except ValueError as e:
        res["unnamed"] = str(e)
    for desc, (shape, axes) in MESHES.items():
        m = launch_mesh.make_mesh(shape, axes, "cpu")
        res["desc"].append(mesh.descriptor(m))
        i = m.get_local_rank("data")
        for kernel, kshape, chunk in CASES:
            args = ins[kernel]
            want = _plain(kernel, args)
            for inner in ("torch", "cuda"):
                for c in _placements(kernel, chunk):
                    expr, argv = _term(PORT, kernel, shape[0], c, kshape)
                    fn = compiler.Program(expr, argv).compile(
                        "shardmap", mesh=m, inner=inner)
                    out, seen, counted = _count_allreduce(lambda: fn(*args))
                    key = f"{desc}|{kernel}|{c}|{inner}"
                    res["full"][key] = out.full_tensor().numpy()
                    res["held"][key] = _holds_its_shard(
                        out, want, i, shape[0], kernel in REDUCES)
                    res["allreduce"][key] = (seen, counted)
        # the op rows (default placement: autotune off)
        with compiler.options(backend="dpia-shardmap", mesh=m,
                              autotune=False):
            for kernel in OPS:
                out, seen, counted = _count_allreduce(
                    _op(kernel, ins[kernel]))
                res["ops"][f"{desc}|{kernel}"] = out.full_tensor().numpy()
                res["ops_allreduce"][f"{desc}|{kernel}"] = (seen, counted)
            # a gemv has no mesh strategy: its single-device row
            a, x = torch.ones(128, 16), torch.ones(16)
            res["gemv"] = ops.gemv(a, x).tolist()
            # DTensor inputs: Shard(0) on data and Replicate() both read
            # this rank's chunk; any other placement raises
            x, y = ins["dot"]
            c = x.shape[0] // shape[0]
            rest = [Replicate()] * (len(shape) - 1)
            xs = DTensor.from_local(x[i * c:(i + 1) * c], m,
                                    [Shard(0)] + rest, run_check=False)
            yr = DTensor.from_local(y, m, [Replicate()] * len(shape),
                                    run_check=False)
            res["dtensor"][desc] = float(ops.dot(xs, yr).to_local())
            if len(shape) == 2:
                bad = DTensor.from_local(x[:x.shape[0] // 2], m,
                                         [Replicate(), Shard(0)],
                                         run_check=False)
                try:
                    ops.dot(bad, yr)
                except ValueError as e:
                    res["bad_placement"] = str(e)
            # no axis divides the extent: the single-device dpia-torch row
            z = torch.arange(1025, dtype=torch.float32) / 1025
            fallbacks = obs.counter("kernels.fallbacks").value
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                got = ops.dot(z, z)
            res.setdefault("indivisible", {})[desc] = (
                type(got).__name__, float(got), float(ops.dot(
                    z, z, impl="dpia-torch")),
                obs.counter("kernels.fallbacks").value - fallbacks,
                [str(x.message) for x in w])
        # the process mesh context reaches Program.compile("shardmap")
        ctx.set_mesh(m)
        try:
            expr, argv = _term(PORT, "dot", shape[0], None, {"n": 1024})
            fn = compiler.Program(expr, argv).compile("shardmap")
            res["ctx"][desc] = (float(fn(*ins["dot"]).to_local()),
                                ctx.dp_axes(), ctx._filter(("model", "x")))
            # a batch split over the data axis is what the train step
            # placed: the identity; a split over a model axis of size > 1
            # (sequence parallelism) is this rank's sequence shard inside a
            # tensor-parallel step, and raises outside one
            x = torch.ones(4, 8)
            try:
                ctx.constraint(x, "data", "model")
                raised = None
            except NotImplementedError as e:
                raised = str(e)
            sp = None
            if "model" in desc:
                from repro_torch.configs import smoke_config
                from repro_torch.sharding import collectives
                tp = collectives.TensorParallel(
                    collectives.ModelGroup(m), {},
                    smoke_config("qwen3_4b"), x.shape[1])
                shard = x[:, tp.rows[0]:tp.rows[1]]
                with ctx.tensor_parallel(tp):
                    sp = ctx.constraint(shard, "data", "model") is shard
            res.setdefault("ctx_constraint", {})[desc] = (
                ctx.constraint(x, "data") is x, sp, raised)
        finally:
            ctx.set_mesh(None)
        # measured tuning: every rank times its shard, all pick the same
        r = autotune.tune("dot", n=TUNE_N, backend="shardmap", mesh=m,
                          measure=True, top_k=2, iters=2, device="cpu",
                          cache=os.path.join(tmp, f"tune-{desc}.json"))
        res["tune"][desc] = (r.source, r.params, r.key, sorted(r.timings))
    # mesh executors are keyed by the descriptor and never reach the AOT
    # store; a single-device program beside them does
    ops.dot(*ins["dot"], impl="dpia-torch")
    store = compiler.executor_cache()
    res["keys"] = store.keys()
    aot = os.path.join(tmp, f"aot-{rank}")
    res["aot_written"] = store.save_aot(aot)
    fresh = compiler.ExecutorCache()
    res["aot_loaded"] = (fresh.load_aot(aot), fresh.keys())
    res["same_descriptor"] = _same_descriptor_work(rank, world, tmp,
                                                   ins["dot"])
    return res


def _same_descriptor_work(rank, world, tmp, args):
    """ops.dot on meshes that share a descriptor but not their ranks or
    process groups: (value, whether the output lies on the mesh asked
    for, all_reduce calls) for each case, or the error it raised."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    def dot_on(m, *xs):
        try:
            with compiler.options(backend="dpia-shardmap", mesh=m,
                                  autotune=False):
                out, seen, _ = _count_allreduce(lambda: ops.dot(*xs))
        except Exception as e:        # the case's test reads it
            return f"{type(e).__name__}: {e}"
        return float(out.to_local()), out.device_mesh is m, seen

    got = {}
    # "data=2" over ranks {0, 2} / {1, 3}, then over {0, 1} / {2, 3}; the
    # second takes a DTensor sharded on its own mesh
    first = launch_mesh.make_mesh((2, 2), ("data", "model"), "cpu")["data"]
    other = launch_mesh.make_mesh((2, 2), ("model", "data"), "cpu")["data"]
    dot_on(first, *args)
    x, y = args
    c = x.shape[0] // 2
    i = other.get_local_rank()
    xs = DTensor.from_local(x[i * c:(i + 1) * c], other, [Shard(0)],
                            run_check=False)
    got["other_ranks"] = dot_on(other, xs, y)
    # "data=4" again after the process group is destroyed and re-created
    dot_on(launch_mesh.make_mesh((world,), ("data",), "cpu"), *args)
    dist.barrier()
    dist.destroy_process_group()
    dist.init_process_group("gloo", init_method=f"file://{tmp}/regrouped",
                            rank=rank, world_size=world)
    got["regrouped"] = dot_on(
        launch_mesh.make_mesh((world,), ("data",), "cpu"), *args)
    return got


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The port's runs on 4 spawned gloo ranks, once per module."""
    tmp = str(tmp_path_factory.mktemp("mesh_ranks"))
    return ranks.spawn(_rank_work, WORLD, args=(tmp,), device="cpu",
                       timeout=300)


CASE_IDS = [(d, k, c) for d in MESHES for k, _, ch in CASES
            for c in _placements(k, ch)]


@pytest.mark.parametrize("desc,kernel,chunk", CASE_IDS)
@pytest.mark.parametrize("inner", ["torch", "cuda"])
def test_programs_equal_the_references_shardmap(port, oracle, desc, kernel,
                                                chunk, inner):
    want = oracle[f"{desc}|{kernel}|{chunk}"]
    for res in port:
        key = f"{desc}|{kernel}|{chunk}|{inner}"
        np.testing.assert_allclose(res["full"][key], want, rtol=TOL,
                                   atol=TOL)
        assert res["held"][key], key


@pytest.mark.parametrize("desc,kernel,chunk", CASE_IDS)
def test_a_mesh_reduce_is_one_all_reduce_and_a_map_none(port, desc, kernel,
                                                         chunk):
    n = 1 if kernel in REDUCES else 0
    for res in port:
        for inner in ("torch", "cuda"):
            assert res["allreduce"][f"{desc}|{kernel}|{chunk}|{inner}"] \
                == (n, n)


@pytest.mark.parametrize("desc", list(MESHES))
@pytest.mark.parametrize("kernel", OPS)
def test_ops_under_dpia_shardmap_equal_the_references(port, oracle, desc,
                                                      kernel):
    want = oracle[f"{desc}|{kernel}|None"]
    n = 1 if kernel in REDUCES else 0
    for res in port:
        np.testing.assert_allclose(res["ops"][f"{desc}|{kernel}"], want,
                                   rtol=TOL, atol=TOL)
        assert res["ops_allreduce"][f"{desc}|{kernel}"] == (n, n)


def test_mesh_executors_are_keyed_by_descriptor_and_never_saved(port):
    for res in port:
        for desc in MESHES:
            keyed = [k for k in res["keys"] if f"|shardmap|{desc}|" in k]
            # the six ops (default placement), each once
            assert sorted(k.split("|")[0] for k in keyed) == sorted(OPS)
            assert all("inner=torch" in k and "mesh_axis=data" in k
                       for k in keyed), keyed
        n_single = sum("|shardmap|" not in k for k in res["keys"])
        assert n_single >= 1
        assert res["aot_written"] == n_single
        loaded, keys = res["aot_loaded"]
        assert loaded == n_single
        assert not any("|shardmap|" in k for k in keys)


@pytest.mark.parametrize("desc", list(MESHES))
def test_measured_mesh_tune_picks_the_same_on_every_rank(port, desc):
    picks = [res["tune"][desc] for res in port]
    source, params, key, timed = picks[0]
    # a timed pick: either axis of the (2, 2) mesh may win; every rank
    # must pick the same one
    assert source == "measured" and params["mesh_axis"] in MESHES[desc][1]
    assert key.endswith(f"|{desc}") and len(timed) >= 2
    assert all(p == picks[0] for p in picks)


@pytest.mark.parametrize("desc", list(MESHES))
def test_dtensor_inputs_and_placements(port, oracle, desc):
    want = oracle[f"{desc}|dot|None"]
    for res in port:
        assert res["desc"] == list(MESHES)
        assert math.isclose(res["dtensor"][desc], float(want), rel_tol=TOL,
                            abs_tol=TOL)
        assert "placement" in res["bad_placement"]
        assert "mesh_dim_names" in res["unnamed"]


@pytest.mark.parametrize("desc", list(MESHES))
def test_indivisible_extent_runs_the_single_device_row(port, desc):
    for res in port:
        kind, got, want, fallbacks, _ = res["indivisible"][desc]
        # counted every time, warned once per kernel
        assert kind == "Tensor" and got == want and fallbacks == 1
        msgs = [m for d in MESHES for m in res["indivisible"][d][4]]
        assert sum("divides its extent" in m for m in msgs) == 1, msgs
        assert res["gemv"] == [16.0] * 128


@pytest.mark.parametrize("case", ["other_ranks", "regrouped"])
def test_a_mesh_of_the_same_descriptor_gets_its_own_executor(port, oracle,
                                                             case):
    want = float(oracle["data=4|dot|None"])
    for res in port:
        assert isinstance(res["same_descriptor"][case], tuple), \
            res["same_descriptor"][case]
        got, on_its_mesh, seen = res["same_descriptor"][case]
        assert math.isclose(got, want, rel_tol=TOL, abs_tol=TOL)
        assert on_its_mesh and seen == 1


@pytest.mark.parametrize("desc", list(MESHES))
def test_process_mesh_context(port, oracle, desc):
    want = float(oracle[f"{desc}|dot|None"])
    for res in port:
        got, dp, kept = res["ctx"][desc]
        assert math.isclose(got, want, rel_tol=TOL, abs_tol=TOL)
        assert dp == ("data",)
        assert kept == (("model",) if desc != "data=4" else None)
        same, sp, raised = res["ctx_constraint"][desc]
        assert same
        if "model" in desc:
            assert sp is True
            assert "tensor-parallel train step" in raised
        else:
            assert sp is None and raised is None


# ---------------------------------------------------------------------------
# in process, no ranks
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
    return a


@pytest.mark.parametrize("arg", [None, "", "single", "data=8",
                                 "pod=2,data=16,model=16"])
def test_descriptor_round_trips_as_the_references(arg):
    _same(lambda: mesh.descriptor(arg), lambda: jmesh.descriptor(arg))
    d = mesh.descriptor(arg)
    _same(lambda: mesh.parse_descriptor(d), lambda: jmesh.parse_descriptor(d))


@pytest.mark.parametrize("bad", ["data8", "data=", "=4", "data=x"])
def test_malformed_descriptors_raise_as_the_references(bad):
    kind, _ = _same(lambda: mesh.parse_descriptor(bad),
                    lambda: jmesh.parse_descriptor(bad))
    assert kind == "ValueError"


def test_a_non_mesh_raises_naming_devicemesh():
    with pytest.raises(TypeError, match="DeviceMesh"):
        mesh.descriptor(42)
    with pytest.raises(TypeError, match="Mesh"):
        jmesh.descriptor(42)


@pytest.mark.parametrize("args", [
    ("data=8", 4), ("data=16,model=16", 64), ("pod=2,data=16,model=16", 256),
    ("pod=2,data=16,model=16", 128, "data"), ("single", 1), ("data=8", 0),
    ("data=2,model=4", 2), ("data=8", 4, "model")])
def test_shrink_descriptor_equals_the_references(args):
    _same(lambda: mesh.shrink_descriptor(*args),
          lambda: jmesh.strategy.shrink_descriptor(*args))


@pytest.mark.parametrize("axis,op,extent,axes", [
    ("data", "reduce", 512, {"data": 8}), ("model", "map", None, {"data": 8}),
    ("data", "map", 100, {"data": 8}), ("data", "scan", None, {"data": 8}),
    ("model", "map", 64, {"data": 2, "model": 4})])
def test_mesh_strategy_validates_as_the_references(axis, op, extent, axes):
    def run(M):
        s = M.MeshStrategy(axis, op=op, extent=extent)
        return (s.validate(axes).describe(), s.shards(axes), s.params(),
                M.MeshStrategy.from_params(s.params(), extent=extent).axis)
    _same(lambda: run(mesh), lambda: run(jmesh))


BUILD_SHAPES = {"dot": [{"n": 1024}, {"n": 4096}],
                "asum": [{"n": 1024}, {"n": 4096}],
                "scal": [{"n": 1024}, {"n": 4096}],
                "rmsnorm": [{"rows": 32, "d": 16}, {"rows": 64, "d": 8}],
                "softmax": [{"rows": 32, "d": 16}, {"rows": 64, "d": 8}],
                "matmul": [{"m": 16, "k": 32, "n": 8},
                           {"m": 64, "k": 64, "n": 16}]}
CHUNK = {"dot": 64, "asum": 64, "scal": 64, "rmsnorm": 4, "softmax": 4,
         "matmul": 8}


@pytest.mark.parametrize("kernel", OPS)
@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("chunked", [False, True])
def test_builders_print_the_references_terms(kernel, which, chunked):
    shape = BUILD_SHAPES[kernel][which]
    c = CHUNK[kernel] if chunked else None
    texts = [normalise(pkg.pretty.show(_term(pkg, kernel, 4, c, shape)[0]))
             for pkg in (PORT, REF)]
    assert texts[0] == texts[1]


def test_dpia_blas_mesh_dot_prints_the_references_term():
    a = normalise(tpretty.show(tblas.mesh_dot(1024, "data", 8)[0]))
    b = normalise(jpretty.show(jblas.mesh_dot(1024, "data", 8)[0]))
    assert a == b


SPACE_SHAPES = {"dot": {"n": 1 << 16}, "asum": {"n": 1 << 16},
                "scal": {"n": 1 << 16}, "rmsnorm": {"rows": 4096, "d": 64},
                "softmax": {"rows": 4096, "d": 64},
                "matmul": {"m": 64, "k": 2048, "n": 32}}
AXES = [{"data": 8}, {"data": 2, "model": 4}]


@pytest.mark.parametrize("kernel", OPS)
@pytest.mark.parametrize("axes", AXES, ids=["data8", "data2model4"])
def test_mesh_space_and_costs_equal_the_references(kernel, axes):
    shape = SPACE_SHAPES[kernel]
    mine = mesh.mesh_space(kernel, axes, **shape)
    theirs = jmesh.mesh_space(kernel, axes, **shape)
    assert [c.params for c in mine] == [c.params for c in theirs]
    assert len(mine) > 1
    assert mesh.default_mesh_params(kernel, axes, **shape) == \
        jmesh.default_mesh_params(kernel, axes, **shape)
    for a, b in zip(mine, theirs):
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


@pytest.mark.parametrize("kernel", OPS)
def test_descriptor_tune_equals_the_references(tmp_path, monkeypatch, kernel):
    monkeypatch.setattr(cost, "default_platform", lambda: "cpu")
    kw = dict(backend="shardmap", mesh="data=8", **SPACE_SHAPES[kernel])
    got = autotune.tune(kernel, measure=False,
                        cache=str(tmp_path / "t.json"), **kw)
    want = jautotune.tune(kernel, measure=False,
                          cache=str(tmp_path / "j.json"), **kw)
    assert (got.key, got.params, got.source) == \
        (want.key, want.params, want.source)
    # measure=True with only a descriptor settles on the analytic record
    again = autotune.tune(kernel, measure=True,
                          cache=str(tmp_path / "t.json"), **kw)
    assert again.source == "cache" and again.params == got.params
    assert obs.explain(kernel) and any(
        d.kind == "mesh" and d.key == got.key for d in obs.decisions())


@pytest.mark.parametrize("kernel,shape,mesh_,error", [
    ("dot", {"n": 1024}, None, "empty strategy space.*on mesh 'single'"),
    ("rmsnorm", {"rows": 7, "d": 16}, "data=8", "empty strategy space"),
    ("dot", {"n": 1024}, "", "empty strategy space"),
    ("softmax", {"rows": 64, "d": 8}, "model=1", "empty strategy space"),
    # gemv has no mesh strategy: the reference's KeyError, as it is
    ("gemv", {"m": 64, "n": 64}, "data=8", "gemv")])
def test_tuner_errors_equal_the_references(tmp_path, kernel, shape, mesh_,
                                           error):
    kw = dict(backend="shardmap", mesh=mesh_, measure=False, **shape)
    kind, msg = _same(
        lambda: autotune.tune(kernel, cache=str(tmp_path / "t"), **kw),
        lambda: jautotune.tune(kernel, cache=str(tmp_path / "j"), **kw))
    assert kind in ("ValueError", "KeyError") and re.search(error, msg)


def test_shardmap_compile_without_a_mesh_raises_the_references_error():
    def run(C, M):
        expr, argv = M.mesh_dot(64, "data", 1)
        C.Program(expr, argv).compile("shardmap")
    kind, msg = _same(lambda: run(compiler, mesh), lambda: run(jcompiler,
                                                                jmesh))
    assert kind == "TypeError" and "requires keyword" in msg


def test_no_mesh_in_scope_runs_the_single_device_row(rng):
    x = rng.randn(256).astype(np.float32)
    y = rng.randn(256).astype(np.float32)
    ops.clear_caches()
    before = obs.counter("kernels.fallbacks").value
    with pytest.warns(RuntimeWarning, match="no mesh"):
        got = ops.dot(torch.from_numpy(x), torch.from_numpy(y),
                      impl="dpia-shardmap")
    assert obs.counter("kernels.fallbacks").value == before + 1
    with pytest.warns(RuntimeWarning, match="no mesh"):
        want = jops.dot(x, y, impl="dpia-shardmap")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    assert compiler.CompileOptions(
        backend="dpia-shardmap").mesh_descriptor() == "single"


@pytest.mark.parametrize("kernel", OPS)
def test_shard_bodies_through_k4_keep_the_strategys_grid(kernel):
    """``inner="cuda"`` generates each shard's body (codegen only): no GRID
    level at the default placement is one block; a chunk is one CUDA block
    a chunk."""
    shape = BUILD_SHAPES[kernel][1]
    grids = []
    for c in (None, CHUNK[kernel]):
        prog, sb = stage3_shardmap.shard_program(
            *_term(PORT, kernel, 4, c, shape), 4, inner="cuda", name=kernel)
        assert sb.shards == 4 and sb.form == ("reduce" if kernel in REDUCES
                                              else "map")
        grids.append([s.grid for s in prog.stages if s.kind == "grid"])
    assert grids[0] == []
    if kernel != "matmul":      # bk blocks the contraction sequentially
        assert grids[1] and grids[1][0][0] > 1
    else:
        assert grids[1] == []


def test_unported_mesh_pieces_and_launch_mesh():
    assert ctx.get_mesh() is None and ctx.dp_axes() is None
    t = torch.ones(3)
    assert ctx.constraint(t, "data") is t
    with pytest.raises(TypeError, match="DeviceMesh"):
        ctx.set_mesh(object())
    with pytest.raises(ValueError, match="256 ranks"):
        launch_mesh.make_production_mesh(device_type="cpu")
    assert launch_mesh.production_descriptor(multi_pod=True) == \
        "pod=2,data=16,model=16"
    with pytest.raises(ValueError, match="differ in length"):
        launch_mesh.make_mesh((2, 2), ("data",), "cpu")
    with pytest.raises(ValueError, match="shardmap: inner"):
        stage3_shardmap.shard_program(*_term(PORT, "dot", 4, None, {"n": 64}),
                                      4, inner="pallas")
    with pytest.raises(stage3_shardmap.MeshFormError, match="has 2"):
        stage3_shardmap.shard_program(*_term(PORT, "dot", 4, None, {"n": 64}),
                                      2)


def test_k4_refuses_mesh_levels_naming_the_shardmap_backend():
    from repro_torch.core.dpia import stage3_cuda
    expr, argv = _term(PORT, "scal", 4, None, {"n": 64})
    with pytest.raises(NotImplementedError, match="shardmap.*inner=.cuda"):
        compiler.Program(expr, argv).check().lower().compile("cuda")
    assert "MESH" in stage3_cuda._MESH_MSG


def _failing_rank(rank, world):
    import torch.distributed as dist
    if rank == 1:
        raise ValueError("rank one fails")
    dist.all_reduce(torch.ones(1))       # waits on the rank that failed
    return rank


def test_a_failed_rank_fails_the_spawn_and_leaves_no_process():
    import multiprocessing as mp
    with pytest.raises(ranks.RankFailure, match="rank one fails"):
        ranks.spawn(_failing_rank, 2, timeout=120)
    assert not mp.active_children()


def test_concurrent_builds_of_one_program_never_read_half_a_source(tmp_path):
    """Ranks of a mesh build the same K4 shard at once: each source is
    written under its own name and renamed into place, so no compiler
    reads a truncated file (the stand-in compiler fails on anything but
    the whole text)."""
    import multiprocessing as mp
    import sys
    from concurrent.futures import ProcessPoolExecutor
    text = "// generated\n" + "x" * (8 << 20) + "\n"
    (tmp_path / "want.cu").write_text(text)
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\nimport sys, time\n"
        f"a = sys.argv[1:]\nsrc, out = a[-1], a[a.index('-o') + 1]\n"
        f"if open(src).read() != open({str(tmp_path / 'want.cu')!r}).read():"
        f"\n    sys.exit('half a source')\n"
        f"time.sleep(0.05)\nopen(out, 'w').write('lib')\n")
    fake.chmod(0o755)
    n = 12
    ctx = mp.get_context("spawn")
    with ctx.Manager() as manager, ProcessPoolExecutor(
            n, mp_context=ctx) as pool:
        barrier = manager.Barrier(n)
        futs = [pool.submit(build_same_program, i, str(tmp_path / "dpia"),
                            str(fake), text, barrier) for i in range(n)]
        assert [f.result(timeout=300) for f in futs] == ["lib"] * n
