"""The engines' ``tuning_cache=`` warm-up in the port, held against the
reference's (``src/repro/serve/engine.py`` ``_warm`` / ``_aot_dir``): at
construction an engine given a tuning cache pre-tunes the model's op
shapes (``self.tuned``), loads a prior engine's programs from its AOT
directory, stages the executor of every shape of ``autotune.
model_kernel_shapes`` and exports the keys it staged itself.

On the CPU both packages tune for the ``cpu`` preset; their backend names
differ (``torch`` for the reference's ``jnp``), as in
``tests/test_torch_autotune.py``.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.models.transformer import Model as JModel
from repro.serve import engine as jengine
from repro_torch import autotune, compiler
from repro_torch.configs import smoke_config
from repro_torch.kernels import ops
from repro_torch.models.transformer import Model
from repro_torch.serve.engine import (BatchedEngine, ContinuousEngine,
                                      Request)

MAX_SEQ = 32


@pytest.fixture
def fresh(monkeypatch):
    """Empty executor caches before and after, the ``cpu`` preset on any
    machine (the reference plans for the CPU here), and no process mesh
    in either package (both tuners key their records by the active mesh's
    descriptor: an earlier test's mesh would name another)."""
    from repro.sharding import ctx as jctx
    from repro_torch.sharding import ctx
    monkeypatch.setattr(autotune.cost, "default_platform", lambda: "cpu")
    meshes = jctx.get_mesh(), ctx.get_mesh()
    jctx.set_mesh(None)
    ctx.set_mesh(None)
    ops.clear_caches()
    try:
        yield
    finally:
        ops.clear_caches()
        jctx.set_mesh(meshes[0])
        ctx.set_mesh(meshes[1])


def _model(arch="qwen3_4b", **fields):
    cfg = smoke_config(arch, **fields)
    model = Model(cfg)
    return model, model.init_params(torch.Generator().manual_seed(0), "cpu")


def _keys_in(directory):
    out = set()
    for name in os.listdir(directory):
        if name.endswith(".json"):
            with open(os.path.join(directory, name)) as f:
                out.add(json.load(f)["key"])
    return out


@pytest.mark.parametrize("engine", ["batched", "continuous"])
def test_tuned_equals_the_references(fresh, tmp_path, engine):
    """``engine.tuned`` (cache keys and params) of both packages' engines
    for the same smoke config, ``max_seq`` and ``batch_sizes`` (the
    continuous engine's default: ``(1, slots)``)."""
    import jax
    model, params = _model()
    jmodel = JModel(jsmoke("qwen3_4b"))
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    if engine == "batched":
        got = BatchedEngine(model, params, max_seq=MAX_SEQ, chunk=4,
                            tuning_cache=str(tmp_path / "t.json"),
                            batch_sizes=(1, 2), aot=False).tuned
        want = jengine.BatchedEngine(
            jmodel, jparams, max_seq=MAX_SEQ, chunk=4,
            tuning_cache=str(tmp_path / "j.json"), batch_sizes=(1, 2),
            aot=False).tuned
    else:
        got = ContinuousEngine(model, params, max_seq=MAX_SEQ, slots=2,
                               chunk=4, tuning_cache=str(tmp_path / "t.json"),
                               aot=False).tuned
        want = jengine.ContinuousEngine(
            jmodel, jparams, max_seq=MAX_SEQ, slots=2, chunk=4,
            tuning_cache=str(tmp_path / "j.json"), aot=False).tuned
    assert got and {k.replace("|torch|", "|jnp|"): v
                    for k, v in got.items()} == want


def test_aot_holds_only_the_engines_own_keys(fresh, tmp_path):
    """Two models in one process: each engine's ``<cache>.aot`` holds the
    keys it staged, none of the other's, though the executor cache holds
    both."""
    qwen, qp = _model("qwen3_4b")
    stable, sp = _model("stablelm_1_6b", d_model=128, d_ff=256)
    a = str(tmp_path / "a.json")
    b = str(tmp_path / "b.json")
    BatchedEngine(qwen, qp, max_seq=MAX_SEQ, tuning_cache=a,
                  batch_sizes=(1, 2))
    staged_a = set(compiler.executor_cache().keys())
    BatchedEngine(stable, sp, max_seq=MAX_SEQ, tuning_cache=b,
                  batch_sizes=(1, 2))
    staged_b = set(compiler.executor_cache().keys()) - staged_a
    assert staged_a and staged_b
    assert _keys_in(a + ".aot") == staged_a
    assert _keys_in(b + ".aot") == staged_b


def test_a_second_engine_stages_nothing(fresh, tmp_path):
    """Engine 1 tunes, stages and exports; engine 2, in fresh executor
    caches, loads every program from the store and stages none, then
    serves."""
    model, params = _model()
    path = str(tmp_path / "t.json")
    BatchedEngine(model, params, max_seq=MAX_SEQ, tuning_cache=path,
                  batch_sizes=(1, 2), chunk=4)
    built = compiler.executor_cache().stats()["builds"]
    assert built > 0 and len(os.listdir(path + ".aot")) == built
    ops.clear_caches()
    e2 = BatchedEngine(model, params, max_seq=MAX_SEQ, tuning_cache=path,
                       batch_sizes=(1, 2), chunk=4)
    st = compiler.executor_cache().stats()
    assert st["builds"] == 0 and st["aot_loads"] == built, st
    outs = e2.run([Request(prompt=np.arange(5) % model.cfg.vocab,
                           max_new_tokens=4)])
    assert len(outs[0]) == 4


@pytest.mark.parametrize("aot", [None, False])
def test_no_aot_exports_nothing(fresh, tmp_path, aot):
    """``aot=None`` / ``False``: the engine pre-tunes (its ``tuned``) and
    stages nothing, and no store is written."""
    model, params = _model()
    path = str(tmp_path / "t.json")
    e = ContinuousEngine(model, params, max_seq=MAX_SEQ, slots=2,
                         tuning_cache=path, aot=aot)
    assert e.tuned and compiler.executor_cache().stats()["builds"] == 0
    assert not os.path.exists(path + ".aot")


def test_an_explicit_aot_directory(fresh, tmp_path):
    """``aot=<dir>`` exports there, whatever the cache's path."""
    model, params = _model()
    where = str(tmp_path / "store")
    ContinuousEngine(model, params, max_seq=MAX_SEQ, slots=2,
                     tuning_cache=autotune.TuningCache(
                         str(tmp_path / "t.json")), aot=where)
    assert _keys_in(where) == set(compiler.executor_cache().keys())
    assert not os.path.exists(str(tmp_path / "t.json.aot"))
