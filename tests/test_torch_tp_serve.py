"""Serving with the params split over ``model`` in the port (``sharding.
serving.ServingStep``: ``Model.prefill`` and ``Model.decode_step`` on a
rank's pieces) on the CPU, held against the reference's lowered steps on
the same mesh, as its dry run lowers them: ``jit`` of ``model.prefill``
and ``model.decode_step`` with ``rules.params_specs`` and ``rules.
cache_specs`` shardings (``src/repro/launch/dryrun.py``).

Cases, each ``(data, model)``:

  * qwen3-4b's smoke config (4 heads, 2 kv heads) on (1, 2), (2, 2) and
    (1, 4): the kv heads over ``model`` on the first two, the positions
    over ``model`` on (1, 4); a prompt that ``model`` does not divide (SP
    off in the prefill too) on (1, 2);
  * one kv head on (1, 2): the positions over ``model``, rows of two
    lengths (each row's logits at its last real position) and a decode
    step at each row's own position (a (b,) ``pos``);
  * dbrx-132b's smoke MoE (4 experts) on (1, 2): the experts over
    ``model``, their outputs all-gathered for the combine (the
    reference's serving MoE);
  * a MoE of 3 experts on (1, 2), which ``model`` does not divide: each
    expert's ff columns over ``model`` (corner (i));
  * musicgen-large's smoke config (4 codebooks) on (2, 2);
  * 6 heads on (1, 4): a rank cannot hold whole heads, so the attention
    runs whole on every rank, against the positions over ``model``.

Each compares in fp32: the prefill's and 6 greedy decode steps' logits
within ``LOGIT_TOL`` of the largest magnitude (the port's collectives sum
in other orders, and the merge of a decode step's partial attention
normalises after P.V, the reference before), every rank of ``model`` the
same logits; the greedy tokens identical; each rank's cache slice the
reference's shard under ``cache_specs`` within ``CACHE_TOL``, and its
bytes the dry run's ``cache_bytes`` for that mesh.

One train step of the MoE corners against the reference's jitted step
on (1, 2): 3 experts (corner (i)), with SP and without, and dbrx's 4
experts on a sequence that ``model`` does not divide (corner (ii): the
reference's fallback from its all-to-all to ``ffn.moe``); tolerances
``tests/test_torch_tp_train.py``'s.

The reference runs in one subprocess on 4 forced host devices; the port's
ranks run in two spawns (4 ranks, then 2) beside it.
"""
import dataclasses
import math
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _tp_serve_ranks as R
from repro.configs import smoke_config as jsmoke
from repro.models.common import ModelConfig as JModelConfig
from repro.models.transformer import Model as JModel
from repro_torch.launch import dryrun
from repro_torch.models.common import ModelConfig
from repro_torch.models.convert import train_state_from_numpy
from repro_torch.sharding import rules
from repro_torch.testing import ranks
from test_torch_sharded_train import LEAF_TOL, LOSS_RTOL, _ref_numpy
from test_torch_tp_train import (REF_SCRIPT, _assert_close, _batches,
                                 _initial_state)
from _sharded_train_ranks import numpy_state
from _tp_train_ranks import STEP

LOGIT_TOL = 2e-5
CACHE_TOL = 1e-5
STEPS, BATCH = 6, 2

QWEN3 = dataclasses.asdict(jsmoke("qwen3_4b"))
DBRX = dataclasses.asdict(jsmoke("dbrx_132b"))
MOE3 = {**dataclasses.asdict(jsmoke("grok_1_314b")), "n_experts": 3}

# name: (mesh (data, model), config fields, prompt length, row lengths,
# the KV layout over model)
CASES = {
    "qwen3_m2": ((1, 2), QWEN3, 12, None, "heads"),
    "qwen3_m2_sp_off": ((1, 2), QWEN3, 11, None, "heads"),
    "qwen3_dp": ((2, 2), QWEN3, 12, None, "heads"),
    "qwen3_m4": ((1, 4), QWEN3, 12, None, "seq"),
    "kv1_m2": ((1, 2), {**QWEN3, "n_kv_heads": 1}, 12, (12, 7), "seq"),
    "dbrx_m2": ((1, 2), DBRX, 12, None, "heads"),
    "moe3_m2": ((1, 2), MOE3, 12, None, "heads"),
    "musicgen_dp": ((2, 2), dataclasses.asdict(jsmoke("musicgen_large")),
                    12, None, "heads"),
    "heads6_m4": ((1, 4), {**dataclasses.asdict(jsmoke("qwen1_5_32b")),
                           "n_heads": 6, "n_kv_heads": 6, "head_dim": 16},
                  12, None, "seq"),
}

# name: (mesh, config fields, sequence)
TRAIN_CASES = {
    "moe3_train": ((1, 2), MOE3, 16),
    "moe3_train_sp_off": ((1, 2), MOE3, 15),
    "dbrx_train_sp_off": ((1, 2), DBRX, 15),
}

SERVE_SCRIPT = r"""
from jax.sharding import NamedSharding, PartitionSpec as PS
from repro.sharding import ctx, rules
serve_in = pickle.load(open(sys.argv[3], "rb"))
sout = {}
for name, (cfg_kw, shape, params, prompts, lengths, steps) in \
        serve_in.items():
    cfg = ModelConfig(**cfg_kw)
    model = Model(cfg)
    mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape),
                ("data", "model"))
    ctx.set_mesh(mesh)
    named = lambda spec: jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), spec,
        is_leaf=lambda x: isinstance(x, PS))
    b = prompts.shape[0]
    params = jax.tree_util.tree_map(jnp.asarray, params)
    cache = model.init_cache(b, cfg.max_seq)
    p_spec = rules.params_specs(params, mesh, cfg)
    c_spec = rules.cache_specs(cfg, mesh, cache)
    t_spec = PS(("data",)) if b % shape[0] == 0 else PS(None)
    params = jax.device_put(params, named(p_spec))
    cache = jax.device_put(cache, named(c_spec))
    pre = jax.jit(lambda p, t, c, l: model.prefill(p, t, c, lengths=l),
                  in_shardings=(named(p_spec), named(t_spec), named(c_spec),
                                None),
                  out_shardings=(None, named(c_spec)))
    dec = jax.jit(lambda p, t, c, pos: model.decode_step(p, t, c, pos),
                  in_shardings=(named(p_spec), named(t_spec), named(c_spec),
                                None),
                  out_shardings=(None, named(c_spec)))
    lens = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    logits, cache = pre(params, jnp.asarray(prompts, jnp.int32), cache, lens)
    rec = {"logits": [np.asarray(logits)], "tokens": []}
    for i in range(steps):
        nxt = np.asarray(logits).argmax(-1)
        rec["tokens"].append(nxt)
        tok = nxt[:, None]
        if cfg.n_codebooks:
            tok = np.repeat(tok[..., None], cfg.n_codebooks, -1)
        pos = (jnp.int32(prompts.shape[1] + i) if lens is None
               else lens + i)
        logits, cache = dec(params, jnp.asarray(tok, jnp.int32), cache, pos)
        rec["logits"].append(np.asarray(logits))
    rec["cache"] = (np.asarray(cache.k), np.asarray(cache.v))
    sout[name] = rec
    ctx.set_mesh(None)
pickle.dump(sout, open(sys.argv[4], "wb"))
"""


def _np_params(kw, seed):
    return jax.tree_util.tree_map(np.asarray, JModel(
        JModelConfig(**kw)).init_params(jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp_serve"))
    rng = np.random.RandomState(7)
    serve, serve_ref = {}, {}
    for i, (name, (shape, kw, s, lengths, _)) in enumerate(CASES.items()):
        extra = (kw["n_codebooks"],) if kw["n_codebooks"] else ()
        prompts = rng.randint(0, kw["vocab"], (BATCH, s) + extra)
        lens = None if lengths is None else np.asarray(lengths)
        params = _np_params(kw, seed=40 + i)
        serve[name] = (shape, kw, params, prompts, lens, STEPS)
        serve_ref[name] = (kw, shape, params, prompts, lens, STEPS)
    train, train_ref = {}, {}
    for i, (name, (shape, kw, seq)) in enumerate(TRAIN_CASES.items()):
        jcfg = JModelConfig(**kw)
        state = _initial_state(jcfg, seed=60 + i)
        batches = _batches(jcfg.vocab, seq, 1, seed=600 + i)
        train_ref[name] = (kw, shape, dict(STEP), batches,
                           [np.asarray(a) for a in
                            jax.tree_util.tree_leaves(state)])
        train[name] = (shape, kw, {}, _ref_numpy(state), batches,
                       jax.tree_util.tree_structure(state))
    paths = [os.path.join(tmp, p) for p in (
        "train_in.pkl", "train_out.pkl", "serve_in.pkl", "serve_out.pkl")]
    for path, obj in ((paths[0], train_ref), (paths[2], serve_ref)):
        with open(path, "wb") as f:
            pickle.dump(obj, f)
    env = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", "/usr/bin"),
           "HOME": os.environ.get("HOME", tmp), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "REPRO_AUTOTUNE_CACHE": os.path.join(tmp, "autotune.json")}
    script = REF_SCRIPT.replace('print("OK")', SERVE_SCRIPT + 'print("OK")')
    ref = subprocess.Popen(
        [sys.executable, "-c", script] + paths, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        results = {}
        for world in (4, 2):
            results[world] = ranks.spawn(
                R.rank_work, world, timeout=300, args=(
                    {k: v for k, v in serve.items()
                     if math.prod(v[0]) == world},
                    {k: v[:5] for k, v in train.items()
                     if math.prod(v[0]) == world}))
        out, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0 and "OK" in out, out + err
    with open(paths[1], "rb") as f:
        train_out = pickle.load(f)
    with open(paths[3], "rb") as f:
        serve_out = pickle.load(f)
    train_want = {name: [(m, _ref_numpy(jax.tree_util.tree_unflatten(
        train[name][5], leaves))) for m, leaves in steps]
        for name, steps in train_out.items()}
    return {"serve": serve, "train": train, "results": results,
            "serve_ref": serve_out, "train_ref": train_want}


def _ranks(run, shape):
    return run["results"][math.prod(shape)]


def _rows(run, name, key, step):
    """The whole batch's ``key`` of ``step`` from the ranks at model index
    0 (each holds its data rows), and every rank's for the agreement."""
    (d, m) = CASES[name][0]
    res = [r["serve"][name] for r in _ranks(run, CASES[name][0])]
    whole = np.concatenate([res[i * m][key][step] for i in range(d)])
    return whole, res


@pytest.mark.parametrize("name", list(CASES))
def test_logits_match_the_reference(run, name):
    """The prefill's and every decode step's logits, whole over the vocab
    and the same on every rank of ``model``."""
    want = run["serve_ref"][name]["logits"]
    m = CASES[name][0][1]
    for step, w in enumerate(want):
        got, res = _rows(run, name, "logits", step)
        for i, r in enumerate(res):
            np.testing.assert_array_equal(r["logits"][step],
                                          res[i - i % m]["logits"][step])
        np.testing.assert_allclose(got, w, rtol=0,
                                   atol=LOGIT_TOL * np.abs(w).max(),
                                   err_msg=f"{name} step {step}")


@pytest.mark.parametrize("name", list(CASES))
def test_greedy_tokens_are_the_references(run, name):
    want = run["serve_ref"][name]["tokens"]
    assert len(want) == STEPS
    for step, w in enumerate(want):
        got, _ = _rows(run, name, "tokens", step)
        np.testing.assert_array_equal(got, w, err_msg=f"{name} {step}")


@pytest.mark.parametrize("name", list(CASES))
def test_cache_slices_are_the_references_shards(run, name):
    """After the prefill and 6 decode steps each rank's k / v is its shard
    of the reference's cache under ``cache_specs`` (its batch rows and
    its kv heads or positions), in the layout the case names, and holds
    the dry run's ``cache_bytes`` of that mesh."""
    (d, m), kw, _, _, layout = CASES[name]
    cfg = ModelConfig(**kw)
    mesh = {"data": d, "model": m}
    wk, wv = run["serve_ref"][name]["cache"]
    spec = rules.cache_specs(cfg, mesh, {"k": wk})["k"]
    rec = dryrun.reckon(cfg, {"seq": cfg.max_seq, "batch": BATCH,
                              "kind": "decode"}, mesh)
    for rank, res in enumerate(_ranks(run, (d, m))):
        r = res["serve"][name]
        assert r["kv"]["layout"] == layout
        coord = {"data": rank // m, "model": rank % m}
        gk, gv = r["cache"]
        assert gk.nbytes + gv.nbytes == rec["memory"]["cache_bytes"]
        for got, whole in ((gk, wk), (gv, wv)):
            want = rules.local_shard(torch.from_numpy(whole), mesh, spec,
                                     coord).numpy()
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=CACHE_TOL * np.abs(whole).max())


def test_a_decode_step_merges_partial_attention_over_model(run):
    """On the positions-over-``model`` layout a decode step issues per
    layer the log-sum-exp merge: an all-reduce max of each query head's
    score maximum (b nh fp32) and one all-reduce of each head's sum and
    output (b nh (hd + 1) fp32), besides the embedding's, the attention's
    and the MLP's all-reduces of (b, 1, d); the heads layout issues no
    merge."""
    for name in ("kv1_m2", "qwen3_m2"):
        _, kw, _, _, layout = CASES[name]
        cfg = ModelConfig(**kw)
        b, d, hd = BATCH, cfg.d_model, cfg.hd
        act = b * d * 4
        merge = b * cfg.n_heads * 4 + b * cfg.n_heads * (hd + 1) * 4
        for res in _ranks(run, CASES[name][0]):
            for c in res["serve"][name]["counts"][1:]:
                layers = cfg.n_layers
                if layout == "seq":
                    assert c["all_reduce"] == 1 + 4 * layers
                    assert c["all_reduce_bytes"] == act + layers * (
                        2 * act + merge)
                else:
                    assert c["all_reduce"] == 1 + 2 * layers
                    assert c["all_reduce_bytes"] == act * (1 + 2 * layers)


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_moe_corner_train_step_matches_the_reference(run, name):
    """One step: loss, grad norm and every param and moment (gathered
    whole) on each rank."""
    shape, kw, _ = TRAIN_CASES[name]
    cfg = ModelConfig(**kw)

    def port(np_state):
        return numpy_state(train_state_from_numpy(cfg, np_state,
                                                  device="cpu"))
    prev = port(run["train"][name][3])
    (jm, jst), = run["train_ref"][name]
    for res in _ranks(run, shape):
        (m, got), = res["train"][name]["steps"]
        assert m["applied"] == int(jm["applied"]) == 1
        np.testing.assert_allclose(m["loss"], jm["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"],
                                   rtol=LOSS_RTOL)
        _assert_close(got, port(jst), prev, LEAF_TOL)
