"""The recurrent families served with the params split over ``model`` in
the port (``sharding.serving.ServingStep``: rwkv6's and zamba2's
``Model.prefill`` and ``Model.decode_step`` on a rank's pieces) on the
CPU, held against the reference's lowered steps on the same mesh, as its
dry run lowers them: ``jit`` of ``model.prefill`` and
``model.decode_step`` with ``rules.params_specs`` and ``rules.
cache_specs`` shardings (``src/repro/launch/dryrun.py``).

The cache at rest is the rules' layout; the mixers compute on the train
step's split; each layer's state (each group's, for the hybrid) moves
between the two (``collectives.StateMove``).  The cases, fp32, at widths
whose heads split (as ``tests/test_torch_recurrent_tp.py`` chose them),
each ``(data, model)``, cover every layout the rules give these leaves:

  * rwkv6 at d_model 256 (4 heads) on (1, 2), (2, 2) and (1, 4): ``wkv``
    split over its key index at rest, over heads in the mixer (one
    all-to-all each way); ``tshift`` / ``cshift`` over their channels at
    rest, whole in the mixer;
  * rwkv6 at d_model 192 (3 heads) on (1, 2): the time-mix whole on every
    rank;
  * zamba2 at d_model 128 (4 mamba heads) on (1, 2) with 2 rows: ``ssm``
    over each head's 64 channels ``p`` at rest, the conv tail over the
    batch rows; on (2, 2): the rules split the layers of a group over
    ``data`` (the hybrid's leaves take ``attn_every`` for their batch
    dim); on (1, 4): the conv tail whole; with 64 rows and a 4-token
    prompt: ``ssm`` over the batch rows at rest;
  * for each family a prompt that ``model`` does not divide (SP off, on
    (1, 4)) and rows of two lengths (the state masked past each row's
    length, on (1, 2)).

Each compares the prefill's and 6 greedy decode steps' logits within
``LOGIT_TOL`` of the largest magnitude, every rank of ``model`` the same
logits; the greedy tokens identical; each rank's state and KV slices after
the prefill and after the last step the reference's shards under
``cache_specs`` within ``CACHE_TOL`` of the leaf's largest magnitude, and
their bytes the dry run's ``cache_bytes`` for that mesh.

``test_state_moves_round_trip`` holds the moves alone, on every spec the
rules give these leaves (the full-width ones among them, at small
shapes): rules piece -> mixer piece (the global leaf's rows and heads of
the rank) -> rules piece equals ``rules.local_shard``.

The reference runs in ``REF_PROCESSES`` subprocesses on 4 forced host
devices at once; the port's ranks run in two spawns (4 ranks, then 2)
beside them.
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

import _recurrent_tp_serve_ranks as R
from repro.configs import smoke_config as jsmoke
from repro.models.common import ModelConfig as JModelConfig
from repro.models.transformer import Model as JModel
from repro_torch.launch import dryrun
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import Model
from repro_torch.sharding import rules
from repro_torch.sharding.collectives import CountingMesh
from repro_torch.sharding.serving import ServingStep
from repro_torch.testing import ranks

LOGIT_TOL = 2e-5
CACHE_TOL = 1e-5
STEPS = 6
REF_PROCESSES = 3


def _kw(arch, **fields):
    return dataclasses.asdict(dataclasses.replace(jsmoke(arch), **fields))


RWKV = _kw("rwkv6_1_6b", d_model=256)
ZAMBA = _kw("zamba2_2_7b", d_model=128)

# name: (mesh (data, model), config fields, prompt length, rows, row
# lengths, {leaf: its spec under cache_specs})
CASES = {
    "rwkv_m2": ((1, 2), RWKV, 12, 2, (12, 7), {
        "tshift": (None, "data", "model"),
        "wkv": (None, "data", None, "model", None)}),
    "rwkv_dp": ((2, 2), RWKV, 12, 2, None, {
        "cshift": (None, "data", "model"),
        "wkv": (None, "data", None, "model", None)}),
    "rwkv_m4_sp_off": ((1, 4), RWKV, 11, 2, None, {
        "wkv": (None, "data", None, "model", None)}),
    "rwkv_heads3": ((1, 2), _kw("rwkv6_1_6b", d_model=192), 12, 2, None, {
        "wkv": (None, "data", None, "model", None)}),
    "zamba_m2": ((1, 2), ZAMBA, 12, 2, (12, 7), {
        "mamba/conv": (None, "data", "model", None, None),
        "mamba/ssm": (None, "data", None, None, "model", None)}),
    "zamba_dp": ((2, 2), ZAMBA, 12, 2, None, {
        "mamba/conv": (None, "data", "model", None, None),
        "mamba/ssm": (None, "data", None, None, "model", None)}),
    "zamba_m4_sp_off": ((1, 4), ZAMBA, 11, 2, None, {
        "mamba/conv": (None, "data", None, None, None),
        "mamba/ssm": (None, "data", None, None, "model", None)}),
    "zamba_b64": ((1, 2), ZAMBA, 4, 64, None, {
        "mamba/conv": (None, "data", "model", None, None),
        "mamba/ssm": (None, "data", "model", None, None, None)}),
}

# the state moves alone: name -> (config fields, mesh, rows)
MOVES = {
    "rwkv_m2": (RWKV, (1, 2), 2),
    "rwkv_dp": (RWKV, (2, 2), 2),
    "rwkv_dp_rows_whole": (RWKV, (2, 2), 3),
    "rwkv_m4": (RWKV, (1, 4), 2),
    "rwkv_heads3": (_kw("rwkv6_1_6b", d_model=192), (1, 2), 2),
    "zamba_m2": (ZAMBA, (1, 2), 2),
    "zamba_dp": (ZAMBA, (2, 2), 2),
    "zamba_m4": (ZAMBA, (1, 4), 2),
    "zamba_b64": (ZAMBA, (1, 2), 64),
    # the production decode's layout: attn_every not divisible by data (the
    # group's layers whole over it), the rows split over data and, at rest,
    # over model
    "zamba_decode_layout": (_kw("zamba2_2_7b", d_model=128, attn_every=3,
                                n_layers=3), (2, 2), 64),
    # the production prefill's: 64 mamba heads, split over model at rest
    # as in the mixer
    "zamba_heads64": (_kw("zamba2_2_7b", d_model=2048, attn_every=2,
                          n_layers=2), (2, 2), 2),
}

REF_SCRIPT = r"""
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS
from repro.models.common import ModelConfig
from repro.models.transformer import Model
from repro.sharding import ctx, rules


def leaves(cache, prefix=""):
    fields = getattr(cache, "_fields", None)
    if fields is not None:
        return {prefix + f: np.asarray(getattr(cache, f)) for f in fields}
    out = {}
    for k, v in cache.items():
        out.update(leaves(v, prefix + k + "/"))
    return out


cases = pickle.load(open(sys.argv[1], "rb"))
out = {}
for name, (cfg_kw, shape, params, prompts, lengths, steps) in cases.items():
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
    rec = {"logits": [np.asarray(logits)], "tokens": [],
           "prefill_cache": leaves(cache)}
    for i in range(steps):
        nxt = np.asarray(logits).argmax(-1)
        rec["tokens"].append(nxt)
        pos = (jnp.int32(prompts.shape[1] + i) if lens is None
               else lens + i)
        logits, cache = dec(params, jnp.asarray(nxt[:, None], jnp.int32),
                            cache, pos)
        rec["logits"].append(np.asarray(logits))
    rec["cache"] = leaves(cache)
    out[name] = rec
    ctx.set_mesh(None)
pickle.dump(out, open(sys.argv[2], "wb"))
print("OK")
"""


def _np_params(kw, seed):
    return jax.tree_util.tree_map(np.asarray, JModel(
        JModelConfig(**kw)).init_params(jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's runs (subprocesses) and the port's (two spawns)."""
    tmp = str(tmp_path_factory.mktemp("recurrent_tp_serve"))
    rng = np.random.RandomState(11)
    cases, ref_in = {}, {}
    for i, (name, (shape, kw, s, b, lengths, _)) in enumerate(CASES.items()):
        prompts = rng.randint(0, kw["vocab"], (b, s))
        lens = None if lengths is None else np.asarray(lengths)
        params = _np_params(kw, seed=70 + i)
        cases[name] = (shape, kw, params, prompts, lens, STEPS)
        ref_in[name] = (kw, shape, params, prompts, lens, STEPS)
    env = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", "/usr/bin"),
           "HOME": os.environ.get("HOME", tmp), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "REPRO_AUTOTUNE_CACHE": os.path.join(tmp, "autotune.json")}
    procs = []
    for i in range(REF_PROCESSES):
        part = os.path.join(tmp, f"ref{i}")
        with open(part + "_in.pkl", "wb") as f:
            pickle.dump({k: v for j, (k, v) in enumerate(ref_in.items())
                         if j % REF_PROCESSES == i}, f)
        procs.append((part, subprocess.Popen(
            [sys.executable, "-c", REF_SCRIPT, part + "_in.pkl",
             part + "_out.pkl"], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(
                __file__))))))
    try:
        results = {}
        for world in (4, 2):
            results[world] = ranks.spawn(
                R.rank_work, world, timeout=300, args=(
                    {k: v for k, v in cases.items()
                     if math.prod(v[0]) == world},
                    {k: v for k, v in MOVES.items()
                     if math.prod(v[1]) == world}))
        ref = {}
        for part, proc in procs:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0 and "OK" in out, out + err
            with open(part + "_out.pkl", "rb") as f:
                ref.update(pickle.load(f))
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {"cases": cases, "results": results, "ref": ref}


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
    want = run["ref"][name]["logits"]
    m = CASES[name][0][1]
    assert len(want) == STEPS + 1
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
    want = run["ref"][name]["tokens"]
    assert len(want) == STEPS
    for step, w in enumerate(want):
        got, _ = _rows(run, name, "tokens", step)
        np.testing.assert_array_equal(got, w, err_msg=f"{name} {step}")


@pytest.mark.parametrize("when", ["prefill_cache", "cache"])
@pytest.mark.parametrize("name", list(CASES))
def test_state_and_kv_slices_are_the_references_shards(run, name, when):
    """After the prefill and after the last decode step each rank's state
    leaves (and the hybrid's KV) are its shards of the reference's cache
    under ``cache_specs``, in the layout the case names, and hold the dry
    run's ``cache_bytes`` of that mesh."""
    (d, m), kw, _, b, _, layout = CASES[name]
    cfg = ModelConfig(**kw)
    mesh = {"data": d, "model": m}
    whole = run["ref"][name][when]
    meta = Model(cfg).init_cache(b, cfg.max_seq, device="meta")
    specs = {k: v["spec"] for k, v in rules.state_slice(
        cfg, mesh, meta, {"data": 0, "model": 0}).items()}
    if cfg.family == "hybrid":
        kv = rules.cache_specs(cfg, mesh, meta)["kv"]
        specs.update({"kv/k": kv.k, "kv/v": kv.v})
    assert set(specs) == set(whole)
    for leaf, spec in layout.items():
        assert tuple(specs[leaf]) == spec, (leaf, specs[leaf])
    rec = dryrun.reckon(cfg, {"seq": cfg.max_seq, "batch": b,
                              "kind": "decode"}, mesh)
    for rank, res in enumerate(_ranks(run, (d, m))):
        got = res["serve"][name][when]
        coord = {"data": rank // m, "model": rank % m}
        assert sum(a.nbytes for a in got.values()) == \
            rec["memory"]["cache_bytes"]
        for leaf, spec in specs.items():
            w = whole[leaf]
            want = rules.local_shard(torch.from_numpy(w), mesh, spec,
                                     coord).numpy()
            np.testing.assert_allclose(
                got[leaf], want, rtol=0, atol=CACHE_TOL * np.abs(w).max(),
                err_msg=f"{name} {when} {leaf} rank {rank}")


def test_every_layout_of_the_table_is_covered():
    """The cases' specs include every spec the rules give these leaves at
    full width on the production mesh, up to which axis is wide: the
    token shifts over channels, ``wkv`` over its key index, the conv tail
    over the batch rows or whole, ``ssm`` over heads, batch rows or
    ``p``."""
    seen = {leaf: set() for leaf in ("tshift", "wkv", "mamba/conv",
                                     "mamba/ssm")}
    for kw, (d, m), b in MOVES.values():
        cfg = ModelConfig(**kw)
        meta = Model(cfg).init_cache(b, cfg.max_seq, device="meta")
        for leaf, s in rules.state_slice(cfg, {"data": d, "model": m}, meta,
                                         {"data": 0, "model": 0}).items():
            if leaf in seen:
                seen[leaf].add(tuple(s["spec"]).index("model")
                               if "model" in s["spec"] else None)
    assert seen == {"tshift": {2}, "wkv": {3}, "mamba/conv": {2, None},
                    "mamba/ssm": {2, 3, 4}}


@pytest.mark.parametrize("name", list(MOVES))
def test_state_moves_round_trip(run, name):
    """Each rank's rules piece of a random global leaf, moved into the
    mixer's piece, is the global leaf's rows of the rank's data index and
    (where the mixer splits) its heads or conv columns; moved back, it is
    ``rules.local_shard`` of the leaf again."""
    _, (d, m), _ = MOVES[name]
    for res in _ranks(run, (d, m)):
        for leaf, (mixer_ok, back_ok) in res["moves"][name].items():
            assert mixer_ok and back_ok, (name, leaf)


def test_a_decode_step_moves_the_state_by_all_to_all(run):
    """rwkv6 on (1, 2): a decode step's ``wkv`` moves by one all-to-all in
    and one back a layer, each sending the rank's whole piece (b nh 32 64
    fp32); the token shifts are gathered in (b d / 2 fp32 each) and cut
    out again with no collective."""
    (_, kw, _, b, _, _) = CASES["rwkv_m2"]
    cfg = ModelConfig(**kw)
    nh = cfg.d_model // 64
    for res in _ranks(run, (1, 2)):
        for c in res["serve"]["rwkv_m2"]["counts"][1:]:
            assert c["model"]["all_to_all"] == 2 * cfg.n_layers
            assert c["model"]["all_to_all_bytes"] == \
                2 * cfg.n_layers * b * nh * 32 * 64 * 4
            assert c["data"] == {}


def test_partition_specs_pickle_by_their_entries():
    """A rank sends its state slice (specs among it) to the parent: a spec
    comes back with its entries, not as one tuple entry."""
    for spec in (rules.PS(None, "data", "model"), rules.PS(("pod", "data"),
                                                           None), rules.PS()):
        back = pickle.loads(pickle.dumps(spec))
        assert back == spec and type(back) is rules.PartitionSpec


@pytest.mark.parametrize("arch,fields,ok", [
    ("rwkv6_1_6b", {"d_model": 256}, True),
    ("zamba2_2_7b", {"d_model": 128}, False)], ids=["rwkv6", "zamba2"])
def test_a_data_only_mesh_needs_no_state_move(arch, fields, ok):
    """On ``data=2`` with no model axis, rwkv6's state is split over the
    batch rows as its tokens are, and serves with no move; the hybrid's
    layers of a group are split over ``data`` (``attn_every`` read as the
    batch), which only a model axis's ``TensorParallel`` moves: the
    serving step refuses it rather than serve the wrong layers."""
    cfg = ModelConfig(**_kw(arch, **fields))
    model = Model(cfg)
    mesh = CountingMesh({"data": 2, "model": 1})
    if ok:
        ServingStep(model, mesh, 2, cfg.max_seq)
    else:
        with pytest.raises(NotImplementedError, match="data axes"):
            ServingStep(model, mesh, 2, cfg.max_seq)
