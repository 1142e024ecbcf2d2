"""The MoE FFN on a mesh in the port, on the CPU, held against the
reference on the same mesh:

  * the train step of the MoE smoke configs (dbrx-132b's: 4 experts top-2;
    grok-1-314b's) on gloo ranks, against the reference's jitted step on
    the same forced-device mesh: ``(data, model)`` = (1, 2), (2, 2), (1, 4)
    (one expert a rank: ``moe_ep``'s ``e_local == 1`` branch) and (4, 1)
    (the all-to-all over a model group of one), FSDP with 8-bit moments on
    (2, 2); two steps each at the config's own capacity factor, so that
    the reference's drops on that mesh are the port's.  Each mesh has its
    own capacities, hence its own loss: the port is never held to another
    mesh's step;
  * ``ffn.moe`` on the ranks of a data axis, against the reference's
    ``ffn.moe`` with two GShard groups (``g = 2``) under a forced-device
    mesh: outputs, aux and every gradient;
  * ``ShardedEngine`` on ``data=2``, token-identical to the port's
    ``ContinuousEngine`` for the MoE and audio smoke configs;
  * the audio smoke config's step on (2, 2): its codebook embedding
    vocab-parallel inside the tensor-parallel step.

The reference's loss reports ONE data shard's aux: its ``shard_map``
returns the aux with ``out_specs=PS()`` and ``check_rep=False``, so the
value is the first shard's, while the gradient that reaches the router is
that of the mean over the data shards' auxes.  The port matches both
(``train.step._objective``); ``test_reported_aux_is_the_first_data_shards``
pins the reference's side of it (ROADMAP.md queue 3).

The reference runs in one subprocess on 4 forced host devices; the port's
ranks run in two spawns (4 ranks, then 2) beside it.  Tolerances are
``tests/test_torch_tp_train.py``'s.
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

import _moe_ep_ranks as R
from repro.configs import smoke_config as jsmoke
from repro.models.common import ModelConfig as JModelConfig
from repro.models.transformer import Model as JModel
from repro_torch.launch import dryrun
from repro_torch.models.common import ModelConfig
from repro_torch.models.convert import (params_from_numpy,
                                        train_state_from_numpy)
from repro_torch.models.transformer import Model
from repro_torch.serve.engine import ContinuousEngine, Request
from repro_torch.testing import ranks
from test_torch_sharded_train import (LEAF_TOL, LOSS_RTOL,
                                      _assert_leaves_close, _ref_numpy)
from test_torch_tp_train import (REF_SCRIPT, _assert_close, _batches,
                                 _initial_state)
from _sharded_train_ranks import numpy_state
from _tp_train_ranks import STEP

SEQ = 16
DBRX = dataclasses.asdict(jsmoke("dbrx_132b"))
GROK = dataclasses.asdict(jsmoke("grok_1_314b"))
MUSICGEN = dataclasses.asdict(jsmoke("musicgen_large"))

# name: (mesh (data, model), config fields)
CASES = {
    "dbrx_m2": ((1, 2), DBRX),
    "dbrx_dp": ((2, 2), DBRX),
    "dbrx_m4": ((1, 4), DBRX),
    "dbrx_d4": ((4, 1), DBRX),
    "dbrx_fsdp_8bit": ((2, 2), {**DBRX, "fsdp": True, "opt_8bit": True}),
    "grok_dp": ((2, 2), GROK),
    # the audio family's K codebook lookups, vocab-parallel, summed
    # before SP's reduce-scatter
    "musicgen_dp": ((2, 2), MUSICGEN),
}
MOE_CASES = [name for name, (_, kw) in CASES.items() if kw["n_experts"]]

# ffn.moe with two GShard groups: dbrx's smoke layer, 2 x 48 tokens (a
# group of 48: capacity max(int(1.25 * 48 * 2 / 4), 48) = 48, no floor)
MOE_SCRIPT = r"""
moe_in = pickle.load(open(sys.argv[3], "rb"))
from repro.models import ffn
from repro.sharding import ctx
cfg = ModelConfig(**moe_in["cfg"])
p = ffn.MoeParams(**{k: jnp.asarray(v) for k, v in moe_in["p"].items()})
mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
ctx.set_mesh(mesh)
x, cot = jnp.asarray(moe_in["x"]), jnp.asarray(moe_in["cot"])
def obj(p, x):
    out, aux = ffn.moe(p, cfg, x)
    return (out * cot).sum() + aux, (out, aux)
grads, (o, a) = jax.jit(jax.grad(obj, has_aux=True))(p, x)
pickle.dump({"out": np.asarray(o), "aux": float(a),
             "grads": {k: np.asarray(v) for k, v in grads._asdict().items()}},
            open(sys.argv[4], "wb"))
ctx.set_mesh(None)
"""

ENGINE = dict(max_seq=48, slots=4, chunk=4, min_bucket=8, prefill_chunk=8)
LENGTHS, MAX_NEW = (7, 12, 3, 9, 5), (5, 3, 6, 4, 7)


def _prompts(cfg):
    rng = np.random.RandomState(5)
    extra = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    return [rng.randint(0, cfg.vocab, (n,) + extra) for n in LENGTHS]


def _np_params(arch):
    jcfg = jsmoke(arch)
    return jax.tree_util.tree_map(
        np.asarray, JModel(jcfg).init_params(jax.random.PRNGKey(1)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("moe_ep"))
    inputs, ref_in = {}, {}
    for i, (name, (shape, kw)) in enumerate(CASES.items()):
        jcfg = JModelConfig(**kw)
        state = _initial_state(jcfg, seed=20 + i)
        batches = _batches(jcfg.vocab, SEQ, 2, seed=200 + i)
        if jcfg.n_codebooks:
            # K codebooks a position; the labels stay codebook 0's, as the
            # reference's data pipeline gives them
            rng = np.random.RandomState(300 + i)
            for b in batches:
                b["tokens"] = np.concatenate(
                    [b["tokens"][..., None], rng.randint(
                        0, jcfg.vocab, b["tokens"].shape
                        + (jcfg.n_codebooks - 1,))], axis=-1)
        ref_in[name] = (kw, shape, dict(STEP), batches,
                        [np.asarray(a) for a in
                         jax.tree_util.tree_leaves(state)])
        inputs[name] = (shape, kw, {}, _ref_numpy(state), batches,
                        jax.tree_util.tree_structure(state))
    rng = np.random.RandomState(3)
    lay = _initial_state(JModelConfig(**DBRX), seed=9)["params"]["blocks"]
    moe_p = {k: np.asarray(v[0]) for k, v in lay.mlp._asdict().items()}
    moe_in = {"cfg": DBRX, "p": moe_p,
              "x": rng.randn(2, 48, DBRX["d_model"]).astype(np.float32),
              "cot": rng.randn(2, 48, DBRX["d_model"]).astype(np.float32)}
    for path, obj in (("ref_in.pkl", ref_in), ("moe_in.pkl", moe_in)):
        with open(os.path.join(tmp, path), "wb") as f:
            pickle.dump(obj, f)
    env = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", "/usr/bin"),
           "HOME": os.environ.get("HOME", tmp), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "REPRO_AUTOTUNE_CACHE": os.path.join(tmp, "autotune.json")}
    script = REF_SCRIPT.replace('print("OK")', MOE_SCRIPT + 'print("OK")')
    ref = subprocess.Popen(
        [sys.executable, "-c", script] + [os.path.join(tmp, p) for p in (
            "ref_in.pkl", "ref_out.pkl", "moe_in.pkl", "moe_out.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    engines = {}
    for arch in ("dbrx_132b", "musicgen_large"):
        cfg = jsmoke(arch)
        engines[arch] = (dataclasses.asdict(cfg), _np_params(arch),
                         _prompts(cfg), MAX_NEW, ENGINE)
    try:
        def port_cases(world):
            return {k: v[:5] for k, v in inputs.items()
                    if math.prod(v[0]) == world}
        four = ranks.spawn(R.rank_work, 4, args=(port_cases(4), None, {}),
                           timeout=300)
        moe_case = (DBRX, moe_p, moe_in["x"], moe_in["cot"])
        two = ranks.spawn(R.rank_work, 2,
                          args=(port_cases(2), moe_case, engines),
                          timeout=300)
        out, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0 and "OK" in out, out + err
    with open(os.path.join(tmp, "ref_out.pkl"), "rb") as f:
        ref_out = pickle.load(f)
    with open(os.path.join(tmp, "moe_out.pkl"), "rb") as f:
        moe_out = pickle.load(f)
    refs = {name: [(m, _ref_numpy(jax.tree_util.tree_unflatten(
        inputs[name][5], leaves))) for m, leaves in steps]
        for name, steps in ref_out.items()}
    return {"inputs": inputs, "ref": refs, "four": four, "two": two,
            "moe": moe_out, "moe_in": moe_in, "engines": engines}


def _results(run, name):
    world = math.prod(CASES[name][0])
    return [res["runs"][name] for res in run["four" if world == 4
                                              else "two"]]


def _port_np(name, np_state):
    cfg = ModelConfig(**CASES[name][1])
    return numpy_state(train_state_from_numpy(cfg, np_state, device="cpu"))


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_matches_the_reference_step(run, name):
    """Two steps: loss (its aux the first data shard's), grad norm, lr,
    every param and moment (gathered whole) on each rank."""
    eight_bit = CASES[name][1]["opt_8bit"]
    for res in _results(run, name):
        prev = _port_np(name, run["inputs"][name][3])
        for (m, got), (jm, jst) in zip(res["steps"], run["ref"][name]):
            assert m["applied"] == int(jm["applied"]) == 1
            assert m["lr"] == jm["lr"]
            np.testing.assert_allclose(m["loss"], jm["loss"],
                                       rtol=LOSS_RTOL)
            np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"],
                                       rtol=LOSS_RTOL)
            want = _port_np(name, jst)
            if eight_bit:
                _assert_leaves_close(got, want, LEAF_TOL, True, prev)
            else:
                _assert_close(got, want, prev, LEAF_TOL)
            prev = want


@pytest.mark.parametrize("name", MOE_CASES)
def test_the_all_to_all_a_step(run, name):
    """Per layer and step the model group exchanges the payload, its
    metadata and the outputs (3 calls) in the forward, again in remat's
    recompute, and the two float ones back in the backward: 8 calls, of
    (M, cap, d) fp32 payloads and (M, cap) int32 metadata, cap =
    ``max(ceil(1.25 * tl * k / M), 4)`` for a rank's ``tl`` tokens.  A
    model group of one exchanges nothing."""
    (d, m), kw = CASES[name]
    layers = kw["n_layers"]
    tl = (8 // d) * (SEQ // m)
    cap = max(math.ceil(1.25 * tl * kw["top_k"] / m), 4)
    for res in _results(run, name):
        for c in res["counts"]:
            model = c["model"]
            if m == 1:
                assert "all_to_all" not in model
                continue
            assert model["all_to_all"] == 8 * layers
            payload = m * cap * kw["d_model"] * 4
            assert model["all_to_all_bytes"] == layers * (
                6 * payload + 2 * m * cap * 4)
            assert "all_to_all" not in c["data"]


def test_reported_aux_is_the_first_data_shards(run):
    """On (2, 2) and (4, 1) the data shards' auxes differ by far more than
    the loss's tolerance, and the reference's loss, which the port's
    matches above, is the cross entropy plus ``0.01 *`` the FIRST data
    shard's aux: the port's reported loss less its first shard's aux term
    is its cross entropy, and with the mean's in its place the loss would
    miss the reference's."""
    for name in ("dbrx_dp", "dbrx_d4"):
        (d, m), _ = CASES[name]
        res = _results(run, name)
        for step in range(2):
            # the rank at (data i, model 0) is rank i * m
            shard = [res[i * m]["auxes"][step] for i in range(d)]
            for i in range(d):     # a data shard's model ranks agree
                assert len({r["auxes"][step]
                            for r in res[i * m:(i + 1) * m]}) == 1
            jloss = run["ref"][name][step][0]["loss"]
            gap = 0.01 * abs(shard[0] - np.mean(shard))
            assert gap > 4 * LOSS_RTOL * abs(jloss), (name, shard)
            np.testing.assert_allclose(res[0]["steps"][step][0]["loss"],
                                       jloss, rtol=LOSS_RTOL)


def test_moe_with_groups_on_data_ranks_matches_the_reference(run):
    """``ffn.moe`` on two data ranks (each rank's rows one GShard group,
    the statistics averaged over the data group) against the reference's
    ``ffn.moe`` with ``g = 2`` under a two-device mesh: outputs, aux and
    every gradient (the ranks' summed)."""
    want = run["moe"]
    outs = np.concatenate([res["moe"][0] for res in run["two"]])
    np.testing.assert_allclose(outs, want["out"], rtol=1e-5, atol=1e-5)
    for res in run["two"]:
        np.testing.assert_allclose(res["moe"][1], want["aux"], rtol=1e-6)
    for k, g in want["grads"].items():
        got = sum(res["moe"][2][k] for res in run["two"])
        np.testing.assert_allclose(got, g, rtol=1e-4,
                                   atol=1e-5 * np.abs(g).max())


@pytest.mark.parametrize("arch", ["dbrx_132b", "musicgen_large"])
def test_sharded_engine_token_identical_to_continuous(run, arch):
    """``ShardedEngine`` on ``data=2`` gives every request the tokens of
    the port's one-process ``ContinuousEngine`` (greedy, fp32)."""
    cfg_kw, np_params, prompts, max_new, kw = run["engines"][arch]
    cfg = ModelConfig(**cfg_kw)
    eng = ContinuousEngine(Model(cfg),
                           params_from_numpy(cfg, np_params, device="cpu"),
                           **kw)
    want = eng.run([Request(p.tolist(), max_new_tokens=n)
                    for p, n in zip(prompts, max_new)])
    for res in run["two"]:
        assert res["engines"][arch] == want


@pytest.mark.parametrize("name", list(CASES))
def test_state_bytes_a_rank_equal_the_dry_run(run, name):
    """Each rank holds the bytes ``launch.dryrun.reckon`` gives a rank of
    the case's mesh (the experts split over ``model``)."""
    (d, m), kw = CASES[name]
    cfg = ModelConfig(**kw)
    rec = dryrun.reckon(cfg, {"seq": SEQ, "batch": 8, "kind": "train"},
                        {"data": d, "model": m})
    for res in _results(run, name):
        assert res["bytes"] == rec["memory"]["state_bytes"]
