"""Training on a mesh's model axis in the port (tensor and sequence
parallelism, alone and with DP or FSDP on the data axis) on the CPU, held
against the reference's jitted step on the same mesh.

The reference's step runs in one subprocess on 4 forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``) on every case's
mesh; the port's runs on gloo ranks of ``repro_torch.testing.ranks.spawn``
(``tests/_tp_train_ranks.py``, which imports only ``repro_torch``): one
spawn of 4 ranks for ``model=4`` and ``data=2, model=2``, then one of 2
for ``model=2``.  The subprocess runs beside the spawns.  Both start from
the same numpy state, drawn from a seed in the reference's layout and
carried into the port by ``models.convert``.

The config is yi-9b's smoke config in fp32 (8 heads, 2 kv heads, d_model
64, 2 layers, remat) with qk_norm, global batch 8 x 16, unequal label
masks (rows and sequence positions); cases add ``qkv_bias``, a sequence
that ``model`` does not divide (SP off), 2 microbatches with bf16
accumulation, 8-bit moments, a wide variant (d_model 1024, with SP
and without) whose block norms and ``bq`` the rules split over
``model``, and 6 heads on ``model=4`` (with SP and without), where a
rank cannot hold whole heads and the attention runs whole on every
rank.

Tolerances: ``tests/test_torch_sharded_train.py``'s (loss and grad norm
``1e-5`` relative, each leaf ``LEAF_TOL`` of its largest magnitude;
microbatches ``MB_TOL`` and grad norm ``1e-3``; 8-bit moments within one
quantization step, params as there).  Params also get ``UPDATE_TOL`` (2 %)
of the leaf's largest update, as chip_smoke's 16b / 16c
(``SHARDED_UPDATE_TOL``): AdamW's update is O(lr) however small the
gradient, so where a gradient is near its sums' rounding the update's
error is a share of the update (on these seeded states the port's own
one-device step is 2.3e-5 of ``embed``'s largest magnitude away from the
reference's at ``sp_off``, 0.02 % of its update).  Where a gradient sits
at the fp32 rounding of its leaf's largest (the reference's first moment
under ``FLOOR`` of the leaf's largest), the update is the rounding's
sign: there the port's own one-device step parts from the reference by
6.5 % of the update at d_model 1024 (``embed``, a gradient 1e-6 of the
leaf's largest), so those elements are held only to twice the largest
update.  The moments, linear in the gradients, stay within ``LEAF_TOL``
everywhere.
"""
import dataclasses
import math
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _tp_train_ranks as R
from repro.configs import smoke_config as jsmoke
from repro.models.common import ModelConfig as JModelConfig
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro.models.transformer import Model as JModel
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.launch import dryrun
from repro_torch.models.common import ModelConfig
from repro_torch.models.convert import train_state_from_numpy
from repro_torch.models.transformer import Model
from repro_torch.sharding import collectives, rules
from repro_torch.testing import ranks
from repro_torch.train import step as tstep
from test_torch_sharded_train import (LEAF_TOL, LOSS_RTOL, MB_TOL,
                                      _assert_leaves_close, _ref_numpy)

BATCH, SEQ, STEPS = 8, 16, 2
UPDATE_TOL = 2e-2
FLOOR = 1e-5
BASE = {**dataclasses.asdict(jsmoke("yi_9b")), "qk_norm": True}

# name: (mesh (data, model), config fields, step kw, seq)
CASES = {
    "base_m2": ((1, 2), {}, {}, SEQ),
    "base_dp": ((2, 2), {}, {}, SEQ),
    "base_fsdp": ((2, 2), {"fsdp": True}, {}, SEQ),
    "bias_m4": ((1, 4), {"qkv_bias": True}, {}, SEQ),
    "sp_off": ((2, 2), {"fsdp": True}, {}, 15),
    "mb2": ((2, 2), {}, {"microbatches": 2}, SEQ),
    "8bit": ((2, 2), {"fsdp": True, "opt_8bit": True}, {}, SEQ),
    "wide_m2": ((1, 2), {"d_model": 1024, "qkv_bias": True}, {}, SEQ),
    "wide_sp_off": ((1, 2), {"d_model": 1024}, {}, 15),
    # 6 heads on model=4: 1.5 heads of columns a rank, the attention whole
    "heads6_m4": ((1, 4), {"n_heads": 6, "n_kv_heads": 2, "head_dim": 8},
                  {}, SEQ),
    "heads6_sp_off": ((1, 4), {"n_heads": 6, "n_kv_heads": 2,
                               "head_dim": 8}, {}, 15),
}

REF_SCRIPT = r"""
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.models.common import ModelConfig
from repro.models.transformer import Model
from repro.train import step as jstep
cases = pickle.load(open(sys.argv[1], "rb"))
out = {}
for name, (cfg_kw, shape, step_kw, batches, leaves) in cases.items():
    cfg = ModelConfig(**cfg_kw)
    model = Model(cfg)
    mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape),
                ("data", "model"))
    treedef = jax.tree_util.tree_structure(jstep.make_train_state(
        model, jax.random.PRNGKey(0), use_8bit=cfg.opt_8bit))
    state = jax.tree_util.tree_unflatten(treedef,
                                         [jnp.asarray(a) for a in leaves])
    _, jit_with, _ = jstep.make_train_step(model, mesh, donate=False,
                                           **step_kw)
    run = jit_with(jstep.state_specs(state, mesh, cfg))
    steps = []
    for b in batches:
        state, m = run(state, {k: jnp.asarray(v) for k, v in b.items()})
        steps.append(({k: float(v) for k, v in m.items()},
                      [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]))
    out[name] = steps
pickle.dump(out, open(sys.argv[2], "wb"))
print("OK")
"""


def _cfg_kw(name):
    return {**BASE, **CASES[name][1]}


def _batches(vocab, seq, n, seed):
    """``n`` global batches: tokens, next-token labels, and unequal masks
    (most of the first 3 rows, and the last positions of rows 4-5)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        tokens = rng.randint(0, vocab, (BATCH, seq))
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -100
        labels[:3, :seq * 3 // 4] = -100
        labels[4:6, seq // 2:] = -100
        out.append({"tokens": tokens, "labels": labels})
    return out


def _initial_state(jcfg, seed):
    """The reference's train state, as numpy in its structure, with params
    drawn by numpy from ``seed``: matrices N(0, 1 / fan_in) (the embedding
    0.02), norm weights 1 + 0.1 N, biases 0.1 N; zero moments (an 8-bit
    moment as the reference quantizes zeros)."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: jstep.make_train_state(
        JModel(jcfg), jax.random.PRNGKey(0), use_8bit=jcfg.opt_8bit))
    q0, scale0 = jadamw._quantize(jnp.zeros((1,), jnp.float32))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "embed" in name:
            a = 0.02 * rng.randn(*leaf.shape)
        elif leaf.ndim >= 3 or (leaf.ndim == 2 and "blocks" not in name):
            a = rng.randn(*leaf.shape) / math.sqrt(leaf.shape[-2])
        elif "norm" in name or "ln" in name:
            a = 1 + 0.1 * rng.randn(*leaf.shape)
        else:
            a = 0.1 * rng.randn(*leaf.shape)
        return np.asarray(jnp.asarray(a, jnp.float32).astype(leaf.dtype))

    def zero(leaf):
        if tuple(getattr(leaf, "_fields", ())) == ("q", "scale"):
            return type(leaf)(np.zeros(leaf.q.shape, np.asarray(q0).dtype),
                              np.full(leaf.scale.shape, np.asarray(scale0),
                                      leaf.scale.dtype))
        return np.zeros(leaf.shape, leaf.dtype)
    is_q = lambda x: tuple(getattr(x, "_fields", ())) == (  # noqa: E731
        "q", "scale")
    return {"params": jax.tree_util.tree_map_with_path(draw,
                                                       shapes["params"]),
            "opt": {k: (jax.tree_util.tree_map(zero, v, is_leaf=is_q)
                        if k != "step" else np.zeros((), np.int32))
                    for k, v in shapes["opt"].items()},
            "step": np.zeros((), np.int32)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's runs (subprocess) and the port's (two spawns), and
    the inputs both started from."""
    tmp = str(tmp_path_factory.mktemp("tp_train"))
    inputs, ref_in = {}, {}
    for i, (name, (shape, _, step_kw, seq)) in enumerate(CASES.items()):
        kw = _cfg_kw(name)
        jcfg = JModelConfig(**kw)
        state = _initial_state(jcfg, seed=i)
        n = 3 if name == "base_fsdp" else STEPS
        batches = _batches(jcfg.vocab, seq, n, seed=100 + i)
        step_kw = {**R.STEP, **step_kw}
        ref_in[name] = (kw, shape, step_kw, batches[:STEPS],
                        [np.asarray(a) for a in
                         jax.tree_util.tree_leaves(state)])
        inputs[name] = (shape, kw, CASES[name][2], _ref_numpy(state),
                        batches, jax.tree_util.tree_structure(state))
    with open(os.path.join(tmp, "ref_in.pkl"), "wb") as f:
        pickle.dump(ref_in, f)
    env = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", "/usr/bin"),
           "HOME": os.environ.get("HOME", tmp), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "REPRO_AUTOTUNE_CACHE": os.path.join(tmp, "autotune.json")}
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, os.path.join(tmp, "ref_in.pkl"),
         os.path.join(tmp, "ref_out.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        def port_cases(world):
            return {k: v[:5] for k, v in inputs.items()
                    if math.prod(v[0]) == world}
        four = ranks.spawn(R.rank_work_four, 4, args=(port_cases(4), tmp),
                           timeout=300)
        base = inputs["base_fsdp"]
        ckpt_case = (base[1], base[3], base[4][2])
        two = ranks.spawn(R.rank_work_two, 2,
                          args=(port_cases(2), tmp, ckpt_case), timeout=300)
        out, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0 and "OK" in out, out + err
    with open(os.path.join(tmp, "ref_out.pkl"), "rb") as f:
        ref_out = pickle.load(f)
    refs = {name: [(m, _ref_numpy(jax.tree_util.tree_unflatten(
        inputs[name][5], leaves))) for m, leaves in steps]
        for name, steps in ref_out.items()}
    return {"inputs": inputs, "ref": refs, "four": four, "two": two,
            "tmp": tmp}


def _port_np(name, np_state):
    cfg = ModelConfig(**_cfg_kw(name))
    return R.numpy_state(train_state_from_numpy(cfg, np_state,
                                                device="cpu"))


def _results(run, name):
    world = math.prod(CASES[name][0])
    return [res["runs"][name] for res in run["four" if world == 4
                                              else "two"]]


def _check(run, name, got_steps, *, tol=LEAF_TOL, gn_rtol=LOSS_RTOL,
           eight_bit=False):
    prev = _port_np(name, run["inputs"][name][3])
    for (m, got), (jm, jst) in zip(got_steps, run["ref"][name]):
        assert m["applied"] == int(jm["applied"]) == 1
        assert m["lr"] == jm["lr"]
        np.testing.assert_allclose(m["loss"], jm["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"],
                                   rtol=gn_rtol)
        want = _port_np(name, jst)
        if eight_bit:
            _assert_leaves_close(got, want, tol, eight_bit, prev)
        else:
            _assert_close(got, want, prev, tol)
        prev = want


def _assert_close(got, want, prev, tol):
    """Each leaf within ``tol`` of its largest magnitude; params also
    within ``UPDATE_TOL`` of their largest update from ``prev``, and
    elements at the gradient's rounding floor within twice that update
    (module docstring)."""
    prev, want_d = dict(prev), dict(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        err = np.abs(a - b)
        bound = tol * max(float(np.abs(b).max()), 1e-30)
        if path[0] == "params":
            update = float(np.abs(b - prev[path]).max())
            m = np.abs(want_d[("opt", "m") + path[1:]])
            floor = m < FLOOR * m.max()
            assert float(err[floor].max(initial=0.0)) <= 2 * update, path
            err = err[~floor]
            bound += UPDATE_TOL * update
        err = float(err.max(initial=0.0))
        assert err <= bound, f"{path}: {err} > {bound}"


@pytest.mark.parametrize("name", ["base_m2", "base_dp", "base_fsdp",
                                  "bias_m4", "sp_off", "heads6_m4",
                                  "heads6_sp_off"])
def test_every_rank_matches_the_reference_step(run, name):
    """Two steps: loss, grad norm, lr, every param and moment (gathered
    whole) on each rank, against the reference's jitted step on the same
    mesh."""
    for res in _results(run, name):
        _check(run, name, res["steps"])


def test_microbatches_in_bf16_match_the_reference(run):
    for res in _results(run, "mb2"):
        _check(run, "mb2", res["steps"], tol=MB_TOL, gn_rtol=1e-3)


def test_8bit_moments_one_scale_over_every_rank(run):
    """Each moment's scale is the amax over every layer and every rank's
    shard: the reference's one scale, the same on every rank."""
    for res in _results(run, "8bit"):
        _check(run, "8bit", res["steps"], eight_bit=True)
    scales = {}
    for res in _results(run, "8bit"):
        for path, a in res["steps"][-1][1]:
            if path[-1] == "scale":
                scales.setdefault(path, set()).add(float(a))
    assert scales and all(len(v) == 1 for v in scales.values())
    counts = _results(run, "8bit")[0]["counts"][0]
    assert counts["world"]["all_reduce"] == 2   # loss + squares, amax


@pytest.mark.parametrize("name", ["wide_m2", "wide_sp_off"])
def test_wide_norms_and_bias_split_over_model(run, name):
    """d_model 1024: the rules split ln1 / ln2 / ln_f and ``bq`` over
    ``model``; their gathers and reduce-scatters hold the reference, with
    SP and (seq 15) without, where every rank normalises the whole
    sequence and keeps its piece of the norms' gradients."""
    cfg = ModelConfig(**_cfg_kw("wide_m2"))
    specs = rules.params_specs(Model(cfg).init_params(torch.Generator(),
                                                      "meta"),
                               {"data": 1, "model": 2}, cfg)
    assert specs["ln_f"] == ("model",)
    assert specs["blocks"][0]["ln1"] == ("model",)
    assert specs["blocks"][0]["attn"]["bq"] == ("model",)
    assert specs["blocks"][0]["attn"]["bk"] == (None,)
    for res in _results(run, name):
        _check(run, name, res["steps"])


@pytest.mark.parametrize("name", list(CASES))
def test_state_bytes_a_rank_equal_the_dry_run(run, name):
    shape, _, _, seq = CASES[name]
    cfg = ModelConfig(**_cfg_kw(name))
    want = dryrun.reckon(cfg, {"seq": seq, "batch": BATCH, "kind": "train"},
                         {"data": shape[0], "model": shape[1]})
    for res in _results(run, name):
        assert res["bytes"] == want["memory"]["state_bytes"]


def test_collectives_a_step_on_the_model_axis(run):
    """``model=2``, SP on, remat: each block gathers the sequence before
    attention and the MLP (in the forward and again in remat's recompute)
    and reduce-scatters their partial sums (the recompute stops before
    the MLP's, whose output no backward reads); the backward mirrors each;
    the embedding's lookup and the head's gather add one of each; the
    replicated norms' gradients are all-reduced; one world all-reduce for
    the loss and the norm."""
    n_layers = BASE["n_layers"]
    for res in _results(run, "base_m2"):
        for c in res["counts"]:
            assert c["data"] == {}
            assert c["world"]["all_reduce"] == 1
            assert c["model"]["all_gather"] == 6 * n_layers + 2
            assert c["model"]["reduce_scatter"] == 5 * n_layers + 2
            # ln1, q_norm, k_norm, ln2 a layer, and ln_f
            assert c["model"]["all_reduce"] == 4 * n_layers + 1


def test_sp_off_all_reduces_in_place_of_reduce_scatter(run):
    """seq 15 on ``model=2``: the reference's constraint leaves the
    sequence whole, so every rank holds it and the blocks' entries and
    exits are all-reduces (backward and forward); only the head is still
    gathered and its gradient reduce-scattered."""
    n_layers = BASE["n_layers"]
    for res in _results(run, "sp_off"):
        for c in res["counts"]:
            c = c["model"]
            assert c["reduce_scatter"] == c["all_gather"] == 1
            # forward: the embedding, two exits a layer, one again in the
            # recompute; backward: two entries, q_norm and k_norm a layer,
            # the loss's rows and ln_f
            assert c["all_reduce"] == 3 * n_layers + 1 + 4 * n_layers + 2


def test_a_nan_on_one_ranks_rows_writes_nothing_anywhere(run):
    for res in run["four"]:
        m, kept = res["nan"]
        assert m["applied"] == 0 and kept
        assert not math.isfinite(m["loss"])


def test_a_model_axis_that_does_not_divide_the_heads_raises(run):
    """It no longer raises: where ``model`` cannot give each rank whole
    heads the step runs the attention whole on every rank (its weights
    gathered over ``model``; the ``heads6_*`` cases above hold it to the
    reference), the MLP, embedding and head still split."""
    for res in run["four"]:
        m = res["heads"]
        assert m["applied"] == 1 and math.isfinite(m["loss"])
    cfg = ModelConfig(**BASE)
    for m in (3, 16):
        assert collectives.check_model_axis(cfg, {"data": 1, "model": m}) \
            is False
    assert collectives.check_model_axis(cfg, {"data": 2, "model": 8})
    assert collectives.check_model_axis(
        dataclasses.replace(cfg, n_heads=24, n_kv_heads=8),
        {"model": 6}) is False


def test_constraint_at_the_sp_boundary(run):
    for res in run["four"]:
        c = res["constraint"]
        assert c["shard"] is True
        assert c["outside"].startswith("NotImplementedError")
        assert c["whole"].startswith("ValueError") and \
            "sequence shard (8 of 16)" in c["whole"]
        assert c["hidden"].startswith("NotImplementedError")


def test_checkpoint_from_data_and_model_restores_bitwise(run):
    """Saved on ``data=2, model=2`` (FSDP + TP) after two steps: restored
    bitwise in one process and on ``model=2``, and one more step from each
    agrees with the step the saving ranks took."""
    saved = run["four"][0]["runs"]["base_fsdp"]["steps"][-1][1]
    shape, cfg_kw, _, state0, batches, _ = run["inputs"]["base_fsdp"]
    cfg = ModelConfig(**cfg_kw)
    template = train_state_from_numpy(cfg, state0, device="cpu")
    step_no, one, extra = CheckpointManager(
        os.path.join(run["tmp"], "tp_ckpt")).restore_latest(template)
    assert step_no == 2 and extra == {"data_state": {"step": 2}}
    got = R.numpy_state(one)
    assert [p for p, _ in got] == [p for p, _ in saved]
    for (p, a), (_, b) in zip(got, saved):
        assert a.dtype == b.dtype and np.array_equal(a, b), p
    for res in run["two"]:
        step_no, extra, restored = res["restored"]
        assert step_no == 2
        for (p, a), (_, b) in zip(restored, saved):
            assert np.array_equal(a, b), p
    one, m_one = tstep.make_train_step(Model(cfg), **R.STEP)(one,
                                                             batches[2])
    m_mesh, want = run["four"][0]["after_save"]
    for m, st in [(m_one, R.numpy_state(one))] + [
            res["after_restore"] for res in run["two"]]:
        assert m["applied"] == m_mesh["applied"] == 1
        np.testing.assert_allclose(m["loss"], m_mesh["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(m["grad_norm"], m_mesh["grad_norm"],
                                   rtol=LOSS_RTOL)
        _assert_close(st, want, saved, LEAF_TOL)
