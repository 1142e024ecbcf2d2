"""The recurrent families on a mesh's model axis in the port (tensor and
sequence parallelism for rwkv6 and zamba2, alone and with DP or FSDP on
the data axis) on the CPU, held against the reference's jitted step on
the same mesh.

As ``tests/test_torch_tp_train.py``: the reference's step runs in one
subprocess on 4 forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``) on every case's
mesh, beside the port's gloo ranks (``tests/_recurrent_tp_ranks.py``,
which imports only ``repro_torch``): one spawn of 4 ranks (``model=4``,
``data=2, model=2``), then one of 2 (``model=2``).  Both start from the
reference's initial state (``make_train_state`` from a seed), carried
into the port as numpy by ``models.convert``.

The smoke configs in fp32 at widths whose heads split: rwkv6 at d_model
256 (4 heads of 64) and 1024 (16 heads; the rules then also split its
vectors over ``model``), zamba2 at d_model 128 (4 mamba heads of 64, 4
attention heads of 32); global batch 8 x 16 with unequal label masks.
Cases add FSDP on ``data=2, model=2``, DP there with a sequence of 15
(SP off), and a ``model`` that does not divide the mixer's heads
(rwkv6 at d_model 192, zamba2 at 96: 3 heads on ``model=2``), where the
mixer runs whole on every rank.  The reference's runs are cut into
``REF_PROCESSES`` subprocesses that run at once (its jitted steps take
7-22 s each to trace and compile).

The initial states are ``test_torch_tp_train._initial_state``'s (numpy
draws from a seed in the reference's structure).  From the reference's
own initial state (``a_log``, ``dt_bias`` and ``u`` all zero) mamba2's
``a_log`` and ``dt_bias`` gradients sum terms that nearly cancel: there
the port's one-device step already lies 1.5e-5 and 1.9e-5 of the leaf's
largest second moment from the reference's ``model=4`` step (zamba2 at
d_model 128), and its ``model=4`` step 2.7e-5, beyond ``LEAF_TOL``.

Tolerances: ``tests/test_torch_tp_train.py``'s (loss and grad norm
``1e-5`` relative, each leaf ``LEAF_TOL`` of its largest magnitude,
params also ``UPDATE_TOL`` of the leaf's largest update, elements at the
gradient's rounding floor twice the update), or, for a leaf where the
port's one-device step is itself farther from the reference than that,
twice the one-device step's distance (``ROUNDING``).  mamba2's per-head
scalars (``a_log``, ``dt_bias``, ``d_skip``) get gradients that are sums
of 10^3-10^4 nearly cancelling terms: the port's one-device step (no
model axis, no collective) lies up to 2.6e-5 of the leaf's largest first
moment from the reference's ``model=2`` step on these states (zamba2 at
d_model 128, ``dt_bias``, second step), and the ``model=2`` step's own
distance to it is of the same size, while a wrong sum over ``model``
would be off by a factor of 2 or 4.
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

import _recurrent_tp_ranks as R
import _tp_train_ranks as TR
from repro.configs import smoke_config as jsmoke
from repro.models.common import ModelConfig as JModelConfig
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.launch import dryrun
from repro_torch.models.common import ModelConfig
from repro_torch.models.convert import train_state_from_numpy
from repro_torch.models.transformer import Model
from repro_torch.sharding import collectives, rules
from repro_torch.testing import ranks
from repro_torch.train import step as tstep
from test_torch_sharded_train import LEAF_TOL, LOSS_RTOL, _ref_numpy
from test_torch_tp_train import (FLOOR, REF_SCRIPT, UPDATE_TOL,
                                 _assert_close, _batches, _initial_state)

STEPS = 2
SEQ = 16
REF_PROCESSES = 3
# a leaf's allowance past the file's tolerance: this many times the port's
# one-device step's distance to the reference (module docstring)
ROUNDING = 2.0

# name: (arch, mesh (data, model), config fields, seq)
CASES = {
    "rwkv_m2": ("rwkv6_1_6b", (1, 2), {"d_model": 256}, SEQ),
    "rwkv_m4": ("rwkv6_1_6b", (1, 4), {"d_model": 256}, SEQ),
    "rwkv_fsdp": ("rwkv6_1_6b", (2, 2), {"d_model": 256, "fsdp": True}, SEQ),
    "rwkv_wide": ("rwkv6_1_6b", (1, 2), {"d_model": 1024}, SEQ),
    "rwkv_heads3": ("rwkv6_1_6b", (1, 2), {"d_model": 192}, SEQ),
    "zamba_m2": ("zamba2_2_7b", (1, 2), {"d_model": 128}, SEQ),
    "zamba_m4": ("zamba2_2_7b", (1, 4), {"d_model": 128}, SEQ),
    "zamba_fsdp": ("zamba2_2_7b", (2, 2), {"d_model": 128, "fsdp": True},
                   SEQ),
    "zamba_sp_off": ("zamba2_2_7b", (2, 2), {"d_model": 128}, 15),
    "zamba_heads3": ("zamba2_2_7b", (1, 2), {"d_model": 96}, SEQ),
}
CKPT = "zamba_fsdp"


def _cfg_kw(name):
    arch, _, kw, _ = CASES[name]
    return dataclasses.asdict(dataclasses.replace(jsmoke(arch), **kw))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's runs (subprocess) and the port's (two spawns), and
    the inputs both started from."""
    tmp = str(tmp_path_factory.mktemp("recurrent_tp"))
    inputs, ref_in = {}, {}
    for i, (name, (_, shape, _, seq)) in enumerate(CASES.items()):
        kw = _cfg_kw(name)
        jcfg = JModelConfig(**kw)
        state = _initial_state(jcfg, seed=i)
        n = 3 if name == CKPT else STEPS
        batches = _batches(jcfg.vocab, seq, n, seed=200 + i)
        ref_in[name] = (kw, shape, TR.STEP, batches[:STEPS],
                        [np.asarray(a) for a in
                         jax.tree_util.tree_leaves(state)])
        inputs[name] = (shape, kw, _ref_numpy(state), batches,
                        jax.tree_util.tree_structure(state))
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
        def port_cases(world):
            return {k: v[:4] for k, v in inputs.items()
                    if math.prod(v[0]) == world}
        four = ranks.spawn(R.rank_work_four, 4,
                           args=(port_cases(4), tmp, CKPT), timeout=300)
        ck = inputs[CKPT]
        two = ranks.spawn(R.rank_work_two, 2,
                          args=(port_cases(2), tmp, (ck[1], ck[2], ck[3][2])),
                          timeout=300)
        ref_out = {}
        for part, ref in procs:
            out, err = ref.communicate(timeout=300)
            assert ref.returncode == 0 and "OK" in out, out + err
            with open(part + "_out.pkl", "rb") as f:
                ref_out.update(pickle.load(f))
    finally:
        for _, ref in procs:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    refs = {name: [(m, _ref_numpy(jax.tree_util.tree_unflatten(
        inputs[name][4], leaves))) for m, leaves in steps]
        for name, steps in ref_out.items()}
    one = {name: _one_device(name, inp[2], inp[3][:STEPS])
           for name, inp in inputs.items()}
    return {"inputs": inputs, "ref": refs, "four": four, "two": two,
            "one": one, "tmp": tmp}


def _one_device(name, np_state, batches):
    """The port's one-device step from the same state: per step its state
    as ``(path, array)``."""
    cfg = ModelConfig(**_cfg_kw(name))
    state = train_state_from_numpy(cfg, np_state, device="cpu")
    step = tstep.make_train_step(Model(cfg), **TR.STEP)
    out = []
    for b in batches:
        state, _ = step(state, b)
        out.append(TR.numpy_state(state))
    return out


def _port_np(name, np_state):
    cfg = ModelConfig(**_cfg_kw(name))
    return TR.numpy_state(train_state_from_numpy(cfg, np_state,
                                                 device="cpu"))


def _results(run, name):
    world = math.prod(CASES[name][1])
    return [res["runs"][name] for res in run["four" if world == 4
                                              else "two"]]


def _assert_near(got, want, prev, one):
    """``test_torch_tp_train._assert_close``'s bounds per leaf, each raised
    to ``ROUNDING`` times the one-device state ``one``'s largest distance
    from ``want`` on that leaf where that is larger."""
    prev, want_d, one = dict(prev), dict(want), dict(one)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        err = np.abs(a - b)
        rounding = ROUNDING * float(np.abs(one[path] - b).max(initial=0.0))
        bound = LEAF_TOL * max(float(np.abs(b).max()), 1e-30)
        if path[0] == "params":
            update = float(np.abs(b - prev[path]).max())
            m = np.abs(want_d[("opt", "m") + path[1:]])
            floor = m < FLOOR * m.max()
            assert float(err[floor].max(initial=0.0)) <= max(
                2 * update, rounding), path
            err = err[~floor]
            bound += UPDATE_TOL * update
        err = float(err.max(initial=0.0))
        assert err <= max(bound, rounding), f"{path}: {err} > {bound}"


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_matches_the_reference_step(run, name):
    """Two steps: loss, grad norm, lr, every param and moment (gathered
    whole over both axes) on each rank, against the reference's jitted
    step on the same mesh."""
    for res in _results(run, name):
        prev = _port_np(name, run["inputs"][name][2])
        for (m, got), (jm, jst), one in zip(res["steps"], run["ref"][name],
                                           run["one"][name]):
            assert m["applied"] == int(jm["applied"]) == 1
            assert m["lr"] == jm["lr"]
            np.testing.assert_allclose(m["loss"], jm["loss"], rtol=LOSS_RTOL)
            np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"],
                                       rtol=LOSS_RTOL)
            want = _port_np(name, jst)
            _assert_near(got, want, prev, one)
            prev = want


@pytest.mark.parametrize("name", list(CASES))
def test_state_bytes_a_rank_equal_the_dry_run(run, name):
    _, shape, _, seq = CASES[name]
    cfg = ModelConfig(**_cfg_kw(name))
    want = dryrun.reckon(cfg, {"seq": seq, "batch": 8, "kind": "train"},
                         {"data": shape[0], "model": shape[1]})
    for res in _results(run, name):
        assert res["bytes"] == want["memory"]["state_bytes"]


def test_collectives_a_step(run):
    """``model=2``, SP on, remat, the whole embedding and head split over
    ``model`` (a vocab-parallel lookup: one reduce-scatter; the head
    gathered: one all-gather), every collective's backward its mirror.

    rwkv6 (L layers): a layer's forward gathers the sequence twice (the
    time-mix's and the channel-mix's entries) and, of the params the rules
    split another way than its heads, ``w_lora_a`` (its LoRA rank),
    ``w_lora_b`` (its rows), ``u`` (its head dim), ``w_o`` (its columns)
    and ``cw_r`` (its columns): 7 all-gathers, and its two exits 2
    reduce-scatters, all again in remat's recompute (the channel-mix's
    gate multiplies its exit's output, which the backward reads); the
    whole vectors ``ln1``, ``ln2``, the four time-mix lerps, ``w0``,
    ``cmix_k``, ``cmix_r`` (and ``ln_f``) are all-reduced in the
    backward.

    zamba2 (G groups of E mamba layers): a mamba layer gathers the
    sequence, ``w_in`` and ``conv_w`` (3), reduce-scatters its exit and
    sums the gated norm's squares (one all-reduce, again in the backward);
    ``mamba_ln``, ``norm_w`` and the three per-head vectors are
    all-reduced in the backward; a group's shared attention and MLP each
    gather and reduce-scatter once (their weights' pieces are the rank's
    heads and ff columns), their norms all-reduced in the backward; the
    recompute stops before the group's last reduce-scatter."""
    for res in _results(run, "rwkv_m2"):
        layers = CASES["rwkv_m2"][2].get("n_layers", 2)
        for c in res["counts"]:
            assert c["data"] == {} and c["world"]["all_reduce"] == 1
            assert c["model"]["all_gather"] == 16 * layers + 2
            assert c["model"]["reduce_scatter"] == 11 * layers + 2
            assert c["model"]["all_reduce"] == 9 * layers + 1
    cfg = ModelConfig(**_cfg_kw("zamba_m2"))
    g, e = cfg.n_layers // cfg.attn_every, cfg.attn_every
    for res in _results(run, "zamba_m2"):
        for c in res["counts"]:
            assert c["data"] == {} and c["world"]["all_reduce"] == 1
            assert c["model"]["all_gather"] == \
                2 * g * (3 * e + 2) + g * (e + 2) + 2
            assert c["model"]["reduce_scatter"] == \
                g * (e + 2) + g * (e + 1) + g * (3 * e + 2) + 2
            assert c["model"]["all_reduce"] == \
                2 * g * e + g * (6 * e + 2) + 1


def test_sp_off_all_reduces_the_exits(run):
    """Sequence 15 on ``data=2, model=2``: every rank holds the whole
    sequence, so no block gathers or reduce-scatters it: only ``w_in``
    and ``conv_w`` (in the forward and again in remat's recompute) and
    the head are gathered, and only their gradients reduce-scattered; the
    data group all-reduces the gradients of the leaves it does not
    split."""
    cfg = ModelConfig(**_cfg_kw("zamba_sp_off"))
    g, e = cfg.n_layers // cfg.attn_every, cfg.attn_every
    for res in _results(run, "zamba_sp_off"):
        for c in res["counts"]:
            assert c["model"]["all_gather"] == 2 * 2 * g * e + 1
            assert c["model"]["reduce_scatter"] == 2 * g * e + 1
            assert c["data"]["all_reduce"] > 0


def test_checkpoint_over_both_axes_restores_bitwise(run):
    """Saved on ``data=2, model=2`` (FSDP + TP, zamba2) after two steps:
    restored bitwise in one process and on ``model=2``, and one more step
    from each agrees with the step the saving ranks took."""
    saved = run["four"][0]["runs"][CKPT]["steps"][-1][1]
    shape, cfg_kw, state0, batches, _ = run["inputs"][CKPT]
    cfg = ModelConfig(**cfg_kw)
    template = train_state_from_numpy(cfg, state0, device="cpu")
    step_no, one, extra = CheckpointManager(
        os.path.join(run["tmp"], "rec_tp_ckpt")).restore_latest(template)
    assert step_no == 2 and extra == {"data_state": {"step": 2}}
    got = TR.numpy_state(one)
    assert [p for p, _ in got] == [p for p, _ in saved]
    for (p, a), (_, b) in zip(got, saved):
        assert a.dtype == b.dtype and np.array_equal(a, b), p
    for res in run["two"]:
        step_no, extra, restored = res["restored"]
        assert step_no == 2
        for (p, a), (_, b) in zip(restored, saved):
            assert np.array_equal(a, b), p
    one, m_one = tstep.make_train_step(Model(cfg), **TR.STEP)(one,
                                                              batches[2])
    m_mesh, want = run["four"][0]["after_save"]
    for m, st in [(m_one, TR.numpy_state(one))] + [
            res["after_restore"] for res in run["two"]]:
        assert m["applied"] == m_mesh["applied"] == 1
        np.testing.assert_allclose(m["loss"], m_mesh["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(m["grad_norm"], m_mesh["grad_norm"],
                                   rtol=LOSS_RTOL)
        _assert_close(st, want, saved, LEAF_TOL)


@pytest.mark.parametrize("arch, d_model, m, split", [
    ("rwkv6_1_6b", 2048, 16, True), ("rwkv6_1_6b", 2048, 3, False),
    ("zamba2_2_7b", 2560, 16, True), ("zamba2_2_7b", 2560, 3, False),
    ("zamba2_2_7b", 96, 2, False), ("rwkv6_1_6b", 192, 2, False)])
def test_mixer_heads_and_columns(arch, d_model, m, split):
    """The mixer's heads split where ``model`` divides them (rwkv6-1.6b's
    32, zamba2-2.7b's 80 mamba heads on the production ``model=16``);
    each rank's ``w_in`` / ``conv_w`` columns are its heads' ``z``, ``x``
    and ``dt`` and the whole ``B | C``, and the ranks' ranges tile the
    heads' segments."""
    from repro_torch.configs import config
    cfg = dataclasses.replace(config(arch), d_model=d_model)
    assert collectives.check_model_axis(cfg, {"model": m}, mixer=True) \
        is split
    nh = collectives.mixer_heads(cfg)
    assert nh == (d_model // 64 if cfg.family == "ssm" else d_model // 32)
    group = type("G", (), {"size": m, "index": 0})
    tps = []
    for r in range(m):
        group.index = r
        tps.append(collectives.TensorParallel(
            group, {}, cfg, 16))
        group = type("G", (), {"size": m, "index": r + 1})
    heads = [tp.mixer_heads for tp in tps]
    if split:
        assert heads == [(r * nh // m, (r + 1) * nh // m) for r in range(m)]
    else:
        assert heads == [(0, nh)] * m
    if cfg.family == "hybrid":
        din, n = 2 * d_model, cfg.ssm_state
        for tp in tps:
            cols = tp.mamba_columns(cfg)
            (z0, z1), (x0, x1), bc, (t0, t1) = cols["w_in"]
            assert (x0 - z0, x1 - z1) == (din, din)
            assert bc == (2 * din, 2 * din + 2 * n)
            assert (t1 - t0) * 64 == z1 - z0
            assert cols["conv_w"] == [(z0, z1), (din, din + 2 * n)]


def test_the_rules_keep_their_storage(run):
    """The rank's stored pieces are the rules' (``w_in`` cut into
    ``model`` contiguous pieces of columns that straddle ``z | x | B | C
    | dt``; ``u`` on its head dim; ``w_lora_a`` on its LoRA rank): the
    port cuts the compute's columns from them, no spec changes."""
    cfg = ModelConfig(**_cfg_kw("zamba_m2"))
    specs = rules.params_specs(Model(cfg).init_params(torch.Generator(),
                                                      "meta"),
                               {"data": 1, "model": 2}, cfg)
    mamba = specs["blocks"]["mamba"][0][0]
    assert mamba["w_in"] == (None, "model")
    assert mamba["w_out"] == ("model", None)
    cfg = ModelConfig(**_cfg_kw("rwkv_m2"))
    mix = rules.params_specs(Model(cfg).init_params(torch.Generator(),
                                                    "meta"),
                             {"data": 1, "model": 2}, cfg)["blocks"][0]["mix"]
    assert mix["u"] == (None, "model")
    assert mix["w_lora_a"] == (None, "model")
    assert mix["w_o"] == (None, "model")
