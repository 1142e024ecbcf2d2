"""Training on a mesh's data axes in the port (``repro_torch.sharding.rules``
/ ``ctx`` / ``collectives``, ``train.step`` on a mesh, ``ckpt`` on a
mesh, ``ft.compress``, ``launch.train --data-axis``, ``launch.specs`` /
``dryrun``) on the CPU, held against the reference.

The rules are pure functions of shapes and mesh sizes: the port's run on
``meta`` tensors and the reference's on ``jax.eval_shape`` trees, both on
duck-typed meshes (``shape`` mappings), spec for spec, at full width and
at the production meshes.

The reference's sharded drills do not run under this JAX, so a sharded
step of the port on W gloo ranks is held to the reference's one-device
step (a 1 x 1 mesh, as ``tests/test_torch_train.py``) on the same global
batch.  The parent computes the reference's values; two spawns
(``tests/_sharded_train_ranks.py``, which imports only ``repro_torch``)
run every case on ``data=2`` and on ``pod=2, data=2``.  The config is
``test_torch_train.py``'s tiny one (2 layers, d 32) with qk_norm and
remat, fp32, global batch 8 x 16.

Tolerances.  Those of ``test_two_steps_match_params_moments_lr_grad_norm``
(loss and grad_norm 1e-5 relative, each leaf 2e-5 of its largest
magnitude, the learning rate exact) hold unwidened: the ranks' sums in
gloo's order move the leaves by ~1e-6 of their scale here.  With
``microbatches=2`` and bf16 accumulation a rank rounds its own partial
gradient to bf16 where the reference rounds the global one, and the
all-reduce adds those bf16 partials in bf16: up to one bf16 ulp more per
element, so moments are held to 2e-2 of the leaf's largest magnitude (the
one-device test's 1e-2, doubled for the second rounding) and grad_norm to
1e-3.  8-bit moments as ``test_8bit_moments_one_scale_per_stacked_leaf``
(payloads within one quantization step, scales 1e-5); params to 3 % of
the reference's update (the one-device test's 2 %; ``_assert_leaves_close``
says why) on the elements whose moment payloads agree.
"""
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _sharded_train_ranks as R
from repro.configs import config as jconfig
from repro.configs import smoke_config as jsmoke
from repro.ft import compress as jcompress
from repro.launch import specs as jspecs
from repro.models.common import ModelConfig as JModelConfig
from repro.models.transformer import Model as JModel
from repro.sharding import rules as jrules
from repro.train import step as jstep
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import config, smoke_config
from repro_torch.data import pipeline as pipe
from repro_torch.launch import dryrun
from repro_torch.models.convert import train_state_from_numpy
from repro_torch.models.transformer import Model
from repro_torch.optim import adamw
from repro_torch.sharding import ctx, rules
from repro_torch.testing import ranks
from repro_torch.train import step as tstep

LOSS_RTOL = 1e-5
LEAF_TOL = 2e-5
MB_TOL = 2e-2
BATCH, SEQ, STEPS = 8, 16, 2

MESHES = {f"data={d},model={m}": {"data": d, "model": m}
          for d in (1, 2, 4) for m in (1, 2)}
MESHES["data=16,model=16"] = {"data": 16, "model": 16}
MESHES["pod=2,data=16,model=16"] = {"pod": 2, "data": 16, "model": 16}
CONFIGS = ["qwen3_4b", "yi_9b", "qwen3_4b:smoke", "yi_9b:smoke"]


@pytest.fixture(autouse=True, scope="module")
def _reference_mesh_context():
    """The reference's ``make_train_step`` sets its process mesh context
    (``repro.sharding.ctx``); put it back when this module is done, so a
    later module in the same worker starts without one."""
    from repro.sharding import ctx as jctx
    prev = jctx.get_mesh()
    yield
    jctx.set_mesh(prev)


def _cfgs(name, **kw):
    arch, _, smoke = name.partition(":")
    port = (smoke_config if smoke else config)(arch, **kw)
    ref = (jsmoke if smoke else jconfig)(arch)
    return port, JModelConfig(**{**ref.__dict__, **kw})


def _duck(mesh):
    return types.SimpleNamespace(shape=dict(mesh))


_REF_SHAPES = {}


def _ref_state(jcfg):
    key = (jcfg, "state")
    if key not in _REF_SHAPES:
        model = JModel(jcfg)
        _REF_SHAPES[key] = jax.eval_shape(
            lambda k: jstep.make_train_state(model, k,
                                             use_8bit=jcfg.opt_8bit),
            jax.random.PRNGKey(0))
    return _REF_SHAPES[key]


def _ref_node(tree, path):
    """The reference's node at a port path (layer indices skipped: the
    reference stacks the layers)."""
    for k in path:
        if isinstance(k, int):
            continue
        tree = tree[k] if isinstance(tree, dict) else getattr(tree, k)
    return tree


def _assert_specs_match(port_tree, ref_tree, stacked_prefix=("blocks",)):
    """Every port leaf's spec equals the reference's (the stacked leaf's
    spec without its leading None inside ``blocks``)."""
    seen = []

    def walk(node, path):
        if node is None:
            assert _ref_node(ref_tree, path) is None, path
            return
        if isinstance(node, rules.PS):
            want = tuple(_ref_node(ref_tree, path))
            if path[:1] == stacked_prefix:
                assert want[0] is None, (path, want)
                want = want[1:]
            assert tuple(node) == want, (path, tuple(node), want)
            seen.append(path)
            return
        if isinstance(node, adamw.QTensor):
            ref = _ref_node(ref_tree, path)
            walk(node.q, path + ("q",))
            assert tuple(node.scale) == tuple(ref.scale) == (), path
            return
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            for i, v in enumerate(node):
                walk(v, path + (i,))
    walk(port_tree, ())
    return seen


# ---------------------------------------------------------------------------
# the rules, spec for spec, on duck-typed meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt_8bit", [False, True])
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_params_and_state_specs_equal_the_reference(mesh, name, fsdp,
                                                    opt_8bit):
    cfg, jcfg = _cfgs(name, fsdp=fsdp, opt_8bit=opt_8bit)
    shape = MESHES[mesh]
    jstate = _ref_state(jcfg)
    want_p = jrules.params_specs(jstate["params"], _duck(shape), jcfg)
    state = tstep.make_train_state(Model(cfg), torch.Generator(),
                                   use_8bit=opt_8bit, device="meta")
    got_p = rules.params_specs(state["params"], _duck(shape), cfg)
    assert got_p == rules.params_specs(state["params"], shape, cfg)
    n = len(_assert_specs_match(got_p, want_p))
    assert n == len(adamw.leaves(state["params"]))
    want = jstep.state_specs(jstate, _duck(shape), jcfg)
    got = tstep.state_specs(state, _duck(shape), cfg)
    for part in ("m", "v"):
        _assert_specs_match(got["opt"][part], want["opt"][part])
    assert got["step"] == tuple(want["step"]) == ()
    assert got["opt"]["step"] == tuple(want["opt"]["step"]) == ()
    assert rules.opt_state_specs(got_p, shape, cfg) is got_p


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_and_activation_specs_equal_the_reference(mesh):
    shape = _duck(MESHES[mesh])
    assert tuple(rules.batch_specs(shape)) == tuple(jrules.batch_specs(shape))
    for sp in (True, False):
        assert tuple(rules.activation_spec(shape, sp=sp)) == \
            tuple(jrules.activation_spec(shape, sp=sp))


@pytest.mark.parametrize("batch", [1, 32])
@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_cache_specs_equal_the_reference(mesh, name, batch):
    cfg, jcfg = _cfgs(name)
    shape = _duck(MESHES[mesh])
    jcache = jax.eval_shape(lambda: JModel(jcfg).init_cache(batch, 4096))
    want = jrules.cache_specs(jcfg, shape, jcache)
    got = rules.cache_specs(cfg, shape,
                            Model(cfg).init_cache(batch, 4096, "meta"))
    assert tuple(got.k) == tuple(want.k) and tuple(got.v) == tuple(want.v)


def test_named_placements_and_a_spec_out_of_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = {"pod": 2, "data": 2, "model": 1}
    got = rules.named(mesh, {"w": rules.PS(None, ("pod", "data")),
                             "v": rules.PS("model"), "s": rules.PS()})
    assert got["w"] == (Shard(1), Shard(1), Replicate())
    assert got["v"] == (Replicate(), Replicate(), Shard(0))
    assert got["s"] == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        rules.named(mesh, rules.PS(("data", "pod")))
    with pytest.raises(ValueError, match="lacks"):
        rules.named(mesh, rules.PS("x"))


def test_constraint_resolution_follows_the_reference():
    mesh = {"data": 2, "model": 4}
    # absent axes dropped; a dim the axes do not divide stays whole
    assert ctx.resolve((4, 8, 3), (("pod", "data"), "model", "model"),
                       mesh) == (("data",), "model", None)
    assert ctx.resolve((3, 6), ("data", "x"), mesh) == (None, None)
    t = torch.ones(2)
    assert ctx.get_mesh() is None and ctx.constraint(t, "data") is t


# ---------------------------------------------------------------------------
# the sharded step against the reference's one-device step
# ---------------------------------------------------------------------------

def _batches(masked=False):
    it = pipe.SyntheticLM(pipe.DataConfig(vocab=64, seq_len=SEQ,
                                          global_batch=BATCH)).iterator()
    out = [next(it)[0] for _ in range(STEPS)]
    if masked:
        # unequal masks: the first 3 rows (data index 0's at every W here)
        # lose most of their labels
        for b in out:
            b["labels"] = b["labels"].copy()
            b["labels"][:3, :12] = -100
    return out


def _ref_numpy(tree):
    """The reference's state as numpy in plain dicts (its NamedTuples as
    dicts, an 8-bit moment as the port's QTensor), so the ranks unpickle
    it without the reference."""
    if tree is None:
        return None
    fields = getattr(tree, "_fields", None)
    if fields == ("q", "scale"):
        return adamw.QTensor(np.asarray(tree.q), np.asarray(tree.scale))
    if fields is not None:
        return {f: _ref_numpy(getattr(tree, f)) for f in fields}
    if isinstance(tree, dict):
        return {k: _ref_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _ref_run(cfg_kw, batches, *, microbatches=1):
    jcfg = JModelConfig(**{**R.TINY, **cfg_kw})
    model = JModel(jcfg)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    state = jstep.make_train_state(model, jax.random.PRNGKey(0),
                                   use_8bit=jcfg.opt_8bit)
    _, jit_with, _ = jstep.make_train_step(
        model, mesh, microbatches=microbatches, donate=False, **R.STEP)
    run = jit_with(jstep.state_specs(state, mesh, jcfg))
    out, st = [], state
    for b in batches:
        st, m = run(st, {k: jnp.asarray(v) for k, v in b.items()})
        out.append(({k: float(v) for k, v in m.items()}, _ref_numpy(st)))
    return _ref_numpy(state), out


CASES = {"base": ({}, {}), "mb2": ({}, {"microbatches": 2}),
         "masks": ({}, {}), "8bit": ({"opt_8bit": True}, {})}


@pytest.fixture(scope="module")
def reference():
    """{case: (cfg kw, step kw, initial numpy state, batches, per step
    (metrics, numpy state))}; compress rows for W 2 and 4."""
    out = {}
    for name, (cfg_kw, step_kw) in CASES.items():
        batches = _batches(masked=name == "masks")
        state0, steps = _ref_run(cfg_kw, batches, **step_kw)
        out[name] = (cfg_kw, step_kw, state0, batches, steps)
    rng = np.random.RandomState(0)
    comp = {}
    for w in (2, 4):
        rows = rng.randn(w, 40).astype(np.float32)
        errs = (0.01 * rng.randn(w, 40)).astype(np.float32)
        bf = jax.vmap(lambda g: jcompress.bf16_psum(g, "i"),
                      axis_name="i")(jnp.asarray(rows))
        red, err = jax.vmap(
            lambda g, e: jcompress.int8_ef_psum({"a": g}, {"a": e}, "i"),
            axis_name="i")(jnp.asarray(rows), jnp.asarray(errs))
        q8 = [jcompress._q8(jnp.asarray(r)) for r in rows]
        comp[w] = (rows, errs, np.asarray(bf), np.asarray(red["a"]),
                   np.asarray(err["a"]),
                   [(np.asarray(q), float(s)) for q, s in q8])
    return out, comp


PLACEMENT_SPECS = {
    "data=2": [((8, 4), ("data", None)), ((8, 4), (None, "data")),
               ((4, 8, 6), (None, ("data",), None)), ((8,), ("data",)),
               ((3, 5), (None, None))],
    "data=2,model=1": [((8, 4), ("data", "model")),
                       ((8, 4), (("data", "model"), None)),
                       ((4, 8), (None, ("data", "model")))],
}
PLACEMENT_SPECS["data=1,model=2"] = PLACEMENT_SPECS["data=2,model=1"] + [
    ((4, 8), ("model", None))]


def _one_process_checkpoint(reference, directory):
    """The port's one-device step once from the base case, checkpointed
    by one process: (the state, the step's metrics)."""
    cfg_kw, _, state0, batches, _ = reference[0]["base"]
    cfg = R.cfg_of(**cfg_kw, fsdp=True)
    state = train_state_from_numpy(cfg, state0, device="cpu")
    step = tstep.make_train_step(Model(cfg), **R.STEP)
    state, m = step(state, batches[0])
    CheckpointManager(directory, async_save=False).save(
        1, state, extra={"data_state": {"step": 1}})
    return state, m


@pytest.fixture(scope="module")
def two(reference, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sharded_train"))
    one_state, _ = _one_process_checkpoint(reference, f"{tmp}/from_one")
    ref = {"cases": {k: v[:4] for k, v in reference[0].items()},
           "placement_specs": PLACEMENT_SPECS,
           "compress": reference[1][2][:2]}
    return ranks.spawn(R.rank_work_two, 2, args=(ref, tmp),
                       timeout=300), tmp, one_state


@pytest.fixture(scope="module")
def four(reference):
    ref = {"cases": {"base": reference[0]["base"][:4]},
           "compress": reference[1][4][:2]}
    return ranks.spawn(R.rank_work_four, 4, args=(ref,), timeout=300)


def _port_np(cfg_kw, np_state):
    """The reference's numpy state in the port's layout, as ``(path,
    array)``."""
    cfg = R.cfg_of(**cfg_kw)
    return R.numpy_state(train_state_from_numpy(cfg, np_state,
                                                device="cpu"))


def _assert_leaves_close(got, want, tol, eight_bit=False, prev=None):
    assert [p for p, _ in got] == [p for p, _ in want]
    prev = dict(prev or [])
    got_d, want_d = dict(got), dict(want)
    differ = total = 0
    for (path, a), (_, b) in zip(got, want):
        name = "/".join(map(str, path))
        if eight_bit and path[-1] == "q":
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() \
                <= 1, name
            continue
        if eight_bit and path[-1] == "scale":
            np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=name)
            continue
        scale = max(float(np.abs(b).max()), 1e-30)
        bound = tol * scale
        if eight_bit and path[0] == "params":
            # 8-bit Adam divides by second moments quantized to 0 (the
            # reference's own step moves a param by ~19 here, its update
            # then ~ 1 / |g|), so a payload of m or v one step off (a
            # rounding flip, allowed above) moves that element's update
            # wholesale, and where v is 0 the update magnifies the
            # gradient's last bits.  The one-device test holds params to 2 %
            # of the reference's largest update of the leaf; here the port's
            # own one-device step sits at 2.0 % of it on w_gate's most
            # sensitive element and the ranks' sum order adds 0.23 %: 3 %,
            # on the elements whose moment payloads agree (at least 99 %).
            same = np.ones(a.shape, bool)
            for mv in ("m", "v"):
                q = ("opt", mv) + path[1:] + ("q",)
                same &= got_d[q] == want_d[q]
            differ, total = differ + int((~same).sum()), total + same.size
            bound += 3e-2 * float(np.abs(b - prev[path]).max())
            a, b = a[same], b[same]
        err = float(np.abs(a - b).max()) if a.size else 0.0
        assert err <= bound, f"{name}: {err} > {bound}"
    assert differ <= 0.01 * total, (differ, total)


def _check_run(run, ref_case, *, tol=LEAF_TOL, gn_rtol=LOSS_RTOL,
               eight_bit=False):
    cfg_kw, _, state0, _, ref_steps = ref_case
    prev = _port_np(cfg_kw, state0)
    for (m, got), (jm, jst) in zip(run, ref_steps):
        assert m["applied"] == int(jm["applied"]) == 1
        assert m["lr"] == jm["lr"]
        np.testing.assert_allclose(m["loss"], jm["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"],
                                   rtol=gn_rtol)
        want = _port_np(cfg_kw, jst)
        _assert_leaves_close(got, want, tol, eight_bit, prev)
        prev = want


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_two_ranks_match_the_reference_step(two, reference, mode):
    """Two steps on data=2: every leaf, the moments, loss, grad_norm and
    lr, on each rank."""
    for res in two[0]:
        _check_run(res["runs"][f"{mode}_base"], reference[0]["base"])


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_four_ranks_pod_by_data_match_the_reference_step(four, reference,
                                                         mode):
    assert sorted(r["index"] for r in four) == [0, 1, 2, 3]
    for res in four:
        _check_run(res["runs"][f"{mode}_base"], reference[0]["base"])


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_microbatches_in_bf16_match_the_reference(two, reference, mode):
    for res in two[0]:
        _check_run(res["runs"][f"{mode}_mb2"], reference[0]["mb2"],
                   tol=MB_TOL, gn_rtol=1e-3)


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_unequal_label_masks_give_the_global_mean(two, reference, mode):
    """Rank 0's rows hold far fewer labels than rank 1's: the loss is the
    reference's mean over the global batch's unmasked tokens (a mean of
    the ranks' means would be 4.1 % off here)."""
    batches = reference[0]["masks"][3]
    counts = [int((b["labels"][:BATCH // 2] >= 0).sum()) for b in batches]
    assert counts[0] < int((batches[0]["labels"][BATCH // 2:] >= 0).sum())
    for res in two[0]:
        _check_run(res["runs"][f"{mode}_masks"], reference[0]["masks"])


def test_8bit_moments_under_fsdp_one_scale_across_ranks(two, reference):
    """FSDP splits each moment over the ranks; its scale is still the amax
    over every layer and every rank's shard: the reference's one scale."""
    for res in two[0]:
        run = res["runs"]["fsdp_8bit"]
        _check_run(run, reference[0]["8bit"], eight_bit=True)
        scales = {}
        for path, a in run[-1][1]:
            if path[-1] == "scale" and path[2] == "blocks":
                scales.setdefault((path[1],) + path[4:], set()).add(
                    float(a))
        assert scales and all(len(v) == 1 for v in scales.values())
    assert two[0][0]["collectives"]["fsdp_8bit"]["all_reduce"] > \
        two[0][0]["collectives"]["fsdp_base"]["all_reduce"]


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_collectives_a_step(two, mode):
    """DP: one all_reduce a leaf and one for the loss a step; FSDP: each
    split leaf gathered in the forward and again in remat's recompute
    (block leaves) and reduce-scattered once, whole leaves all-reduced."""
    cfg = R.cfg_of(fsdp=mode == "fsdp")
    meta = Model(cfg).init_params(torch.Generator(), "meta")
    n = len(adamw.leaves(meta))
    counts = two[0][0]["collectives"][f"{mode}_base"]
    if mode == "dp":
        assert counts["all_reduce"] == STEPS * (n + 1)
        assert "all_gather" not in counts
    else:
        specs = rules.params_specs(meta, {"data": 2, "model": 1}, cfg)
        split = [p for p, _ in adamw.leaves(meta)
                 if any(e is not None and "data" in (e if isinstance(e, tuple)
                                                      else (e,))
                        for e in rules_at(specs, p))]
        blocks = sum(1 for p in split if p[0] == "blocks")
        assert counts["reduce_scatter"] == STEPS * len(split)
        assert counts["all_gather"] == STEPS * (len(split) + blocks)
        assert counts["all_reduce"] == STEPS * (n - len(split) + 1)


def rules_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_a_nan_on_one_ranks_rows_writes_nothing(two, mode):
    for res in two[0]:
        m, kept = res[f"nan_{mode}"]
        assert m["applied"] == 0 and kept
        assert not math.isfinite(m["loss"])


def test_a_batch_the_ranks_do_not_divide_raises(two):
    for res in two[0]:
        assert "does not split over 2 data ranks" in res["odd_batch"]


@pytest.mark.parametrize("mesh", list(PLACEMENT_SPECS))
def test_local_shards_equal_dtensors(two, mesh):
    for res in two[0]:
        cases = res["placements"][mesh]
        assert len(cases) > len(PLACEMENT_SPECS[mesh])
        assert all(ok for _, _, ok in cases), [c for c in cases if not c[2]]


def test_constraint_on_a_mesh_and_the_model_axis(two):
    for res in two[0]:
        c = res["constraint"]
        assert c["data=2,model=1"] is True
        # the model axis: the rank's sequence shard at the SP boundary; the
        # data group of a data=1 mesh is one rank, the model group splits
        # the spec's dim 1
        assert c["data=1,model=2"] is True
        assert c["data_group"] == (1, 0, None, 1)


@pytest.mark.parametrize("w", [2, 4])
def test_compress_equals_the_reference(two, four, reference, w):
    rows, errs, bf, red, err, q8 = reference[1][w]
    results = two[0] if w == 2 else four
    for r, res in enumerate(results):
        c = res["compress"]
        # bf16 sums: one bf16 ulp of the sum's magnitude
        np.testing.assert_allclose(c["bf16"], bf[r], rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(bf[r]).max())
        np.testing.assert_allclose(c["int8"], red[r], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(c["err"], err[r])
        np.testing.assert_array_equal(c["q8"][0], q8[r][0])
        assert c["q8"][1] == pytest.approx(q8[r][1], rel=1e-7)
        assert c["zeros"]


def test_a_mesh_checkpoint_resumes_on_one_process_bitwise(two, tmp_path):
    """The 2-rank run's checkpoint, restored by one process: each rank's
    shards are the one process's state cut, bit for bit."""
    results, tmp, _ = two
    cfg = R.cfg_of(fsdp=True)
    template = tstep.make_train_state(Model(cfg), torch.Generator(),
                                      device="cpu")
    step_no, state, extra = CheckpointManager(
        f"{tmp}/from_mesh").restore_latest(template)
    assert step_no == 1 and extra == {"data_state": {"step": 1}}
    mesh = {"data": 2, "model": 1}
    specs = tstep.state_specs(state, mesh, cfg)
    for res in results:
        cut = R.numpy_state(rules.tree_map_specs(
            lambda sp, t: rules.local_shard(t, mesh, sp, res["coordinate"]),
            specs, state))
        assert [p for p, _ in cut] == [p for p, _ in res["saved_shards"]]
        for (p, a), (_, b) in zip(cut, res["saved_shards"]):
            assert a.tobytes() == b.tobytes(), p


def test_a_one_process_checkpoint_resumes_on_two_ranks_bitwise(two):
    results, _, one_state = two
    cfg = R.cfg_of(fsdp=True)
    mesh = {"data": 2, "model": 1}
    specs = tstep.state_specs(one_state, mesh, cfg)
    for res in results:
        step_no, extra, got, coord = res["restored"]
        assert step_no == 1 and extra == {"data_state": {"step": 1}}
        cut = R.numpy_state(rules.tree_map_specs(
            lambda sp, t: rules.local_shard(t, mesh, sp, coord), specs,
            one_state))
        for (p, a), (_, b) in zip(cut, got):
            assert a.tobytes() == b.tobytes(), p


def test_launcher_on_two_ranks(two):
    results, tmp, _ = two
    assert [r["launch"] for r in results] == [0, 0]
    import os
    assert sorted(os.listdir(f"{tmp}/launch")) == ["step_0000000002"]


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def _ref_bytes(sds_tree, spec_tree, mesh):
    """Bytes one device holds: each leaf's bytes over the product of the
    axes its reference spec names."""
    is_ps = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    leaves = jax.tree_util.tree_leaves(sds_tree)
    specs = jax.tree_util.tree_leaves(spec_tree, is_leaf=is_ps)
    assert len(leaves) == len(specs)
    total = 0
    for leaf, spec in zip(leaves, specs):
        parts = 1
        for e in spec:
            for a in (() if e is None else (e,) if isinstance(e, str)
                      else e):
                parts *= mesh[a]
        total += int(np.prod(leaf.shape)) * leaf.dtype.itemsize // parts
    return total


# (arch, shape): the transformer families' cells, and the recurrent
# families' serving cells (long_500k applies to them: sub-quadratic)
DRYRUN_CELLS = [(a, s) for a in ("qwen3_4b", "yi_9b")
                for s in ("train_4k", "prefill_32k", "decode_32k")] + [
    (a, s) for a in ("rwkv6_1_6b", "zamba2_2_7b")
    for s in ("prefill_32k", "decode_32k", "long_500k")]


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch,shape", DRYRUN_CELLS,
                         ids=[f"{a}-{s}" for a, s in DRYRUN_CELLS])
def test_dryrun_bytes_equal_the_reference_specs(arch, shape, multi):
    mesh = dryrun.MESHES["multi" if multi else "single"]
    rec = dryrun.lower_cell(arch, shape, multi)
    jcfg = jconfig(arch)
    duck = _duck(mesh)
    model = jspecs.model_for(jcfg, shape)
    data, data_spec = jspecs.input_specs(jcfg, shape, duck)
    want = _ref_bytes(data, data_spec, mesh)
    if shape == "train_4k":
        st = jspecs.train_state_sds(model)
        want += _ref_bytes(st, jstep.state_specs(st, duck, model.cfg), mesh)
        tokens = 256 * 4096
    else:
        params = jspecs.params_sds(model)
        cache = jspecs.cache_sds(model, shape)
        want += _ref_bytes(params, jrules.params_specs(params, duck,
                                                       model.cfg), mesh)
        want += _ref_bytes(cache, jrules.cache_specs(model.cfg, duck,
                                                     cache), mesh)
        tokens = {"prefill_32k": 32 * 32768, "decode_32k": 128,
                  "long_500k": 1}[shape]
    assert jspecs.shape_applicable(jcfg, shape)[0]
    assert rec["status"] == "ok" and rec["memory"]["argument_bytes"] == want
    assert rec["chips"] == math.prod(mesh.values())
    assert rec["tokens_per_step"] == tokens
    assert rec["params"] == jcfg.param_count()
    assert rec["active_params"] == jcfg.active_param_count()
    assert "roofline" in rec
    assert rec["roofline"]["flops"] > 0 and \
        rec["roofline"]["xla_flops_raw"] is None
    assert "error" not in rec["roofline"]


@pytest.mark.parametrize("arch", ["qwen3_4b", "yi_9b"])
def test_dryrun_skips_long_context_like_the_reference(arch):
    rec = dryrun.lower_cell(arch, "long_500k", False)
    ok, why = jspecs.shape_applicable(jconfig(arch), "long_500k")
    assert not ok and rec == {"status": "skipped", "reason": why}
