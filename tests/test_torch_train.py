"""Training in the port (``repro_torch``: ``Model.loss``, ``optim.adamw``,
``train.step``, ``data.pipeline``, ``ckpt.manager``, ``TrainLoop``,
``launch.train``) held against the reference (``repro``) on the CPU.

Both packages start from the same state: the reference's
``make_train_state`` tree, as numpy, through ``train_state_from_numpy``.
The config is the reference test's ``tiny_cfg`` (2 layers, d 32, 4 / 2
heads, d_ff 64, vocab 64, fp32, remat off), plus a case with
``qk_norm=True`` and one with remat on.  The reference's step is its
jitted ``make_train_step`` on a 1 x 1 CPU mesh, ``donate=False``; the
port's updates its state in place (the reference donates by default), so
a test that reuses a state clones it.

Tolerances (fp32 on both sides; XLA and torch sum in other orders): the
loss 1e-5 relative; a gradient, moment or param leaf 2e-5 of that leaf's
largest magnitude (the two agree to 2e-6 after one step and 2e-5 after
ten, measured when this was written); the learning rate exactly (both
compute the same fp32 schedule); the 10-step loss trajectory 1e-5
relative.  With ``microbatches=2`` and bf16 accumulation each gradient is
rounded to bf16 on both sides, where a flip of that rounding moves a value
by 2**-8 relative: moments 1e-2 of the leaf's largest magnitude.  8-bit
moments: the int8 payloads within one step of quantization (a rounding
flip), the scales 1e-5 relative, the params 2 % of the reference's own
update (see the test).  The NaN guard and the data are held
bitwise."""
import copy
import os
import subprocess
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.ckpt.manager import CheckpointManager as JCheckpointManager
from repro.data import pipeline as jpipe
from repro.models.common import ModelConfig as JModelConfig
from repro.models.common import cross_entropy as jcross_entropy
from repro.models.transformer import Model as JModel
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.data import pipeline as pipe
from repro_torch.ft import resilience as ft
from repro_torch.models.common import ModelConfig, cross_entropy
from repro_torch.models.convert import (params_from_numpy,
                                        train_state_from_numpy)
from repro_torch.models.transformer import Model
from repro_torch.optim import adamw
from repro_torch.testing import faults
from repro_torch.train import step as tstep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
LEAF_TOL = 2e-5

CASES = {"plain": {}, "qk_norm": {"qk_norm": True},
         "remat": {"remat": True, "qk_norm": True}}


def tiny(**kw):
    base = dict(name="tiny", family="dense", n_layers=2, d_model=32,
                n_heads=4, n_kv_heads=2, d_ff=64, vocab=64, dtype="float32",
                remat=False, max_seq=32)
    base.update(kw)
    return base


def data(batch=4, seq=16, **kw):
    return pipe.SyntheticLM(pipe.DataConfig(vocab=64, seq_len=seq,
                                            global_batch=batch, **kw))



@pytest.fixture(autouse=True, scope="module")
def _reference_mesh_context():
    """The reference's ``make_train_step`` sets its process mesh context
    (``repro.sharding.ctx``); put it back when this module is done, so a
    later module in the same worker starts without one."""
    from repro.sharding import ctx as jctx
    prev = jctx.get_mesh()
    yield
    jctx.set_mesh(prev)

_REF_STEPS = {}


def ref_step(cfg_kw, *, microbatches=1, steps=20, model_cls=JModel,
             use_8bit=False):
    """(reference model, initial state, jitted step), cached per setting."""
    key = (tuple(sorted(cfg_kw.items())), microbatches, steps, model_cls,
           use_8bit)
    if key not in _REF_STEPS:
        jcfg = JModelConfig(**tiny(**cfg_kw))
        model = model_cls(jcfg)
        mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                    ("data", "model"))
        state = jstep.make_train_state(model, jax.random.PRNGKey(0),
                                       use_8bit=use_8bit)
        _, jit_with, _ = jstep.make_train_step(
            model, mesh, base_lr=1e-2, warmup=5, total_steps=steps,
            microbatches=microbatches, donate=False)
        step = jit_with(jstep.state_specs(state, mesh, jcfg))

        def run(st, batch):
            return step(st, {k: jnp.asarray(v) for k, v in batch.items()})
        _REF_STEPS[key] = (model, state, run)
    return _REF_STEPS[key]


def port(cfg_kw, jstate, *, microbatches=1, steps=20, grad_bf16=True,
         model_cls=Model):
    """(port model, the reference's state in the port's layout, step)."""
    cfg = ModelConfig(**tiny(**cfg_kw))
    model = model_cls(cfg)
    state = to_port(cfg, jstate)
    step = tstep.make_train_step(model, base_lr=1e-2, warmup=5,
                                 total_steps=steps,
                                 microbatches=microbatches,
                                 grad_bf16=grad_bf16)
    return model, state, step


def to_port(cfg, jstate):
    return train_state_from_numpy(cfg, jax.tree_util.tree_map(np.asarray,
                                                              jstate),
                                  device="cpu")


def clone(state):
    """A deep copy of a port state (tensors cloned, grad flags kept)."""
    return copy.deepcopy(state)


def assert_state_close(got, want, tol=LEAF_TOL, parts=("params", "opt")):
    """Every leaf of ``parts`` within ``tol`` of the leaf's largest |value|
    (QTensors: payloads within one quantization step, scales 1e-5)."""
    for part in parts:
        for (path, a), (_, b) in zip(adamw.leaves(got[part]),
                                     adamw.leaves(want[part])):
            name = f"{part}/{'/'.join(map(str, path))}"
            if isinstance(a, adamw.QTensor):
                assert (a.q.int() - b.q.int()).abs().max() <= 1, name
                torch.testing.assert_close(a.scale, b.scale, rtol=1e-5,
                                           atol=0, msg=name)
                continue
            a, b = a.detach().float(), b.detach().float()
            scale = max(b.abs().max().item(), 1e-30)
            err = (a - b).abs().max().item()
            assert err <= tol * scale, f"{name}: {err} > {tol} x {scale}"


def assert_bitwise(a_state, b_state):
    for (path, a), (_, b) in zip(adamw.leaves(a_state),
                                 adamw.leaves(b_state)):
        pairs = zip(a, b) if isinstance(a, adamw.QTensor) else [(a, b)]
        for x, y in pairs:
            assert torch.equal(x.detach(), y.detach()), path


def batches(n, **kw):
    it = data(**kw).iterator()
    return [next(it)[0] for _ in range(n)]


# ---- the loss and its gradient ----------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_every_gradient_match(case):
    kw = CASES[case]
    jmodel, jstate, _ = ref_step(kw)
    (batch,) = batches(1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want_g = jax.value_and_grad(jmodel.loss)(jstate["params"], jb)
    cfg = ModelConfig(**tiny(**kw))
    model = Model(cfg)
    state = to_port(cfg, jstate)
    flat = [t for _, t in adamw.leaves(state["params"])]
    loss = model.loss(state["params"], {k: torch.tensor(v).long()
                                        for k, v in batch.items()})
    grads = torch.autograd.grad(loss, flat)
    np.testing.assert_allclose(loss.item(), float(want_loss),
                               rtol=LOSS_RTOL)
    want = to_port(cfg, {"params": want_g,
                         "opt": jstate["opt"], "step": jstate["step"]})
    got = {"params": adamw.unflatten(state["params"], list(grads))}
    assert_state_close(got, want, parts=("params",))


def test_remat_gives_the_same_bits():
    """cfg.remat runs each block under torch.utils.checkpoint: the same
    loss and gradients, bit for bit, as without."""
    kw = CASES["qk_norm"]
    _, jstate, _ = ref_step(kw)
    (batch,) = batches(1)
    b = {k: torch.tensor(v).long() for k, v in batch.items()}
    out = []
    for remat in (False, True):
        cfg = ModelConfig(**tiny(**kw, remat=remat))
        state = to_port(cfg, jstate)
        flat = [t for _, t in adamw.leaves(state["params"])]
        loss = Model(cfg).loss(state["params"], b)
        out.append([loss] + list(torch.autograd.grad(loss, flat)))
    assert all(torch.equal(x, y) for x, y in zip(*out))


def test_cross_entropy_masks_labels_like_the_reference(rng):
    logits = rng.randn(2, 5, 11).astype(np.float32)
    labels = rng.randint(0, 11, size=(2, 5)).astype(np.int32)
    labels[0, :2] = -100
    labels[1, 4] = -100
    want = jcross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = cross_entropy(torch.tensor(logits), torch.tensor(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_moe_loss_term_raises_naming_its_item():
    """The MoE loss term is ported: the cross entropy plus ``0.01 *`` the
    load-balancing aux summed over layers, the reference's loss and
    gradient (no raise any more)."""
    kw = tiny(family="moe", n_experts=4, top_k=2)
    jmodel = JModel(JModelConfig(**kw))
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = ModelConfig(**kw)
    model = Model(cfg)
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray,
                                                           jparams),
                               device="cpu")
    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(0, 64, (2, 16)),
             "labels": rng.randint(0, 64, (2, 16))}
    want, jgrads = jax.value_and_grad(jmodel.loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = adamw.leaves(params)
    for _, p in leaves:
        p.requires_grad_(True)
    got = model.loss(params, {k: torch.tensor(v) for k, v in batch.items()})
    assert float(model._last_aux.detach()) > 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    grads = torch.autograd.grad(got, [p for _, p in leaves])
    want_g = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray,
                                                           jgrads),
                               device="cpu")
    for (path, g), (_, w) in zip(zip([q for q, _ in leaves], grads),
                                 adamw.leaves(want_g)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(w.abs().max()),
                                   err_msg=str(path))


# ---- the train step ---------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "qk_norm"])
def test_two_steps_match_params_moments_lr_grad_norm(case):
    """Step 1 (lr 0: only the moments and counters move), step 2 (the
    params move): every leaf, lr and grad_norm."""
    kw = CASES[case]
    _, jstate, jrun = ref_step(kw)
    _, state, step = port(kw, jstate)
    for batch in batches(2):
        jstate, jm = jrun(jstate, batch)
        state, m = step(state, batch)
        assert m["lr"] == float(jm["lr"])
        assert m["applied"] == int(jm["applied"]) == 1
        np.testing.assert_allclose(m["grad_norm"], float(jm["grad_norm"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(m["loss"], float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        cfg = ModelConfig(**tiny(**kw))
        assert_state_close(state, to_port(cfg, jstate))
        assert int(state["step"]) == int(jstate["step"])
        assert int(state["opt"]["step"]) == int(jstate["opt"]["step"])


@pytest.mark.parametrize("case", ["plain", "qk_norm"])
def test_ten_steps_loss_trajectory(case):
    kw = CASES[case]
    _, jstate, jrun = ref_step(kw)
    _, state, step = port(kw, jstate)
    want, got = [], []
    for batch in batches(10):
        jstate, jm = jrun(jstate, batch)
        state, m = step(state, batch)
        want.append(float(jm["loss"]))
        got.append(m["loss"])
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]


def test_microbatches_accumulate_in_bf16_like_the_reference():
    """microbatches=2, grad_bf16: each microbatch's gradients rounded to
    bf16 and summed in bf16, then divided in fp32 (one step); and, as the
    reference's own test holds it, close to the full-batch step."""
    _, jstate, jrun = ref_step({}, microbatches=2)
    _, state, step = port({}, jstate, microbatches=2)
    (batch,) = batches(1)
    jnew, jm = jrun(jstate, batch)
    full = clone(state)
    state, m = step(state, batch)
    np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["grad_norm"], float(jm["grad_norm"]),
                               rtol=1e-3)
    assert_state_close(state, to_port(ModelConfig(**tiny()), jnew),
                       tol=1e-2)
    _, _, step1 = port({}, jstate)
    _, m1 = step1(full, batch)
    np.testing.assert_allclose(m1["loss"], m["loss"], rtol=1e-3)
    np.testing.assert_allclose(m1["grad_norm"], m["grad_norm"], rtol=0.05)


def _bf16_ulp(x):
    """One bf16 ulp at |x| (0 where x is 0)."""
    mag = x.abs()
    return torch.where(mag > 0, torch.exp2(torch.floor(torch.log2(mag)) - 7),
                       torch.zeros_like(mag))


@pytest.mark.parametrize("grad_bf16", [True, False])
def test_microbatch_sum_is_the_references_bf16_sum(grad_bf16):
    """The accumulated gradient itself, before the division and the clip,
    against the reference's bf16 sum (``jax.grad`` of each microbatch,
    cast to bf16, added to bf16 zeros in microbatch order, as its scan
    does).  With bf16 accumulation at most 0.1 % of the elements differ
    (4 of 22 688 when this was written: fp32 noise flipping a bf16
    rounding), each by at most one bf16 ulp at the largest of its two
    microbatch gradients and their sum.  Accumulating in fp32 instead
    fails this check (95 % of the elements differ), which the
    ``grad_bf16=False`` case asserts."""
    jmodel, jstate, _ = ref_step({}, microbatches=2)
    model, state, _ = port({}, jstate, microbatches=2)
    (batch,) = batches(1)
    tb = {k: torch.as_tensor(v).long() for k, v in batch.items()}
    _, acc, div = tstep.gradients(model, state["params"], tb,
                                  microbatches=2, grad_bf16=grad_bf16)
    assert div == 2
    assert all(a.dtype == (torch.bfloat16 if grad_bf16 else torch.float32)
               for a in acc)
    per = len(batch["tokens"]) // 2
    jg = [jax.grad(jmodel.loss)(jstate["params"], {
        k: jnp.asarray(v[i * per:(i + 1) * per]) for k, v in batch.items()})
        for i in range(2)]
    jsum = jax.tree_util.tree_map(
        lambda a, b: jnp.zeros(a.shape, jnp.bfloat16) + a.astype(jnp.bfloat16)
        + b.astype(jnp.bfloat16), *jg)
    cfg = ModelConfig(**tiny())

    def port_leaves(tree):
        tree = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), tree)
        st = to_port(cfg, {"params": tree, "opt": jstate["opt"],
                           "step": jstate["step"]})
        return [t.detach() for _, t in adamw.leaves(st["params"])]
    differ = beyond = total = 0
    for a, want, g1, g2 in zip(acc, *map(port_leaves, [jsum] + jg)):
        err = (a.float() - want).abs()
        mag = torch.maximum(torch.maximum(g1.abs(), g2.abs()), want.abs())
        total += err.numel()
        differ += int((err > 0).sum())
        beyond += int((err > _bf16_ulp(mag)).sum())
    passes = beyond == 0 and differ <= 1e-3 * total
    assert passes == grad_bf16, (differ, beyond, total)


def test_8bit_moments_one_scale_per_stacked_leaf():
    kw = {"opt_8bit": True}
    _, jstate, jrun = ref_step(kw, use_8bit=True)
    cfg = ModelConfig(**tiny(**kw))
    _, state, step = port(kw, jstate)
    assert isinstance(state["opt"]["m"]["blocks"][0]["ln1"], adamw.QTensor)
    for batch in batches(2):
        jprev = to_port(cfg, jstate)
        jstate, _ = jrun(jstate, batch)
        state, _ = step(state, batch)
        want = to_port(cfg, jstate)
        assert_state_close(state, want, parts=("opt",))
        # 8-bit Adam divides by second moments quantized to 0 (a stacked
        # leaf's one scale is set by its largest element): the reference's
        # own second step moves a param by up to 5.4 at lr 2e-3.  Params
        # are held to 2 % of the reference's largest update of the leaf.
        for (path, a), (_, b), (_, b0) in zip(
                adamw.leaves(state["params"]), adamw.leaves(want["params"]),
                adamw.leaves(jprev["params"])):
            a, b, b0 = a.detach(), b.detach(), b0.detach()
            bound = 2e-2 * (b - b0).abs().max().item() + \
                LEAF_TOL * b.abs().max().item()
            assert (a - b).abs().max().item() <= bound, path
    for mv in ("m", "v"):
        # one scale over the layers of a stacked leaf: the reference's
        for path, stacked in adamw.groups(state["params"]):
            if not stacked:
                continue
            scales = [adamw._members(state["opt"][mv], path, True)[i].scale
                      for i in range(cfg.n_layers)]
            assert all(torch.equal(s, scales[0]) for s in scales), path
        jq = jstate["opt"][mv]["blocks"].mlp.w_up
        pq = [blk["mlp"]["w_up"] for blk in state["opt"][mv]["blocks"]]
        np.testing.assert_allclose(pq[0].scale.item(), float(jq.scale),
                                   rtol=1e-5)
        amax = max(q.q.float().abs().max().item() for q in pq)
        assert amax == 127.0          # the amax layer sets the scale


def test_weight_decay_follows_the_reference_layout(monkeypatch):
    """The block norms are (L, d) in the reference, so it decays them;
    ln_f is (d,) and is not decayed.  The port's per-layer (d,) norms are
    decayed by that rule; with the naive per-layer rule (ndim >= 2 of the
    port's own leaves) the two packages part after the first step that
    moves the params."""
    assert adamw.decays(("blocks", "ln1"), torch.ones(4), True)
    assert adamw.decays(("blocks", "attn", "q_norm"), torch.ones(4), True)
    assert not adamw.decays(("ln_f",), torch.ones(4), False)
    assert adamw.decays(("embed",), torch.ones(4, 4), False)
    kw = CASES["qk_norm"]
    _, jstate0, jrun = ref_step(kw)
    cfg = ModelConfig(**tiny(**kw))
    jstate = jstate0
    for batch in batches(2):
        jstate, _ = jrun(jstate, batch)
    want = to_port(cfg, jstate)
    norms = [("ln1",), ("ln2",), ("attn", "q_norm"), ("attn", "k_norm")]

    def run():
        _, state, step = port(kw, jstate0)
        for batch in batches(2):
            state, _ = step(state, batch)
        return state
    state = run()
    assert_state_close(state, want)
    monkeypatch.setattr(adamw, "decays",
                        lambda path, leaf, stacked: leaf.ndim >= 2)
    naive = run()
    for path in norms:
        blk, ref_blk = naive["params"]["blocks"][0], want["params"]["blocks"][0]
        a, b = blk, ref_blk
        for k in path:
            a, b = a[k], b[k]
        # lr 2e-3 x decay 0.1 x a norm weight of ~1: 2e-4, ten times the
        # tolerance the decayed run is held to
        assert (a - b).abs().max().item() > 5 * LEAF_TOL * \
            b.abs().max().item(), path


class _NanModel(Model):
    """The loss is NaN on the ``nan_on``-th call."""
    nan_on = 1

    def __init__(self, cfg):
        super().__init__(cfg)
        self.calls = 0

    def loss(self, params, batch):
        self.calls += 1
        out = super().loss(params, batch)
        return out * float("nan") if self.calls == self.nan_on else out


class _JNanModel(JModel):
    def loss(self, params, batch):
        return super().loss(params, batch) * jnp.nan


def test_nan_guard_keeps_the_state_bitwise():
    """A non-finite loss: applied 0 on both sides; the reference selects
    its old state, the port writes nothing: params, m, v and both step
    counters keep their bits."""
    _, jstate, jrun = ref_step({}, model_cls=_JNanModel)
    (batch,) = batches(1)
    jnew, jm = jrun(jstate, batch)
    assert int(jm["applied"]) == 0
    for a, b in zip(jax.tree_util.tree_leaves(jnew),
                    jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    model, state, step = port({}, jstate, model_cls=_NanModel)
    good = next(iter(batches(1)))
    before = clone(state)
    state, m = step(state, good)
    assert m["applied"] == 0 and not np.isfinite(m["loss"])
    assert_bitwise(state, before)
    assert int(state["step"]) == 0 and int(state["opt"]["step"]) == 0
    state, m = step(state, good)                   # the next call is good
    assert m["applied"] == 1 and int(state["step"]) == 1


def test_make_train_state_and_unported_mesh():
    cfg = ModelConfig(**tiny())
    model = Model(cfg)
    st = tstep.make_train_state(model, torch.Generator().manual_seed(0),
                                device="cpu")
    assert all(p.requires_grad for _, p in adamw.leaves(st["params"]))
    assert int(st["step"]) == 0 and st["step"].dtype == torch.int32
    assert all(m.dtype == torch.float32 and not m.any()
               for _, m in adamw.leaves(st["opt"]["m"]))
    # the rules' placement of the state (training on the data axes):
    # every leaf a spec; a mesh whose model axis has size > 1 is tensor /
    # sequence parallelism: the step runs there on two gloo ranks, each
    # holding its heads and its vocab rows; on a model axis that does not
    # divide the heads the attention runs whole on every rank
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 1})
    specs = tstep.state_specs(st, mesh, cfg)
    assert specs["step"] == () and specs["opt"]["step"] == ()
    assert specs["params"]["blocks"][0]["attn"]["wq"] == (None, "model")
    assert specs["opt"]["m"] == specs["params"] == specs["opt"]["v"]

    import _tp_train_ranks
    from repro_torch.testing import ranks
    for m, wq, embed in ranks.spawn(_tp_train_ranks.rank_work_step, 2,
                                    args=(tiny(),), timeout=300):
        assert m["applied"] == 1 and np.isfinite(m["loss"])
        assert wq == (32, 16) and embed == (32, 32)

    class ModelAxis:
        shape = {"data": 1, "model": 3}
    from repro_torch.sharding import collectives
    assert collectives.check_model_axis(cfg, ModelAxis()) is False


@pytest.mark.parametrize("step", [0, 1, 4, 5, 6, 13, 19, 20, 31])
def test_cosine_schedule_equals_the_reference(step):
    kw = dict(base_lr=3e-4, warmup=5, total=20)
    want = jadamw.cosine_schedule(jnp.asarray(step, jnp.int32), **kw)
    got = adamw.cosine_schedule(torch.tensor(step, dtype=torch.int32), **kw)
    assert got.item() == float(want)


# ---- data ---------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(vocab=64, seq_len=16, global_batch=4),
                                dict(vocab=151936, seq_len=33,
                                     global_batch=6, seed=3),
                                dict(vocab=50, seq_len=8, global_batch=2,
                                     n_codebooks=4)])
def test_synthetic_lm_batches_are_the_references_bit_for_bit(kw):
    a, b = pipe.SyntheticLM(pipe.DataConfig(**kw)), \
        jpipe.SyntheticLM(jpipe.DataConfig(**kw))
    for s in (0, 1, 7):
        for k, v in a.global_batch_at(s).items():
            np.testing.assert_array_equal(v, b.global_batch_at(s)[k])
    shards = kw["global_batch"] // 2
    got = a.shard_at(3, 1, 2)
    for k, v in b.shard_at(3, 1, 2).items():
        np.testing.assert_array_equal(got[k], v)
        assert got[k].shape[0] == shards
    it_a, it_b = a.iterator(pipe.DataState(5)), b.iterator(jpipe.DataState(5))
    (ba, sa), (bb, sb) = next(it_a), next(it_b)
    assert sa.to_dict() == sb.to_dict() == {"step": 6}
    np.testing.assert_array_equal(ba["tokens"], bb["tokens"])


# ---- the train loop (the reference's TestTraining, ported) -------------------

def test_train_loop_loss_decreases(tmp_path):
    _, jstate, _ = ref_step({}, steps=60)
    _, state, step = port({}, jstate, steps=60)
    losses = []
    loop = ft.TrainLoop(step, CheckpointManager(str(tmp_path)), data(),
                        ckpt_every=1000)
    loop.run(state, num_steps=60,
             on_metrics=lambda s, m: losses.append(m["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.2, \
        f"not learning: {losses[:3]} -> {losses[-3:]}"


def test_train_loop_resume_bit_exact(tmp_path):
    """20 straight steps == 10 steps + checkpoint + restore + 10 steps."""
    _, jstate, _ = ref_step({}, steps=20)
    _, state0, step = port({}, jstate, steps=20)
    mgr_a = CheckpointManager(str(tmp_path / "a"), async_save=False)
    state_a = ft.TrainLoop(step, mgr_a, data(), ckpt_every=1000).run(
        clone(state0), num_steps=20)
    mgr_b = CheckpointManager(str(tmp_path / "b"), async_save=False)
    ft.TrainLoop(step, mgr_b, data(), ckpt_every=10).run(clone(state0),
                                                          num_steps=10)
    assert mgr_b.all_steps() == [10]
    state_b = ft.TrainLoop(step, mgr_b, data(), ckpt_every=10).run(
        clone(state0), num_steps=20)        # auto-restores step 10
    assert_bitwise(state_a, state_b)


def test_train_loop_counts_a_nan_step_skipped(tmp_path):
    _, jstate, _ = ref_step({})
    _, state, step = port({}, jstate)
    calls = {"n": 0}

    def poisoned(state, batch):
        calls["n"] += 1
        new_state, m = step(state, batch)
        if calls["n"] == 3:
            m = dict(m, loss=float("nan"))
        return new_state, m
    loop = ft.TrainLoop(poisoned, CheckpointManager(str(tmp_path)), data(),
                        ckpt_every=1000)
    loop.run(state, num_steps=6)
    assert loop.skipped_steps == 1


def test_train_loop_nan_model_skips_the_update(tmp_path):
    """The guard inside the step: the third call's NaN loss leaves the
    state as the second step left it; the loop counts one skipped step."""
    _, jstate, _ = ref_step({})
    model, state, step = port({}, jstate, model_cls=_NanModel)
    model.nan_on = 3
    snaps = {}

    def watched(st, batch):
        if model.calls == 2:
            snaps["before"] = clone(st)
        new, m = step(st, batch)
        if model.calls == 3:
            snaps["after"], snaps["m"] = clone(new), m
        return new, m
    loop = ft.TrainLoop(watched, CheckpointManager(str(tmp_path)), data(),
                        ckpt_every=1000)
    final = loop.run(state, num_steps=5)
    assert loop.skipped_steps == 1 and snaps["m"]["applied"] == 0
    assert_bitwise(snaps["after"], snaps["before"])
    assert int(final["step"]) == 4


def test_train_loop_retries_from_the_checkpoint(tmp_path):
    """An exception in a step restores the newest checkpoint and replays
    from its data state; past max_retries it propagates."""
    _, jstate, _ = ref_step({})
    _, state0, step = port({}, jstate)
    boom = {"n": 0}

    def flaky(st, batch):
        boom["n"] += 1
        if boom["n"] == 5:
            raise RuntimeError("injected")
        return step(st, batch)
    mgr = CheckpointManager(str(tmp_path / "r"), async_save=False)
    got = ft.TrainLoop(flaky, mgr, data(), ckpt_every=2).run(
        clone(state0), num_steps=6)
    want = ft.TrainLoop(step, CheckpointManager(str(tmp_path / "s")),
                        data(), ckpt_every=1000).run(clone(state0),
                                                     num_steps=6)
    assert_bitwise(got, want)

    def broken(st, batch):
        raise RuntimeError("always")
    with pytest.raises(RuntimeError, match="always"):
        ft.TrainLoop(broken, CheckpointManager(str(tmp_path / "x")), data(),
                     max_retries=2).run(clone(state0), num_steps=3)


@pytest.mark.parametrize("checkpoint", [False, True])
def test_train_loop_fault_inside_the_update(tmp_path, monkeypatch,
                                            checkpoint):
    """An exception planted inside ``adamw.update`` (its 3rd leaf of the
    5th step) leaves the in-place state partly written, ``opt.step``
    already counted.  With no checkpoint the loop re-raises it as
    ``PartialUpdateError`` at once, without a retry on that state; with
    one (every 2 steps) it restores step 4 and ends bitwise where a run
    without the fault ends."""
    _, jstate, _ = ref_step({})
    _, state0, step = port({}, jstate)
    want = ft.TrainLoop(step, CheckpointManager(str(tmp_path / "s")),
                        data(), ckpt_every=1000).run(clone(state0),
                                                     num_steps=6)
    calls = {"step": 0, "apply": 0}
    apply = adamw._apply

    def faulty_apply(*args, **kw):
        if calls["step"] == 5:
            calls["apply"] += 1
            if calls["apply"] == 3:
                raise RuntimeError("planted")
        return apply(*args, **kw)
    monkeypatch.setattr(adamw, "_apply", faulty_apply)

    def counted(st, batch):
        calls["step"] += 1
        return step(st, batch)
    mgr = CheckpointManager(str(tmp_path / "r"), async_save=False)
    loop = ft.TrainLoop(counted, mgr, data(),
                        ckpt_every=2 if checkpoint else 1000)
    state = clone(state0)
    if not checkpoint:
        with pytest.raises(ft.PartialUpdateError, match="planted") as info:
            loop.run(state, num_steps=6)
        assert isinstance(info.value.__cause__, RuntimeError)
        assert calls["step"] == 5            # no retry on the torn state
        assert int(state["opt"]["step"]) == 5 and int(state["step"]) == 4
        return
    got = loop.run(state, num_steps=6)
    assert calls["step"] == 7                # 1-5, then 5 and 6 again
    assert_bitwise(got, want)


# ---- checkpoints --------------------------------------------------------------

def _mgr(tmp_path, **kw):
    return CheckpointManager(str(tmp_path / "ckpt"),
                             **{"keep": 5, "async_save": False, **kw})


def test_corrupt_manifest_falls_back_to_older_step(tmp_path):
    mgr = _mgr(tmp_path)
    state = {"w": torch.arange(4, dtype=torch.float32)}
    mgr.save(1, state, extra={"tokens": 10})
    mgr.save(2, {"w": torch.arange(4, dtype=torch.float32) * 2},
             extra={"tokens": 20})
    manifest = os.path.join(mgr.dir, "step_0000000002", "manifest.json")
    faults.corrupt_json_file(manifest, "garbage")
    step, restored, extra = mgr.restore_latest(state)
    assert step == 1 and extra == {"tokens": 10}
    assert torch.equal(restored["w"], torch.arange(4, dtype=torch.float32))
    assert os.path.isdir(manifest + ".quarantine")     # kept, not deleted
    assert mgr.all_steps() == [1]


def test_stale_checksum_detected(tmp_path):
    mgr = _mgr(tmp_path)
    state = {"w": torch.zeros(2)}
    mgr.save(1, state)
    manifest = os.path.join(mgr.dir, "step_0000000001", "manifest.json")
    faults.corrupt_json_file(manifest, "stale")
    assert mgr.restore_latest(state) is None


def test_train_state_roundtrip_async_and_retention(tmp_path):
    """A full train state (bf16 params, 8-bit moments) through an async
    save and a restore: every leaf bitwise, dtypes, devices and grad flags
    the template's; ``keep`` retains the newest steps."""
    cfg = ModelConfig(**tiny(dtype="bfloat16", opt_8bit=True))
    model = Model(cfg)
    state = tstep.make_train_state(model, torch.Generator().manual_seed(1),
                                   use_8bit=True, device="cpu")
    step = tstep.make_train_step(model, base_lr=1e-2, warmup=1)
    for batch in batches(2):
        state, _ = step(state, batch)
    mgr = _mgr(tmp_path, keep=2, async_save=True)
    for s in (1, 2, 3):
        mgr.save(s, state, extra={"data_state": {"step": s}})
    mgr.wait()
    assert mgr.all_steps() == [2, 3]
    template = tstep.make_train_state(model, torch.Generator().manual_seed(9),
                                      use_8bit=True, device="cpu")
    step_n, restored, extra = mgr.restore_latest(template)
    assert step_n == 3 and extra == {"data_state": {"step": 3}}
    assert_bitwise(restored, state)
    for (_, a), (_, b) in zip(adamw.leaves(restored), adamw.leaves(state)):
        for x, y in (zip(a, b) if isinstance(a, adamw.QTensor) else [(a, b)]):
            assert x.dtype == y.dtype and x.requires_grad == y.requires_grad
    assert "params/blocks/1/attn/wq" in np.load(
        os.path.join(mgr.dir, "step_0000000003", "arrays.npz")).files


@pytest.mark.parametrize("use_8bit", [False, True], ids=["fp32", "8bit"])
def test_async_save_holds_the_step_it_was_given(tmp_path, monkeypatch,
                                                use_8bit):
    """An async save of a CPU state, whose write is held back until the
    train thread has updated every leaf in place (fp32 params and moments,
    8-bit payloads and scales, the int32 counters), restores the saved
    step bitwise: the host copy is taken at ``save``, not aliased."""
    import repro_torch.ckpt.manager as manager
    cfg = ModelConfig(**tiny(opt_8bit=use_8bit))
    model = Model(cfg)
    state = tstep.make_train_state(model, torch.Generator().manual_seed(1),
                                   use_8bit=use_8bit, device="cpu")
    step = tstep.make_train_step(model, base_lr=1e-2, warmup=1)
    for batch in batches(2):
        state, _ = step(state, batch)
    saved = clone(state)
    go, savez = threading.Event(), manager.np.savez

    def held(*args, **kw):
        assert go.wait(timeout=60)
        return savez(*args, **kw)
    monkeypatch.setattr(manager.np, "savez", held)
    mgr = _mgr(tmp_path, async_save=True)
    kinds = set()
    try:
        mgr.save(4, state)
        with torch.no_grad():
            for _, leaf in adamw.leaves(state):
                for t in (leaf if isinstance(leaf, adamw.QTensor)
                          else [leaf]):
                    t.add_(1)
                    kinds.add(t.dtype)
    finally:
        go.set()
        mgr.wait()
    assert kinds == {torch.float32, torch.int32} | (
        {torch.int8} if use_8bit else set())
    _, restored, _ = mgr.restore_latest(clone(saved))
    assert_bitwise(restored, saved)


def test_checkpoint_of_the_reference_state_restores_into_the_port(tmp_path):
    """The same numbers either way: the reference's state converted to the
    port's layout, saved and restored, equals the conversion."""
    _, jstate, _ = ref_step({})
    cfg = ModelConfig(**tiny())
    state = to_port(cfg, jstate)
    mgr = _mgr(tmp_path)
    mgr.save(7, state)
    _, restored, _ = mgr.restore_latest(clone(state))
    assert_bitwise(restored, state)
    jmgr = JCheckpointManager(str(tmp_path / "jax"), async_save=False)
    jmgr.save(7, jstate)
    jstep_n, jrestored, _ = jmgr.restore_latest(jstate)
    assert jstep_n == 7
    assert_bitwise(to_port(cfg, jrestored), state)


# ---- the launcher ------------------------------------------------------------

def test_launch_train_smoke_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-4b", "--smoke", "--device", "cpu", "--steps", "3",
         "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
         "--ckpt-every", "2", "--log-every", "1"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "step=3 loss=" in r.stderr and "done: 3 steps (skipped=0)" in \
        r.stderr, r.stderr
    assert os.path.isdir(tmp_path / "step_0000000002")
