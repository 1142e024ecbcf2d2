"""The recurrent families in the port (ssm: rwkv6, hybrid: zamba2's
mamba2 backbone with its shared attention) on the CPU, held against the
reference.

  * Both configs (``rwkv6_1_6b``, ``zamba2_2_7b``) equal the reference's.
  * ``rwkv6.time_mix`` / ``channel_mix`` and ``mamba2.forward`` alone,
    fresh and from a carried state.
  * Each family at its smoke size in fp32, the reference's params carried
    into the port by ``models.convert``: forward logits, the loss, every
    gradient, prefill (right-padded) and one decode step, and the caches
    they leave; a right-padded prefill's state does not depend on what
    the padding holds (bitwise) and is the unpadded state.
  * The static, continuous (a prompt of 21 prefilled in chunks of 8) and
    paged engines, token-identical (greedy) to the reference's same
    engine; continuous equal to static and paged equal to dense.
  * The rules' specs of every train-state leaf and ``launch.dryrun.
    reckon`` for both full configs, against the reference.
  * The train step: the reference's jitted one-device step (a 1 x 1
    mesh) from its initial state, two steps, holds the port's one-device
    step, and on two gloo ranks (``tests/_recurrent_ranks.py``) the DP and
    FSDP steps, for both families and for zamba2 with 8-bit moments (one
    scale over a (group, layer) stack); each rank's state bytes against
    ``local_bytes``; ``ShardedEngine`` with rwkv6 through one host loss
    (the model axis: ``tests/test_torch_recurrent_tp.py``).

Tolerances (fp32): logits and decode logits 1e-4 absolute, caches 1e-5
absolute, the loss 1e-6 relative, gradients 1e-4 relative plus 1e-5 of
the leaf's largest magnitude (those of ``tests/test_torch_families.py``);
the train steps as ``tests/test_torch_tp_train.py``'s: loss and grad
norm 1e-5 relative, each leaf 2e-5 of its largest magnitude, params also
2 % of the leaf's largest update (AdamW's update is O(lr) however small
the gradient: rwkv6's ``w_lora_b``, zero at init, is all update, and one
element whose gradient is 2e-3 of the leaf's largest parts from the
reference by 1.3e-4 of the update, 1.5 x the leaf bound), and elements
whose reference first moment is under 1e-5 of the leaf's largest twice
the update; 8-bit payloads within one quantization step, scales 1e-5
relative, params 3 % of the reference's update on the elements whose
payloads agree (``tests/test_torch_sharded_train.py``)."""
import dataclasses
import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _recurrent_ranks as R
from repro.configs import config as jconfig
from repro.configs import smoke_config as jsmoke
from repro.launch import specs as jspecs
from repro.models import mamba2 as jmamba
from repro.models import rwkv6 as jrwkv
from repro.models.transformer import Model as JModel
from repro.serve.engine import BatchedEngine as JBatched
from repro.serve.engine import ContinuousEngine as JContinuous
from repro.serve.engine import Request as JRequest
from repro.sharding import rules as jrules
from repro.train import step as jstep
from repro_torch.configs import ALIASES, ARCH_IDS, config, smoke_config
from repro_torch.data import pipeline as pipe
from repro_torch.launch import dryrun
from repro_torch.models import mamba2, rwkv6
from repro_torch.models.convert import (params_from_numpy,
                                        train_state_from_numpy)
from repro_torch.models.transformer import Model
from repro_torch.optim import adamw
from repro_torch.serve.engine import BatchedEngine, ContinuousEngine, Request
from repro_torch.testing import ranks
from repro_torch.train import step as tstep
from test_torch_sharded_train import (LEAF_TOL, LOSS_RTOL,
                                      _assert_leaves_close)
from test_torch_tp_train import _assert_close

ARCHS = ["rwkv6_1_6b", "zamba2_2_7b"]
TOL = 1e-4
ENGINE = dict(max_seq=48, slots=2, chunk=4, min_bucket=8, prefill_chunk=8)
LENGTHS, MAX_NEW = (7, 21, 3, 12), (5, 3, 6, 4)


_PAIRS = {}


def _pair(arch):
    """(reference model, its params, port model, port params)."""
    if arch not in _PAIRS:
        jm = JModel(jsmoke(arch))
        jp = jm.init_params(jax.random.PRNGKey(0))
        cfg = smoke_config(arch)
        _PAIRS[arch] = (jm, jp, Model(cfg), params_from_numpy(
            cfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu"))
    return _PAIRS[arch]


def _tokens(cfg, shape, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab, shape)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=tol)


def _close_tree(got, want, tol=1e-5):
    """A port cache (NamedTuples, dicts) against the reference's."""
    g = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.detach().numpy(), got))
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=tol)


def test_configs_are_the_references():
    for arch in ARCHS:
        assert arch in ARCH_IDS
        assert dataclasses.asdict(config(arch)) == \
            dataclasses.asdict(jconfig(arch))
        assert dataclasses.asdict(smoke_config(arch)) == \
            dataclasses.asdict(jsmoke(arch))
    assert ALIASES["rwkv6-1.6b"] == "rwkv6_1_6b"
    assert config("zamba2-2.7b") == config("zamba2_2_7b")
    for arch in ARCHS:
        assert config(arch).param_count() == jconfig(arch).param_count()
        assert config(arch).subquadratic and \
            config(arch).attn_free == jconfig(arch).attn_free


# ---------------------------------------------------------------------------
# the mixers alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_rwkv6_mixers_alone(carried):
    """``time_mix`` and ``channel_mix`` of one layer on (2, 9, d), from a
    zero state or a random carried one, with ``u`` nonzero (the reference
    draws it zero) and a right-padded second row."""
    jcfg, cfg = jsmoke("rwkv6_1_6b"), smoke_config("rwkv6_1_6b")
    rng = np.random.RandomState(3)
    jp = jrwkv.init_rwkv6(jax.random.PRNGKey(1), jcfg)
    jp = jp._replace(u=jnp.asarray(0.3 * rng.randn(*jp.u.shape),
                                   jnp.float32))
    p = {k: torch.tensor(np.asarray(v)) for k, v in jp._asdict().items()}
    x = rng.randn(2, 9, cfg.d_model).astype(np.float32)
    lengths = np.array([9, 6])
    jst = st = None
    if carried:
        nh = rwkv6.nheads(cfg)
        arrs = (rng.randn(2, cfg.d_model), rng.randn(2, cfg.d_model),
                0.2 * rng.randn(2, nh, 64, 64))
        arrs = [a.astype(np.float32) for a in arrs]
        jst = jrwkv.Rwkv6State(*map(jnp.asarray, arrs))
        st = rwkv6.Rwkv6State(*map(torch.tensor, arrs))
    for ln in (None, lengths):
        jl = None if ln is None else jnp.asarray(ln)
        tl = None if ln is None else torch.tensor(ln)
        wy, wt, ws = jrwkv.time_mix(jp, jcfg, jnp.asarray(x), jst,
                                    lengths=jl)
        gy, gt, gs = rwkv6.time_mix(p, cfg, torch.tensor(x), st, lengths=tl)
        _close(gy, wy, 1e-5)
        _close(gt, wt, 0)
        _close(gs, ws, 1e-5)
        wy, wc = jrwkv.channel_mix(jp, jcfg, jnp.asarray(x), jst, lengths=jl)
        gy, gc = rwkv6.channel_mix(p, cfg, torch.tensor(x), st, lengths=tl)
        _close(gy, wy, 1e-5)
        _close(gc, wc, 0)


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_mamba2_forward_alone(carried):
    """``mamba2.forward`` of one layer on (2, 9, d) with nonzero decay and
    dt bias, from a zero or a random carried state, unpadded and with the
    second row right-padded (the conv tail taken at its real end)."""
    jcfg, cfg = jsmoke("zamba2_2_7b"), smoke_config("zamba2_2_7b")
    rng = np.random.RandomState(4)
    jp = jmamba.init_mamba2(jax.random.PRNGKey(2), jcfg)
    nh = jp.a_log.shape[0]
    jp = jp._replace(
        a_log=jnp.asarray(0.5 * rng.randn(nh), jnp.float32),
        dt_bias=jnp.asarray(0.5 * rng.randn(nh), jnp.float32))
    p = {k: torch.tensor(np.asarray(v)) for k, v in jp._asdict().items()}
    x = rng.randn(2, 9, cfg.d_model).astype(np.float32)
    jst = st = None
    if carried:
        din, nheads, n = mamba2.dims(cfg)
        arrs = [rng.randn(2, 3, din + 2 * n).astype(np.float32),
                (0.2 * rng.randn(2, nheads, 64, n)).astype(np.float32)]
        jst = jmamba.Mamba2State(*map(jnp.asarray, arrs))
        st = mamba2.Mamba2State(*map(torch.tensor, arrs))
    for ln in (None, np.array([9, 5])):
        wy, ws = jmamba.forward(jp, jcfg, jnp.asarray(x), jst,
                                lengths=None if ln is None
                                else jnp.asarray(ln))
        gy, gs = mamba2.forward(p, cfg, torch.tensor(x), st,
                                lengths=None if ln is None
                                else torch.tensor(ln))
        _close(gy, wy, 1e-5)
        _close(gs.conv, ws.conv, 0)
        _close(gs.ssm, ws.ssm, 1e-5)


# ---------------------------------------------------------------------------
# the families through Model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match(arch):
    jm, jp, model, params = _pair(arch)
    toks = _tokens(model.cfg, (2, 12), 0)
    got = model.forward(params, torch.tensor(toks))
    assert got.shape == (2, 12, model.cfg.vocab)
    _close(got, jm.forward(jp, jnp.asarray(toks)))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match(arch):
    """The loss and the gradient of every leaf, with remat (each rwkv6
    layer, each hybrid group recomputed in the backward), the reference's
    gradients carried into the port's layout."""
    jm, jp, model, params = _pair(arch)
    assert model.cfg.remat
    rng = np.random.RandomState(1)
    labels = rng.randint(0, model.cfg.vocab, (2, 12))
    labels[0, :3] = -100
    batch = {"tokens": _tokens(model.cfg, (2, 12), 0), "labels": labels}
    want, jgrads = jax.value_and_grad(jm.loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = adamw.leaves(params)
    flat = [p.detach().clone().requires_grad_(True) for _, p in leaves]
    got = model.loss(adamw.unflatten(params, flat),
                     {k: torch.tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    grads = torch.autograd.grad(got, flat)
    want_g = params_from_numpy(model.cfg, jax.tree_util.tree_map(
        np.asarray, jgrads), device="cpu")
    assert len(adamw.leaves(want_g)) == len(leaves)
    for (path, _), g, (_, w) in zip(leaves, grads, adamw.leaves(want_g)):
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=1e-4,
            atol=1e-5 * max(float(w.abs().max()), 1e-30), err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match(arch):
    """A right-padded prefill (lengths 12 and 9), then one decode step at
    each row's own position: logits and the whole cache against the
    reference's."""
    jm, jp, model, params = _pair(arch)
    toks = _tokens(model.cfg, (2, 12), 3)
    lengths = np.array([12, 9])
    jcache = jm.init_cache(2, 32)
    want, jcache = jm.prefill(jp, jnp.asarray(toks), jcache,
                              lengths=jnp.asarray(lengths))
    cache = model.init_cache(2, 32, device="cpu")
    with torch.no_grad():
        got, out = model.prefill(params, torch.tensor(toks), cache,
                                 lengths=torch.tensor(lengths))
    assert out is cache
    _close(got, want)
    _close_tree(cache, jcache)
    nxt = np.asarray(want).argmax(-1)[:, None]
    want, jcache = jm.decode_step(jp, jnp.asarray(nxt), jcache,
                                  jnp.asarray(lengths))
    with torch.no_grad():
        got, _ = model.decode_step(params, torch.tensor(nxt), cache,
                                   torch.tensor(lengths))
    _close(got, want)
    _close_tree(cache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_prefill_leaves_the_unpadded_state(arch):
    """Row 1 right-padded from 7 to 12 tokens: its recurrent state and
    logits do not depend on what the padding holds (bitwise: the
    padding's state updates are masked off), and equal those of its 7
    tokens alone (1e-5 relative, 1e-6 absolute: the products at another
    batch shape may round otherwise); the reference's padded state
    agrees."""
    jm, jp, model, params = _pair(arch)
    toks = _tokens(model.cfg, (2, 12), 5)
    other = toks.copy()
    other[1, 7:] = _tokens(model.cfg, (5,), 6)

    def state(cache):
        return jax.tree_util.tree_leaves(model.split_paged_cache(cache)[1])

    def run(t, lengths):
        cache = model.init_cache(t.shape[0], 32, device="cpu")
        with torch.no_grad():
            logits, _ = model.prefill(
                params, torch.tensor(t), cache,
                lengths=None if lengths is None else torch.tensor(lengths))
        return logits, cache
    lp, padded = run(toks, [12, 7])
    lo, padded_other = run(other, [12, 7])
    la, alone = run(toks[1:, :7], None)
    assert torch.equal(lp, lo)
    for big, big2, one in zip(state(padded), state(padded_other),
                              state(alone)):
        axis = next(i for i, (a, b) in enumerate(zip(big.shape, one.shape))
                    if a != b)
        assert torch.equal(big, big2)
        np.testing.assert_allclose(big.select(axis, 1).numpy(),
                                   one.select(axis, 0).numpy(), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(lp[1].numpy(), la[0].numpy(), rtol=1e-5,
                               atol=1e-6)
    jcache = jm.init_cache(2, 32)
    _, jcache = jm.prefill(jp, jnp.asarray(toks), jcache,
                           lengths=jnp.asarray([12, 7]))
    jstate = jcache if arch == "rwkv6_1_6b" else jcache["mamba"]
    for got, want in zip(state(padded), jax.tree_util.tree_leaves(jstate)):
        _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

_ENGINE_RUNS = {}


def _engine_run(arch, kind):
    """Greedy tokens of (reference, port) for one engine kind."""
    key = (arch, kind)
    if key not in _ENGINE_RUNS:
        jm, jp, model, params = _pair(arch)
        prompts = [_tokens(model.cfg, (n,), 20 + i)
                   for i, n in enumerate(LENGTHS)]
        if kind == "static":
            jeng = JBatched(jm, jp, max_seq=ENGINE["max_seq"], chunk=4)
            eng = BatchedEngine(model, params, max_seq=ENGINE["max_seq"],
                                chunk=4)
        else:
            jeng = JContinuous(jm, jp, kv_layout=kind, **ENGINE)
            eng = ContinuousEngine(model, params, kv_layout=kind, **ENGINE)
        want = jeng.run([JRequest(prompt=jnp.asarray(p), max_new_tokens=n)
                         for p, n in zip(prompts, MAX_NEW)])
        got = eng.run([Request(p.tolist(), max_new_tokens=n)
                       for p, n in zip(prompts, MAX_NEW)])
        _ENGINE_RUNS[key] = ([list(map(int, o)) for o in want], got)
    return _ENGINE_RUNS[key]


@pytest.mark.parametrize("kind", ["static", "dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engines_token_identical_to_the_reference(arch, kind):
    """Four requests, one prompt of 21 prefilled in chunks of 8 by the
    continuous engines (the recurrent state carried from chunk to chunk
    in the staging state), each against the reference's same engine."""
    want, got = _engine_run(arch, kind)
    assert got == want
    assert [len(o) for o in got] == list(MAX_NEW)


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_equals_static_and_paged_equals_dense(arch):
    _, static = _engine_run(arch, "static")
    _, dense = _engine_run(arch, "dense")
    _, paged = _engine_run(arch, "paged")
    assert dense == static
    assert paged == dense


# ---------------------------------------------------------------------------
# the rules and the dry run
# ---------------------------------------------------------------------------

def _ref_bytes(tree, specs, mesh) -> int:
    leaves = jax.tree_util.tree_leaves(tree)
    specs = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
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


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_reckon_equals_the_reference_specs(arch, shape, multi):
    """A rank's argument bytes at the production meshes: the reference's
    specs x shapes, leaf by leaf (long_500k applies: both families are
    sub-quadratic)."""
    mesh = dryrun.MESHES["multi" if multi else "single"]
    rec = dryrun.lower_cell(arch, shape, multi)
    jcfg = jconfig(arch)
    duck = types.SimpleNamespace(shape=dict(mesh))
    model = jspecs.model_for(jcfg, shape)
    data, data_spec = jspecs.input_specs(jcfg, shape, duck)
    want = _ref_bytes(data, data_spec, mesh)
    if shape == "train_4k":
        st = jspecs.train_state_sds(model)
        want += _ref_bytes(st, jstep.state_specs(st, duck, model.cfg), mesh)
    else:
        params = jspecs.params_sds(model)
        cache = jspecs.cache_sds(model, shape)
        want += _ref_bytes(params, jrules.params_specs(params, duck,
                                                       model.cfg), mesh)
        want += _ref_bytes(cache, jrules.cache_specs(model.cfg, duck,
                                                     cache), mesh)
    assert rec["status"] == "ok"
    assert rec["memory"]["argument_bytes"] == want
    assert rec["chips"] == math.prod(mesh.values())
    assert rec["params"] == jcfg.param_count()


@functools.lru_cache(maxsize=None)
def _ref_state(arch):
    jcfg = jconfig(arch)
    return jax.eval_shape(lambda k: jstep.make_train_state(JModel(jcfg), k),
                          jax.random.PRNGKey(0))


@pytest.mark.parametrize("fsdp", [False, True], ids=["dp", "fsdp"])
@pytest.mark.parametrize("mesh", [{"data": 2, "model": 2},
                                  {"data": 16, "model": 16}],
                         ids=["2x2", "16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_specs_equal_the_reference(arch, mesh, fsdp):
    """Every leaf of the full-width train state: the port's spec is the
    reference's without its stacked dims (one for rwkv6's blocks, two for
    the hybrid's mamba stacks, none for its shared block)."""
    cfg = config(arch, fsdp=fsdp)
    jcfg = dataclasses.replace(jconfig(arch), fsdp=fsdp)
    duck = types.SimpleNamespace(shape=dict(mesh))
    want = jstep.state_specs(_ref_state(arch), duck, jcfg)
    state = tstep.make_train_state(Model(cfg), torch.Generator(),
                                   device="meta")
    got = tstep.state_specs(state, duck, cfg)

    def ref_leaf(tree, path):
        for k in path:
            if isinstance(k, int):
                continue
            tree = tree[k] if isinstance(tree, dict) else getattr(tree, k)
        return tree
    n = 0
    for part in (("params",), ("opt", "m"), ("opt", "v")):
        port = got
        for k in part:
            port = port[k]
        for path, spec in adamw.leaves(port):
            w = tuple(ref_leaf(ref_leaf(want, part), path))
            lead = 0
            if path[0] == "blocks":
                key = str(path[1])
                lead = (0 if key.startswith("shared") else
                        2 if key.startswith("mamba") else 1)
            assert w[:lead] == (None,) * lead, (path, w)
            assert tuple(spec) == w[lead:], (part, path, tuple(spec), w)
            n += 1
    assert n == 3 * len(adamw.leaves(state["params"]))


# ---------------------------------------------------------------------------
# on two gloo ranks
# ---------------------------------------------------------------------------

def _ref_numpy(tree):
    """The reference's tree as numpy in plain dicts (its NamedTuples as
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


# the train cases: (arch, config overrides); the 8-bit hybrid holds one
# scale over a (group, layer) stack's G x E members and decays its
# (G, E, d) norms, as the reference's layout says
TRAIN = {"rwkv6_1_6b": ("rwkv6_1_6b", {}),
         "zamba2_2_7b": ("zamba2_2_7b", {}),
         "zamba2_2_7b_8bit": ("zamba2_2_7b", {"opt_8bit": True})}


def _ref_steps(arch, cfg_kw, batches):
    """The reference's jitted one-device step (a 1 x 1 mesh) from its
    initial state: (initial state, per step (metrics, state)), the states
    as numpy."""
    from repro.sharding import ctx as jctx
    jcfg = dataclasses.replace(jsmoke(arch), **cfg_kw)
    model = JModel(jcfg)
    state = jstep.make_train_state(model, jax.random.PRNGKey(0),
                                   use_8bit=jcfg.opt_8bit)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    prev = jctx.get_mesh()
    try:
        _, jit_with, _ = jstep.make_train_step(model, mesh, donate=False,
                                               **R.STEP)
        run = jit_with(jstep.state_specs(state, mesh, jcfg))
        out, st = [], state
        for b in batches:
            st, m = run(st, {k: jnp.asarray(v) for k, v in b.items()})
            out.append(({k: float(v) for k, v in m.items()},
                        _ref_numpy(st)))
    finally:
        jctx.set_mesh(prev)
    return _ref_numpy(state), out


def _port_np(arch, cfg_kw, np_state):
    """A numpy state of the reference in the port's layout, as ``(path,
    array)``."""
    cfg = smoke_config(arch, **cfg_kw)
    return R.numpy_state(train_state_from_numpy(cfg, np_state,
                                                device="cpu"))


@pytest.fixture(scope="module")
def sharded():
    """(what the parent computed, each rank's results)."""
    it = pipe.SyntheticLM(pipe.DataConfig(vocab=256, seq_len=16,
                                          global_batch=4)).iterator()
    batches = [next(it)[0] for _ in range(2)]
    train, one, want = {}, {}, {}
    for case, (arch, cfg_kw) in TRAIN.items():
        state0, steps = _ref_steps(arch, cfg_kw, batches)
        train[case] = (arch, cfg_kw, state0, batches)
        # per step (metrics, state before, state after), the port's layout
        states = [_port_np(arch, cfg_kw, st)
                  for st in [state0] + [st for _, st in steps]]
        want[case] = [(m, states[i], states[i + 1])
                      for i, (m, _) in enumerate(steps)]
        one[case] = R.one_device_steps(arch, state0, batches, **cfg_kw)
    jm, jp, _, _ = _pair("rwkv6_1_6b")
    jeng = JContinuous(jm, jp, **R.ENGINE)
    tokens = jeng.run([JRequest(prompt=jnp.asarray(p),
                                max_new_tokens=R.MAX_NEW)
                       for p in R.prompts(jm.cfg.vocab)])
    ref = {"train": train,
           "engine": jax.tree_util.tree_map(np.asarray, jp)}
    out = ranks.spawn(R.rank_work, 2, args=(ref, None), timeout=300)
    return {"one": one, "want": want,
            "tokens": [list(map(int, o)) for o in tokens]}, out


def _check_steps(run, want, eight_bit=False):
    """Every step of ``run`` (per step (metrics, port numpy state))
    against the reference's, at ``test_torch_tp_train.py``'s tolerances
    (module docstring)."""
    assert len(run) == len(want)
    for (m, got), (wm, before, after) in zip(run, want):
        assert m["applied"] == int(wm["applied"]) == 1
        assert m["lr"] == wm["lr"]
        np.testing.assert_allclose(m["loss"], wm["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(m["grad_norm"], wm["grad_norm"],
                                   rtol=LOSS_RTOL)
        if eight_bit:
            _assert_leaves_close(got, after, LEAF_TOL, eight_bit, before)
        else:
            _assert_close(got, after, before, LEAF_TOL)


@pytest.mark.parametrize("case", list(TRAIN))
def test_one_device_step_matches_the_reference(sharded, case):
    """Two steps of the port's one-device step from the reference's
    initial state: metrics and every leaf of the state (params, moments,
    8-bit payloads and scales) against the reference's jitted step."""
    parent, _ = sharded
    _check_steps(parent["one"][case], parent["want"][case],
                 eight_bit=case.endswith("_8bit"))
    if case.endswith("_8bit"):
        # one scale a stacked leaf: the G x E members of a hybrid stack
        state = dict(parent["one"][case][-1][1])
        for part in ("m", "v"):
            scales = [a for p, a in state.items()
                      if p[:4] == ("opt", part, "blocks", "mamba_ln")
                      and p[-1] == "scale"]
            cfg = smoke_config("zamba2_2_7b")
            assert len(scales) == cfg.n_layers
            assert all(np.array_equal(s, scales[0]) for s in scales)


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_two_ranks_match_the_one_device_step(sharded, arch, mode):
    """Two steps on data=2 from the reference's initial state: metrics and
    every leaf of the gathered state against the reference's jitted
    one-device step, and each rank's shards as many bytes as
    ``local_bytes`` reckons."""
    parent, results = sharded
    for res in results:
        run = res[f"{arch}_{mode}"]
        assert run["held"] == run["reckoned"]
        _check_steps(run["steps"], parent["want"][arch])
    if mode == "fsdp":
        # FSDP splits the state: each rank holds less than the whole
        whole = sum(a.nbytes for _, a in parent["want"][arch][0][1])
        assert all(r[f"{arch}_fsdp"]["held"] < whole for r in results)


def test_8bit_hybrid_under_fsdp_matches_the_reference(sharded):
    """zamba2 with 8-bit moments on data=2 under FSDP: payloads, the one
    scale of each stacked leaf across ranks and the params against the
    reference's jitted one-device step."""
    parent, results = sharded
    for res in results:
        run = res["zamba2_2_7b_8bit_fsdp"]
        assert run["held"] == run["reckoned"]
        _check_steps(run["steps"], parent["want"]["zamba2_2_7b_8bit"],
                     eight_bit=True)


@pytest.mark.parametrize("drill", ["clean", "loss", "staged"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_sharded_engine_through_a_host_loss(sharded, layout, drill):
    """rwkv6 on data=2, hosts=2: every request's greedy tokens are the
    reference's ContinuousEngine's, with host 1 lost at decode or while a
    prompt of 12 is in its second chunk (its recurrent rows, or its
    staging state, move to the survivor); the lost rank leaves."""
    parent, results = sharded
    runs = [r[f"{drill}_{layout}"] for r in results]
    assert runs[0]["tokens"] == parent["tokens"]
    if drill == "clean":
        assert not any(r["left"] for r in runs)
        assert runs[1]["tokens"] == parent["tokens"]
    else:
        assert all(runs[0]["fired"])
        assert runs[0]["host_losses"] == 1 and not runs[0]["left"]
        assert runs[1]["left"] and runs[1]["tokens"] is None
