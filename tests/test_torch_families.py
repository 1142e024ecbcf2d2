"""The transformer families in the port (dense, moe, vlm, audio) on the
CPU, held against the reference.

  * Each of the six configs the families bring (``stablelm_1_6b``,
    ``qwen1_5_32b``, ``chameleon_34b``, ``musicgen_large``, ``dbrx_132b``,
    ``grok_1_314b``) at its smoke size in fp32, the reference's params
    carried into the port by ``models.convert``: forward logits, the loss
    with the MoE aux, every gradient, prefill and one decode step.
  * ``ffn.moe`` alone: with no drops, and with drops at the config's
    capacity factor (a group of more than 64 tokens, so no floor).
  * The MoE and audio smoke configs through the static, continuous and
    paged engines, token-identical (greedy) to the reference's same
    engine; continuous equal to static where the reference's two agree.
  * ``launch.dryrun.reckon`` for the six full configs on the production
    meshes, and the rules' specs of their leaves, against the reference.

A router whose k-th and (k+1)-th probabilities lie within fp32 rounding
of each other may pick either expert in either package; every routing the
port does in these tests is watched and such a near-tie is reported as a
warning, never reseeded away.

Tolerances (fp32): logits and decode logits 1e-4 absolute (two layers and
the head in other summation orders), the loss 1e-6 relative, gradients
1e-4 relative plus 1e-5 of the leaf's largest magnitude."""
import dataclasses
import functools
import math
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import config as jconfig
from repro.configs import smoke_config as jsmoke
from repro.launch import specs as jspecs
from repro.models import ffn as jffn
from repro.models.transformer import Model as JModel
from repro.serve.engine import BatchedEngine as JBatched
from repro.serve.engine import ContinuousEngine as JContinuous
from repro.serve.engine import Request as JRequest
from repro.sharding import rules as jrules
from repro.train import step as jstep
from repro_torch.configs import ARCH_IDS, config, smoke_config
from repro_torch.launch import dryrun
from repro_torch.models import ffn
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import Model
from repro_torch.optim import adamw
from repro_torch.serve.engine import BatchedEngine, ContinuousEngine, Request
from repro_torch.sharding import rules
from repro_torch.train import step as tstep

ARCHS = ["stablelm_1_6b", "qwen1_5_32b", "chameleon_34b", "musicgen_large",
         "dbrx_132b", "grok_1_314b"]
TOL = 1e-4
ENGINE = dict(max_seq=48, slots=2, chunk=4, min_bucket=8, prefill_chunk=8)
LENGTHS, MAX_NEW = (7, 21, 3, 12), (5, 3, 6, 4)
TIE = 4 * float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def _watch_ties(monkeypatch):
    """Report every routing whose k-th and (k+1)-th probabilities are
    closer than fp32 rounding."""
    route = ffn.route

    def watched(router, x, k):
        probs, topk_p, topk_i = route(router, x, k)
        if k < probs.shape[-1]:
            top = torch.topk(probs.detach(), k + 1, dim=-1).values
            gap = float((top[..., k - 1] - top[..., k]).min())
            if gap < TIE:
                warnings.warn(f"router near-tie: k-th and (k+1)-th "
                              f"probabilities {gap:.3g} apart")
        return probs, topk_p, topk_i
    monkeypatch.setattr(ffn, "route", watched)


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
    extra = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    return np.random.RandomState(seed).randint(0, cfg.vocab, shape + extra)


def _batch(cfg, seed=0):
    rng = np.random.RandomState(seed + 1)
    labels = rng.randint(0, cfg.vocab, (2, 12))
    labels[0, :3] = -100
    return {"tokens": _tokens(cfg, (2, 12), seed), "labels": labels}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=tol)


def test_configs_are_the_references():
    assert set(ARCHS) <= set(ARCH_IDS)
    for arch in ARCHS:
        assert dataclasses.asdict(config(arch)) == \
            dataclasses.asdict(jconfig(arch))
        assert dataclasses.asdict(smoke_config(arch)) == \
            dataclasses.asdict(jsmoke(arch))
    assert config("dbrx-132b") == config("dbrx_132b")
    assert config("qwen1.5-32b").qkv_bias


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match(arch):
    jm, jp, model, params = _pair(arch)
    toks = _tokens(model.cfg, (2, 12), 0)
    got = model.forward(params, torch.tensor(toks))
    assert got.shape == (2, 12, model.cfg.vocab)
    _close(got, jm.forward(jp, jnp.asarray(toks)))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_with_aux_and_gradients_match(arch):
    """The loss (the MoE's ``0.01 * aux`` included) and the gradient of
    every leaf, the reference's carried into the port's layout."""
    jm, jp, model, params = _pair(arch)
    batch = _batch(model.cfg)
    want, jgrads = jax.value_and_grad(jm.loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = adamw.leaves(params)
    flat = [p.detach().clone().requires_grad_(True) for _, p in leaves]
    got = model.loss(adamw.unflatten(params, flat),
                     {k: torch.tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    if model.cfg.n_experts:
        aux = float(model._last_aux.detach())
        assert aux > 0
        # the aux term is the reference's too: without it the losses part
        assert abs(float(got.detach()) - 0.01 * aux - float(want)) > 1e-4
    else:
        assert model._last_aux is None
    grads = torch.autograd.grad(got, flat)
    want_g = params_from_numpy(model.cfg, jax.tree_util.tree_map(
        np.asarray, jgrads), device="cpu")
    for (path, _), g, (_, w) in zip(leaves, grads, adamw.leaves(want_g)):
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=1e-4,
            atol=1e-5 * max(float(w.abs().max()), 1e-30), err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match(arch):
    """A right-padded prefill (lengths 12 and 9) then one decode step at
    each row's own position; the audio token broadcast to its codebooks."""
    jm, jp, model, params = _pair(arch)
    cfg = model.cfg
    toks = _tokens(cfg, (2, 12), 3)
    lengths = np.array([12, 9])
    jcache = jm.init_cache(2, 32)
    want, jcache = jm.prefill(jp, jnp.asarray(toks), jcache,
                              lengths=jnp.asarray(lengths))
    cache = model.init_cache(2, 32, device="cpu")
    with torch.no_grad():
        got, cache = model.prefill(params, torch.tensor(toks), cache,
                                   lengths=torch.tensor(lengths))
    _close(got, want)
    nxt = np.asarray(want).argmax(-1)[:, None]
    if cfg.n_codebooks:
        nxt = np.broadcast_to(nxt[..., None], (2, 1, cfg.n_codebooks))
    want, _ = jm.decode_step(jp, jnp.asarray(nxt), jcache,
                             jnp.asarray(lengths))
    with torch.no_grad():
        got, _ = model.decode_step(params, torch.tensor(np.array(nxt)),
                                   cache, torch.tensor(lengths))
    _close(got, want)


# ---------------------------------------------------------------------------
# ffn.moe alone
# ---------------------------------------------------------------------------

def _moe_pair(cf, seed=0):
    jcfg = dataclasses.replace(jsmoke("dbrx_132b"), moe_capacity_factor=cf)
    jp = jffn.init_moe(jax.random.PRNGKey(seed), jcfg)
    cfg = smoke_config("dbrx_132b", moe_capacity_factor=cf)
    p = {k: torch.tensor(np.asarray(v), requires_grad=True)
         for k, v in jp._asdict().items()}
    return jcfg, jp, cfg, p


@pytest.mark.parametrize("cf,s,drops", [(8.0, 40, False), (1.25, 96, True)],
                         ids=["no_drops", "drops"])
def test_moe_alone_matches_the_reference(cf, s, drops):
    """Outputs, aux and gradients of ``ffn.moe`` on (2, s, d), the tokens
    leaning towards one expert: a capacity factor of 8 drops nothing; the
    config's 1.25 on 2 x 96 tokens (cap 120, > 64: no floor) drops that
    expert's entries past its capacity, as the reference does."""
    jcfg, jp, cfg, p = _moe_pair(cf)
    rng = np.random.RandomState(7)
    # tokens leaning towards expert 0 (one unit along its router column)
    r0 = np.asarray(jp.router)[:, 0]
    x = (rng.randn(2, s, cfg.d_model)
         + r0 / np.linalg.norm(r0)).astype(np.float32)
    cot = rng.randn(2, s, cfg.d_model).astype(np.float32)

    def jobj(p, x):
        out, aux = jffn.moe(p, jcfg, x)
        return (out * cot).sum() + aux, (out, aux)
    jg, (jout, jaux) = jax.jit(jax.grad(jobj, has_aux=True))(
        jp, jnp.asarray(x))
    out, aux = ffn.moe(p, cfg, torch.tensor(x))
    _close(out, jout, 1e-5)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    grads = torch.autograd.grad((out * torch.tensor(cot)).sum() + aux,
                                list(p.values()))
    for (k, w), g in zip(jg._asdict().items(), grads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)
    # drops: some expert's entries outnumber its capacity
    _, _, topk_i = ffn.route(p["router"], torch.tensor(x).reshape(-1, 64),
                             cfg.top_k)
    busiest = int(torch.bincount(topk_i.reshape(-1)).max())
    assert (busiest > ffn.capacity(cfg, 2 * s)) == drops


def test_moe_decode_sized_groups_never_drop():
    """The capacity floor ``min(tl, 64)``: a group of at most 64 tokens
    keeps every entry, so a batch-1 chunk drops nothing."""
    cfg = smoke_config("dbrx_132b")
    for tl in (1, 4, 37, 64):
        assert ffn.capacity(cfg, tl) >= tl
    assert ffn.capacity(cfg, 1000) == int(1.25 * 1000 * 2 / 4)


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
@pytest.mark.parametrize("arch", ["dbrx_132b", "musicgen_large"])
def test_engines_token_identical_to_the_reference(arch, kind):
    """Four requests (one prompt of 21 prefilled in chunks of 8 by the
    continuous engines), each engine against the reference's same
    engine: a static MoE prefill routes all rows as one group at
    ``1.25 * tl * k / e`` and may drop, a continuous batch-1 chunk
    never does, so engines are held to their own kind."""
    want, got = _engine_run(arch, kind)
    assert got == want
    assert [len(o) for o in got] == list(MAX_NEW)


@pytest.mark.parametrize("arch", ["dbrx_132b", "musicgen_large"])
def test_continuous_equals_static_where_the_reference_agrees(arch):
    ref_static, static = _engine_run(arch, "static")
    for kind in ("dense", "paged"):
        ref_cont, cont = _engine_run(arch, kind)
        for i, (a, b) in enumerate(zip(ref_static, ref_cont)):
            if a == b:
                assert static[i] == cont[i], (kind, i)


# ---------------------------------------------------------------------------
# the dry run and the rules
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
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_reckon_equals_the_reference_specs(arch, shape, multi):
    """A rank's argument bytes at the production mesh (``data=16,
    model=16``; ``pod=2, data=16, model=16``): the reference's specs x
    shapes, leaf by leaf (with 8-bit moments, plus the layers' copies of
    each stacked leaf's scale that the port's layout holds)."""
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
        if jcfg.opt_8bit:
            # the port's layout: a stacked block leaf's one 8-bit scale
            # (fp32, whole on every rank) is held by each layer's QTensor
            per_layer = len(adamw.leaves(Model(config(arch)).init_params(
                torch.Generator(), "meta")["blocks"][0]))
            want += 2 * per_layer * (jcfg.n_layers - 1) * 4
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
    assert rec["active_params"] == jcfg.active_param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_reckon_skips_long_context_like_the_reference(arch):
    rec = dryrun.lower_cell(arch, "long_500k", False)
    ok, why = jspecs.shape_applicable(jconfig(arch), "long_500k")
    assert not ok and rec == {"status": "skipped", "reason": why}


@functools.lru_cache(maxsize=None)
def _ref_state(arch):
    """The reference's train state of ``arch`` at full width, as shapes."""
    jcfg = jconfig(arch)
    return jax.eval_shape(lambda k: jstep.make_train_state(
        JModel(jcfg), k, use_8bit=jcfg.opt_8bit), jax.random.PRNGKey(0))


@pytest.mark.parametrize("mesh", [{"data": 2, "model": 2},
                                  {"data": 1, "model": 4},
                                  {"data": 16, "model": 16}],
                         ids=["2x2", "1x4", "16x16"])
@pytest.mark.parametrize("arch", ["dbrx_132b", "grok_1_314b",
                                  "musicgen_large"])
def test_moe_and_codebook_specs_equal_the_reference(arch, mesh):
    """The experts over ``model`` where it divides them (grok's 8 on 16:
    their ff dim instead), the router whole, the codebook table's vocab
    over ``model``: every leaf of the train state, full width."""
    cfg, jcfg = config(arch), jconfig(arch)
    duck = types.SimpleNamespace(shape=dict(mesh))
    want = jstep.state_specs(_ref_state(arch), duck, jcfg)
    state = tstep.make_train_state(Model(cfg), torch.Generator(),
                                   use_8bit=cfg.opt_8bit, device="meta")
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
            w = ref_leaf(ref_leaf(want, part), path)
            if isinstance(spec, adamw.QTensor):
                spec, w = spec.q, w.q
            w = tuple(w)
            if path[0] == "blocks":
                assert w[0] is None
                w = w[1:]
            assert tuple(spec) == w, (part, path, tuple(spec), w)
            n += 1
    assert n == 3 * len(adamw.leaves(state["params"]))
    assert rules.params_specs(state["params"], duck, cfg) == got["params"]
