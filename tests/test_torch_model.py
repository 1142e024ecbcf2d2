"""The port's dense transformer (repro_torch.models) held against the
reference's (repro.models) on the CPU.

Smoke qwen3-4b in float32, with the reference's own params converted
through numpy by ``params_from_numpy``.  With ``use_flash=True`` the JAX
side runs under ``compiler.options(backend="pallas")``, so its RMSNorm and
flash attention are the Pallas kernels in interpret mode; with
``use_flash=False`` it runs its XLA einsum path.  The port has one path
either way: its kernel wrappers, which run the plain versions on the CPU.  Logits agree within 1e-4 (float32, different
summation orders across two layers and the head)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compiler
from repro.configs import smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models.transformer import Model as JaxModel
from repro_torch.configs import smoke_config
from repro_torch.kernels import ops
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import Model

TOL = 1e-4
BACKEND = {True: "pallas", False: "xla"}


@pytest.fixture(scope="module", params=[True, False], ids=["flash", "xla"])
def pair(request):
    """(use_flash, jax model, jax params, port model, port params)."""
    use_flash = request.param
    jcfg = dataclasses.replace(jax_smoke_config("qwen3_4b"),
                               use_flash=use_flash)
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = smoke_config("qwen3_4b", use_flash=use_flash)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = params_from_numpy(cfg, tree, device="cpu")
    return use_flash, jmodel, jparams, Model(cfg), params


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


def test_configs_are_copies():
    from repro.configs import config as jax_config
    from repro_torch.configs import config
    assert dataclasses.asdict(config("qwen3-4b")) == \
        dataclasses.asdict(jax_config("qwen3-4b"))
    assert dataclasses.asdict(smoke_config("qwen3_4b")) == \
        dataclasses.asdict(jax_smoke_config("qwen3_4b"))


def test_unported_arch_and_family_raise():
    """Every family of the reference is ported: the recurrent configs
    (``rwkv6_1_6b``, ``zamba2-2.7b``) equal the reference's field for
    field, and ``Model`` builds both families, as it builds the
    transformer families (dbrx's moe among them); a family the reference
    does not have still raises."""
    from repro.configs import config as jax_config
    from repro_torch.configs import config
    for arch in ("rwkv6_1_6b", "zamba2-2.7b"):
        assert dataclasses.asdict(config(arch)) == \
            dataclasses.asdict(jax_config(arch))
        assert dataclasses.asdict(smoke_config(arch)) == \
            dataclasses.asdict(jax_smoke_config(arch))
    assert Model(config("rwkv6-1.6b")).cfg.family == "ssm"
    assert Model(config("zamba2_2_7b")).cfg.family == "hybrid"
    for family in ("ssm", "hybrid"):
        cfg = dataclasses.replace(smoke_config("qwen3_4b"), family=family)
        assert Model(cfg).cfg.family == family
    cfg = dataclasses.replace(smoke_config("qwen3_4b"), family="cnn")
    with pytest.raises(NotImplementedError, match="family 'cnn'"):
        Model(cfg)
    assert Model(config("dbrx_132b")).cfg.family == "moe"
    cfg = dataclasses.replace(smoke_config("qwen3_4b"), family="moe")
    assert Model(cfg).cfg.family == "moe"


def test_forward_logits_match(pair, rng):
    use_flash, jmodel, jparams, model, params = pair
    toks = rng.randint(0, 256, size=(2, 12))
    with compiler.options(backend=BACKEND[use_flash]):
        want = jmodel.forward(jparams, jnp.asarray(toks))
    got = model.forward(params, torch.tensor(toks))
    assert got.shape == (2, 12, 256)
    _close(got, want)


def test_prefill_and_decode_logits_match(pair, rng):
    """Right-padded mixed-length prefill, then decode steps at per-slot
    positions: logits and caches agree at every step."""
    use_flash, jmodel, jparams, model, params = pair
    lengths = np.array([9, 4, 13], np.int32)
    toks = rng.randint(0, 256, size=(3, 13))
    max_seq = 32
    with compiler.options(backend=BACKEND[use_flash]):
        jcache = jmodel.init_cache(3, max_seq)
        want, jcache = jmodel.prefill(jparams, jnp.asarray(toks), jcache,
                                      lengths=jnp.asarray(lengths))
    cache = model.init_cache(3, max_seq, device="cpu")
    got, cache = model.prefill(params, torch.tensor(toks), cache,
                               lengths=torch.tensor(lengths))
    _close(got, want)
    _close(cache.k, jcache.k)
    _close(cache.v, jcache.v)

    pos = lengths.copy()
    for step in range(4):
        nxt = rng.randint(0, 256, size=(3, 1))
        with compiler.options(backend=BACKEND[use_flash]):
            want, jcache = jmodel.decode_step(jparams, jnp.asarray(nxt),
                                              jcache, jnp.asarray(pos))
        got, cache = model.decode_step(params, torch.tensor(nxt), cache,
                                       torch.tensor(pos))
        _close(got, want)
        pos = pos + 1
    _close(cache.k, jcache.k)


def test_decode_scalar_position_matches(pair, rng):
    """The lock-step form: one scalar position for the whole batch."""
    use_flash, jmodel, jparams, model, params = pair
    toks = rng.randint(0, 256, size=(2, 6))
    with compiler.options(backend=BACKEND[use_flash]):
        jcache = jmodel.init_cache(2, 16)
        _, jcache = jmodel.prefill(jparams, jnp.asarray(toks), jcache)
        want, jcache = jmodel.decode_step(jparams, jnp.asarray(toks[:, :1]),
                                          jcache, 6)
    cache = model.init_cache(2, 16, device="cpu")
    _, cache = model.prefill(params, torch.tensor(toks), cache)
    got, cache = model.decode_step(params, torch.tensor(toks[:, :1]), cache,
                                   6)
    _close(got, want)
    _close(cache.k, jcache.k)


def test_decode_past_max_seq_drops_the_write(pair, rng):
    """A slot whose position ran past max_seq writes nothing (the
    reference's mode='drop'); the other slots write as usual."""
    _, _, _, model, params = pair
    cache = model.init_cache(2, 8, device="cpu")
    before = cache.k.clone()
    model.decode_step(params, torch.tensor([[3], [4]]), cache,
                      torch.tensor([8, 2]))
    assert torch.equal(cache.k[:, 0], before[:, 0])
    assert not torch.equal(cache.k[:, 1, 2], before[:, 1, 2])


def test_chunked_attention_matches(rng):
    """The reference's plain online-softmax path for long sequences (small
    chunks here) against the port's one prefill attention, the flash
    wrapper (its plain version on the CPU)."""
    b, s, nh, nkv, hd = 2, 64, 4, 2, 16
    qa = rng.randn(b, s, nh, hd).astype(np.float32)
    ka = rng.randn(b, s, nkv, hd).astype(np.float32)
    va = rng.randn(b, s, nkv, hd).astype(np.float32)
    want = jattn.chunked_attention(jnp.asarray(qa), jnp.asarray(ka),
                                   jnp.asarray(va), kv_chunk=16)
    flat = lambda a, n: torch.tensor(a).transpose(1, 2).reshape(  # noqa: E731
        b * n, s, hd)
    got = ops.flash_attention(flat(qa, nh), flat(ka, nkv), flat(va, nkv),
                              causal=True)
    _close(got.reshape(b, nh, s, hd).transpose(1, 2), want)


@pytest.mark.parametrize("use_flash", [True, False])
def test_prefill_attention_always_goes_through_flash(monkeypatch, use_flash):
    """Every prefill layer calls the flash wrapper whatever ``use_flash``
    says, so a CUDA tensor always reaches the kernel K3."""
    calls = []
    real = ops.flash_attention

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    cfg = smoke_config("qwen3_4b", use_flash=use_flash)
    model = Model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    model.forward(params, torch.zeros((2, 5), dtype=torch.long))
    assert calls == [(2 * cfg.n_heads, 5, cfg.hd)] * cfg.n_layers


def test_init_params_shapes_and_distribution():
    cfg = smoke_config("qwen3_4b")
    model = Model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    jparams = JaxModel(jax_smoke_config("qwen3_4b")).init_params(
        jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    conv = params_from_numpy(cfg, tree, device="cpu")
    flat = lambda p: {k: v.shape for k, v in  # noqa: E731
                      _flatten(p).items()}
    assert flat(params) == flat(conv)
    w = params["blocks"][0]["attn"]["wq"]
    assert abs(w.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.1
    again = model.init_params(torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["head"], params["head"])


def _flatten(node, prefix=""):
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            out.update(_flatten(v, f"{prefix}{k}."))
        return out
    if isinstance(node, list):
        out = {}
        for i, v in enumerate(node):
            out.update(_flatten(v, f"{prefix}{i}."))
        return out
    return {} if node is None else {prefix: node}


def test_init_params_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    model = Model(smoke_config("qwen3_4b"))
    with pytest.raises(RuntimeError, match="no CUDA"):
        model.init_params(torch.Generator())
