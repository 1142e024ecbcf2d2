"""The port's paged KV layer (repro_torch.serve.paged, the paged and cached
attention functions, the paged Model methods) and its host scheduler, held
against the reference's on the CPU.

Smoke qwen3-4b in float32 with the reference's own params converted through
numpy (``params_from_numpy``); the reference runs under
``compiler.options(backend="pallas")``, its Pallas kernels in interpret
mode.  Attention functions and Model methods agree within 1e-5 (float32,
the same terms summed in other orders); the port's paged decode is held
BITWISE to its dense decode, which is what its one ``_attend_token`` path
promises.  Pools: the reference's are (n_blocks, ...); the port's hold one
trash page more, which the comparisons leave out."""
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
from repro.serve import paged as jpaged
from repro.serve import scheduler as jsched
from repro_torch.configs import smoke_config
from repro_torch.models import attention as attn
from repro_torch.models.attention import KVCache
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import Model
from repro_torch.serve import paged, scheduler

TOL = 1e-5
BS = 8            # block size
NB = 10           # pages in the pool
MAX_SEQ = 32      # = 4 pages a slot


@pytest.fixture(scope="module")
def pair():
    """(cfg, jax model, jax params, port model, port params)."""
    jcfg = dataclasses.replace(jax_smoke_config("qwen3_4b"), use_flash=True)
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = smoke_config("qwen3_4b", use_flash=True)
    params = params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return cfg, jmodel, jparams, Model(cfg), params


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _pools(cfg, rng, n_layers=None):
    """Random page pools: the reference's (n_blocks pages) as numpy, and
    the port's, the same pages plus a trash page of other values."""
    n_layers = n_layers or cfg.n_layers
    shape = (n_layers, NB + 1, BS, cfg.n_kv_heads, cfg.hd)
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    return (k[:, :NB], v[:, :NB]), KVCache(torch.tensor(k), torch.tensor(v))


def _layer(jparams, params, li=0):
    return (jax.tree_util.tree_map(lambda a: a[li], jparams["blocks"]).attn,
            params["blocks"][li]["attn"])


# ---------------------------------------------------------------------------
# the host side: block pool, tables, bytes, scheduler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("script", [
    [("alloc", "a", 3), ("alloc", "b", 2), ("free", "a"), ("alloc", "c", 1),
     ("free", "b"), ("free", "c")],
    [("alloc", 0, 5), ("alloc", 1, 3), ("free", 0), ("alloc", 2, 4),
     ("free", 0), ("alloc", 0, 1), ("free", 2), ("free", 1)],
])
def test_block_pool_follows_the_reference(script):
    mine, ref = paged.BlockPool(NB, BS), jpaged.BlockPool(NB, BS)
    for op, owner, *n in script:
        assert getattr(mine, op)(owner, *n) == getattr(ref, op)(owner, *n)
        assert mine.stats() == ref.stats()
        assert mine.owned(owner) == ref.owned(owner)
        assert mine.validate() == ref.validate() == []
    with pytest.raises(ValueError, match="exhausted"):
        mine.alloc("x", NB + 1)


def test_tables_and_byte_accounting_are_copies(pair):
    cfg = pair[0]
    for n in (0, 1, 8, 9, 17):
        assert paged.blocks_for(n, BS) == jpaged.blocks_for(n, BS)
    assert paged.table_row([4, 7], 4, NB) == jpaged.table_row([4, 7], 4, NB)
    with pytest.raises(ValueError):
        paged.table_row([1, 2, 3], 2, NB)
    assert paged.dense_kv_bytes(cfg, 4, 64) == jpaged.dense_kv_bytes(cfg, 4,
                                                                     64)
    assert paged.paged_kv_bytes(cfg, NB, BS) == jpaged.paged_kv_bytes(
        cfg, NB, BS)
    assert paged.dtype_bytes("bfloat16") == jpaged.dtype_bytes("bfloat16")


def _drive(mod, pool_mod):
    """A scripted trace through one package's Scheduler: submits, chunk
    blocks, a block-starved deferral, a cancel of a queued request and of an
    admitted one, a failure, an evacuation; returns what it observed."""
    pool = pool_mod.BlockPool(6, BS)
    s = mod.Scheduler(2, pool=pool)
    seen = []
    for rid, (plen, new) in enumerate([(9, 4), (20, 20), (5, 3), (3, 2),
                                       (4, 6)]):
        s.submit(rid, plen, new)
    for step in range(9):
        adm = s.admissions()
        for slot, rid in s.prefilling():
            s.prefill_advance(slot, 8)
            if not s.slots[slot].prefilling:
                s.record_first(slot, 100 + rid)
        block = np.arange(8 * step, 8 * step + 8)[None].repeat(2, 0) + \
            np.array([[0], [1000]])
        retired = s.record_chunk(block)
        if step == 1:
            s.cancel(3)                       # still queued
        if step == 3:
            s.fail(s.slots[0].req_id if not s.slots[0].free else 4, "drill")
        if step == 4 and not s.slots[1].free:
            seen.append(("evacuated", s.evacuate(1)))
        seen.append((adm, retired, s.stats(), pool.stats(),
                     [(x.req_id, x.remaining, x.prefill_pos)
                      for x in s.slots]))
    results = {}
    for rid in range(5):
        try:
            r = s.pop_result(rid)
            results[rid] = (r.tokens, r.state, r.reason)
        except ValueError:
            results[rid] = "in flight"
    return seen, results


def test_scheduler_trace_matches_the_reference():
    assert _drive(scheduler, paged) == _drive(jsched, jpaged)


def test_scheduler_defers_fifo_when_starved():
    """The queue head waits for blocks; nothing behind it jumps ahead."""
    pool = paged.BlockPool(4, BS)
    s = scheduler.Scheduler(2, pool=pool)
    s.submit(0, 20, 10)                       # 4 blocks: the whole pool
    s.submit(1, 2, 2)                         # would fit slot 1, must wait
    assert s.admissions() == [(0, 0)]
    assert s.admissions() == [] and s.stats()["deferrals"] == 2
    s.record_first(0, 1)
    s.cancel(0)
    assert pool.free_blocks == 4
    assert s.admissions() == [(0, 1)]


def test_scheduler_buckets_are_copies():
    for max_seq, mb in ((64, 16), (100, 8), (16, 16), (5, 16)):
        assert scheduler.seq_buckets(max_seq, mb) == \
            jsched.seq_buckets(max_seq, mb)
    b = scheduler.seq_buckets(64, 8)
    assert [scheduler.pick_bucket(n, b) for n in (1, 8, 9, 33, 64)] == \
        [jsched.pick_bucket(n, b) for n in (1, 8, 9, 33, 64)]
    with pytest.raises(ValueError):
        scheduler.pick_bucket(65, b)


# ---------------------------------------------------------------------------
# the paged and cached attention functions
# ---------------------------------------------------------------------------

def test_page_slots_send_sentinels_and_overflow_to_the_trash_page():
    bt = torch.tensor([[3, 5, NB, NB], [7, NB, NB, NB]])
    pos = torch.tensor([9, 31])
    page, off = attn._page_slots(pos, bt, BS, NB)
    assert page.tolist() == [5, NB] and off.tolist() == [1, 7]
    page, off = attn._page_slots(torch.tensor([MAX_SEQ, 0]), bt, BS, NB)
    assert page.tolist() == [NB, 7]
    jp, jo = jattn._pages_for_positions(jnp.arange(20), jnp.asarray(bt[0]),
                                        BS, NB)
    p, o = attn._pages_for_positions(torch.arange(20), bt[0], BS, NB)
    assert p.tolist() == np.asarray(jp).tolist()
    assert o.tolist() == np.asarray(jo).tolist()


def test_gather_views_match(pair, rng):
    cfg = pair[0]
    (jk, jv), pool = _pools(cfg, rng)
    bt = np.array([[3, 1, 8, 0], [6, 2, NB, NB]])
    vk, vv = attn.gather_paged_view(pool.k, pool.v, torch.tensor(bt))
    wk, wv = jattn.gather_paged_view(jnp.asarray(jk), jnp.asarray(jv),
                                     jnp.asarray(bt))
    assert vk.shape == (cfg.n_layers, 2, MAX_SEQ, cfg.n_kv_heads, cfg.hd)
    # the sentinel pages: the reference clips them to a real page, the
    # port reads its trash page; both lie past every valid position
    np.testing.assert_array_equal(vk[:, :, :2 * BS].numpy(),
                                  np.asarray(wk)[:, :, :2 * BS])
    np.testing.assert_array_equal(vv[:, 0].numpy(), np.asarray(wv)[:, 0])


@pytest.mark.parametrize("first,start", [(True, 0), (False, 8), (False, 13)])
def test_paged_attention_prefill_matches(pair, rng, first, start):
    cfg, _, jparams, _, params = pair
    jp, p = _layer(jparams, params, 1)
    (jk, jv), pool = _pools(cfg, rng)
    s = 8
    x = rng.randn(1, s, cfg.d_model).astype(np.float32)
    bt = np.array([4, 9, 2, NB])
    with compiler.options(backend="pallas"):
        want, wk, wv = jattn.paged_attention_prefill(
            jp, cfg, jnp.asarray(x), jnp.asarray(jk), jnp.asarray(jv), 1,
            jnp.asarray(bt), start, first=first)
    got, ck, cv = attn.paged_attention_prefill(
        p, cfg, torch.tensor(x), pool.k, pool.v, 1, torch.tensor(bt), start,
        first=first)
    _close(got, want)
    _close(ck[:, :NB], wk)
    _close(cv[:, :NB], wv)


def test_attention_prefill_cached_matches_and_drops_the_overrun(pair, rng):
    """A tail chunk at start 28 of a 32-position cache, padded to 8: the
    rows past max_seq drop, the earlier positions are untouched."""
    cfg, _, jparams, _, params = pair
    jp, p = _layer(jparams, params)
    k0 = rng.randn(2, MAX_SEQ, cfg.n_kv_heads, cfg.hd).astype(np.float32)
    v0 = rng.randn(*k0.shape).astype(np.float32)
    x = rng.randn(2, 8, cfg.d_model).astype(np.float32)
    for start in (5, 28):
        with compiler.options(backend="pallas"):
            want, wc = jattn.attention_prefill_cached(
                jp, cfg, jnp.asarray(x),
                jattn.KVCache(jnp.asarray(k0), jnp.asarray(v0)), start)
        cache = KVCache(torch.tensor(k0), torch.tensor(v0))
        got, cache = attn.attention_prefill_cached(p, cfg, torch.tensor(x),
                                                   cache, start)
        _close(got, want)
        _close(cache.k, wc.k)
        _close(cache.v, wc.v)
    assert torch.equal(cache.k[:, :28], torch.tensor(k0)[:, :28])


@pytest.mark.parametrize("view", [False, True], ids=["inplace", "view"])
def test_paged_decode_matches(pair, rng, view):
    cfg, _, jparams, _, params = pair
    jp, p = _layer(jparams, params, 1)
    (jk, jv), pool = _pools(cfg, rng)
    bt = np.array([[3, 1, 8, 0], [6, 2, NB, NB], [5, NB, NB, NB]])
    pos = np.array([27, 9, MAX_SEQ])          # slot 2 parked: writes drop
    x = rng.randn(3, 1, cfg.d_model).astype(np.float32)
    args = (jnp.asarray(x), jnp.asarray(jk), jnp.asarray(jv))
    targs = (torch.tensor(x), pool.k, pool.v)
    if view:
        wvk, wvv = jattn.gather_paged_view(args[1], args[2], jnp.asarray(bt))
        vk, vv = attn.gather_paged_view(pool.k, pool.v, torch.tensor(bt))
        want, wk, wv, wvk, wvv = jattn.paged_attention_decode_view(
            jp, cfg, *args, wvk, wvv, 1, jnp.asarray(pos), jnp.asarray(bt))
        got, ck, cv, vk, vv = attn.paged_attention_decode_view(
            p, cfg, *targs, vk, vv, 1, torch.tensor(pos), torch.tensor(bt))
        _close(vk[:, :2, :2 * BS], np.asarray(wvk)[:, :2, :2 * BS])
    else:
        want, wk, wv = jattn.paged_attention_decode_inplace(
            jp, cfg, *args, 1, jnp.asarray(pos), jnp.asarray(bt))
        got, ck, cv = attn.paged_attention_decode_inplace(
            p, cfg, *targs, 1, torch.tensor(pos), torch.tensor(bt))
    # slot 2 is parked: its output attends to nothing valid past the mask
    _close(got[:2], np.asarray(want)[:2])
    _close(ck[:, :NB], wk)
    _close(cv[:, :NB], wv)


@pytest.mark.parametrize("upcast", [True, False], ids=["upcast", "card"])
def test_token_attention_forms_match_the_reference(pair, rng, upcast):
    """Both forms of the decode attention against the reference's
    ``_attend_token`` (per-slot positions, one slot at the last position):
    the CPU's upcast, and the card's form (every query head against every
    kv head, the GQA pairs a diagonal view), whose arithmetic runs here in
    fp32."""
    cfg, _, jparams, _, params = pair
    jp, p = _layer(jparams, params)
    q = rng.randn(3, 1, cfg.n_heads, cfg.hd).astype(np.float32)
    k = rng.randn(3, 12, cfg.n_kv_heads, cfg.hd).astype(np.float32)
    v = rng.randn(*k.shape).astype(np.float32)
    pos = np.array([11, 0, 6])
    want = jattn._attend_token(cfg, *(jnp.asarray(a) for a in (q, k, v, pos)),
                               True, jnp.float32, jp.wo)
    out = attn._token_attention(cfg, *(torch.tensor(a) for a in
                                       (q, k, v, pos)), True, upcast=upcast)
    _close(out.reshape(3, 1, -1) @ p["wo"], want)


def test_masked_attend_matches(pair, rng):
    cfg = pair[0]
    q = rng.randn(2, 5, cfg.n_heads, cfg.hd).astype(np.float32)
    k = rng.randn(2, 12, cfg.n_kv_heads, cfg.hd).astype(np.float32)
    v = rng.randn(*k.shape).astype(np.float32)
    qpos = np.array([[3, 4, 5, 6, 7], [7, 8, 9, 10, 11]])
    kpos = np.arange(12)[None]
    want = jattn._masked_attend(cfg, *(jnp.asarray(a) for a in
                                       (q, k, v, qpos, kpos)))
    got = attn._masked_attend(cfg, *(torch.tensor(a) for a in
                                     (q, k, v, qpos, kpos)))
    _close(got, want)


def test_parked_lane_never_writes_a_live_lanes_page(pair, rng):
    """Slot 1 is parked (position max_seq, an all-sentinel row).  Clamped
    to the last real page, its write would land where slot 0 writes in the
    same ``index_put_``: page NB - 1, offset max_seq % BS.  The trash page
    takes it instead.  Two runs whose parked lanes decode different tokens
    leave slot 0's page and logits bitwise alike and differ in the trash."""
    cfg, _, _, model, params = pair
    live_pos = 2 * BS + MAX_SEQ % BS          # page NB - 1 of slot 0's row
    bt = torch.tensor([[0, 1, NB - 1, NB], [NB] * 4])
    pos = torch.tensor([live_pos, MAX_SEQ])
    clamped = (bt[1, -1].clamp(max=NB - 1), MAX_SEQ % BS)
    assert (int(bt[0, live_pos // BS]), live_pos % BS) == clamped
    _, pool = _pools(cfg, rng)
    runs = []
    for parked_tok in (7, 11):
        cache = KVCache(pool.k.clone(), pool.v.clone())
        logits, _ = model.decode_step(params, torch.tensor([[5], [parked_tok]]),
                                      cache, pos, block_tables=bt)
        runs.append((logits, cache))
    (l0, c0), (l1, c1) = runs
    assert torch.equal(l0[0], l1[0])
    assert torch.equal(c0.k[:, :NB], c1.k[:, :NB])
    assert torch.equal(c0.v[:, :NB], c1.v[:, :NB])
    assert not torch.equal(c0.k[:, NB], c1.k[:, NB])    # the trash page
    assert not torch.equal(c0.k[:, NB - 1, live_pos % BS],
                           pool.k[:, NB - 1, live_pos % BS])  # slot 0 wrote


# ---------------------------------------------------------------------------
# the paged Model methods
# ---------------------------------------------------------------------------

def test_init_paged_cache_shapes(pair):
    cfg, jmodel, _, model, _ = pair
    cache = model.init_paged_cache(2, MAX_SEQ, n_blocks=NB, block_size=BS,
                                   device="cpu")
    want = jmodel.init_paged_cache(2, MAX_SEQ, n_blocks=NB, block_size=BS)
    assert cache.k.shape == (want.k.shape[0], NB + 1) + want.k.shape[2:]
    assert float(cache.k.abs().sum()) == 0.0
    kv, state = model.split_paged_cache(cache)
    assert kv is cache and state is None
    assert model.merge_paged_cache(kv, state) is cache
    assert model.init_prefill_state() is None


def test_prefill_paged_chunks_match(pair, rng):
    """A 19-token prompt prefilled in chunks of 8 (first, then two
    continuations, the last padded) into a slot's pages: logits and pools
    agree with the reference's after every chunk."""
    cfg, jmodel, jparams, model, params = pair
    prompt = rng.randint(0, 256, size=19)
    bt = np.array([7, 2, 4, NB])
    jcache = jmodel.init_paged_cache(1, MAX_SEQ, n_blocks=NB, block_size=BS)
    cache = model.init_paged_cache(1, MAX_SEQ, n_blocks=NB, block_size=BS,
                                   device="cpu")
    for start in (0, 8, 16):
        take = min(8, 19 - start)
        toks = np.zeros((1, 8), np.int64)
        toks[0, :take] = prompt[start:start + take]
        with compiler.options(backend="pallas"):
            want, jcache, _ = jmodel.prefill_paged(
                jparams, jnp.asarray(toks), jcache, jnp.asarray(bt), None,
                start, jnp.asarray([take]), first=start == 0)
        got, cache, state = model.prefill_paged(
            params, torch.tensor(toks), cache, torch.tensor(bt), None, start,
            torch.tensor([take]), first=start == 0)
        assert state is None
        _close(got, want)
        _close(cache.k[:, :NB], jcache.k)
        _close(cache.v[:, :NB], jcache.v)


@pytest.mark.parametrize("view", [False, True], ids=["inplace", "view"])
def test_paged_decode_steps_match(pair, rng, view):
    cfg, jmodel, jparams, model, params = pair
    (jk, jv), pool = _pools(cfg, rng)
    bt = np.array([[3, 1, 8, 0], [6, 2, 5, NB]])
    pos = np.array([20, 9])
    jcache = jattn.KVCache(jnp.asarray(jk), jnp.asarray(jv))
    jview = (jmodel.gather_paged_view(jcache, jnp.asarray(bt)) if view
             else None)
    tview = (model.gather_paged_view(pool, torch.tensor(bt)) if view
             else None)
    for step in range(3):
        tok = rng.randint(0, 256, size=(2, 1))
        with compiler.options(backend="pallas"):
            out = jmodel.decode_step(jparams, jnp.asarray(tok), jcache,
                                     jnp.asarray(pos + step),
                                     block_tables=jnp.asarray(bt),
                                     kv_view=jview)
        got = model.decode_step(params, torch.tensor(tok), pool,
                                torch.tensor(pos + step),
                                block_tables=torch.tensor(bt),
                                kv_view=tview)
        assert len(got) == len(out) == (3 if view else 2)
        _close(got[0], out[0])
        jcache = out[1]
        if view:
            jview, tview = out[2], got[2]
    _close(pool.k[:, :NB], jcache.k)
    _close(pool.v[:, :NB], jcache.v)


def test_paged_decode_is_bitwise_the_dense_decode(pair, rng):
    """The same KV in a dense cache and, page-mapped, in a pool: decode
    steps through the dense path, the paged path and the chunk's view path
    give bitwise-equal logits, and the pool's pages hold the dense rows."""
    cfg, _, _, model, params = pair
    bt = torch.tensor([[3, 1, 8, 0], [6, 2, 5, 9]])
    lengths = [20, 11]
    dense = model.init_cache(2, MAX_SEQ, device="cpu")
    prompt = torch.tensor(rng.randint(0, 256, size=(2, 20)))
    model.prefill(params, prompt, dense, lengths=torch.tensor(lengths))
    pools = [model.init_paged_cache(2, MAX_SEQ, n_blocks=NB, block_size=BS,
                                    device="cpu") for _ in range(2)]
    for pool in pools:
        for b in range(2):
            for j in range(MAX_SEQ // BS):
                rows = slice(j * BS, (j + 1) * BS)
                pool.k[:, bt[b, j]] = dense.k[:, b, rows]
                pool.v[:, bt[b, j]] = dense.v[:, b, rows]
    view = model.gather_paged_view(pools[1], bt)
    pos = torch.tensor(lengths)
    for step in range(4):
        tok = torch.tensor(rng.randint(0, 256, size=(2, 1)))
        want, _ = model.decode_step(params, tok, dense, pos + step)
        got, _ = model.decode_step(params, tok, pools[0], pos + step,
                                   block_tables=bt)
        got_v, _, view = model.decode_step(params, tok, pools[1], pos + step,
                                           block_tables=bt, kv_view=view)
        assert torch.equal(got, want) and torch.equal(got_v, want)
    for pool in pools:
        for b in range(2):
            assert torch.equal(pool.k[:, bt[b]].reshape(dense.k[:, b].shape),
                               dense.k[:, b])
    assert torch.equal(view[0], dense.k)
