"""GQA multi-head attention: prefill (through the flash-attention kernel
K3), one-token cached decode, chunked prefill against the cache, and the
paged-KV variants.

The port of ``repro.models.attention``'s dense and paged functions.
Layouts are the reference's: activations (b, s, d); q (b, s, nh, hd); k/v
and the KV cache (b, s, nkv, hd), layer-stacked as (L, b, max_seq, nkv,
hd); a page pool (L, n_blocks + 1, block_size, nkv, hd).  Where JAX
returns an updated cache, the port writes the cache in place and says so.
Decode attention and the masked attention of chunked prefill stay plain
PyTorch, as the reference leaves them to XLA.

Writes that must drop.  JAX scatters with ``mode='drop'``; torch has no
such mode.  A dense slot's own row takes a dropped write as a rewrite of
the value already there.  A page pool holds one page more than the engine
hands out: page ``n_blocks``, the sentinel of every block table, is a trash
page that every dropped write lands in and no table maps to a live lane,
so a parked lane can never write into a live lane's page."""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.sharding import ctx
from .common import ModelConfig, apply_rope, init_dense, rmsnorm, rope_freqs


class KVCache(NamedTuple):
    k: torch.Tensor  # (..., b, max_seq, nkv, hd)
    v: torch.Tensor


def init_attn(generator: torch.Generator, cfg: ModelConfig, device=None
              ) -> Dict[str, Optional[torch.Tensor]]:
    d, nh, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt, dev = cfg.torch_dtype, device or generator.device
    zeros = lambda n: torch.zeros((n,), dtype=dt, device=dev)  # noqa: E731
    ones = lambda n: torch.ones((n,), dtype=dt, device=dev)    # noqa: E731
    return {
        "wq": init_dense(generator, d, nh * hd, dt, device=dev),
        "wk": init_dense(generator, d, nkv * hd, dt, device=dev),
        "wv": init_dense(generator, d, nkv * hd, dt, device=dev),
        "wo": init_dense(generator, nh * hd, d, dt, device=dev),
        "bq": zeros(nh * hd) if cfg.qkv_bias else None,
        "bk": zeros(nkv * hd) if cfg.qkv_bias else None,
        "bv": zeros(nkv * hd) if cfg.qkv_bias else None,
        "q_norm": ones(hd) if cfg.qk_norm else None,
        "k_norm": ones(hd) if cfg.qk_norm else None,
    }


def _project_qkv(p, cfg: ModelConfig, x, positions):
    """x: (b, s, d) -> q (b, s, nh, hd), k/v (b, s, nkv, hd), roped (the
    head counts those of ``p``'s columns: a tensor-parallel rank's)."""
    b, s, _ = x.shape
    hd = cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if p["bq"] is not None:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, -1, hd)
    k = k.reshape(b, s, -1, hd)
    v = v.reshape(b, s, -1, hd)
    if p["q_norm"] is not None:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope_freqs(hd, cfg.rope_theta, positions)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _project_kv(p, cfg: ModelConfig, x, positions):
    """k / v alone (every kv head of ``p``'s columns), as
    :func:`_project_qkv` makes them."""
    b, s, _ = x.shape
    k = x @ p["wk"]
    v = x @ p["wv"]
    if p["bk"] is not None:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(b, s, -1, cfg.hd)
    v = v.reshape(b, s, -1, cfg.hd)
    if p["k_norm"] is not None:
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope_freqs(cfg.hd, cfg.rope_theta, positions)
    return apply_rope(k, cos, sin), v


def _attend(p, cfg: ModelConfig, q, k, v, x_dtype):
    """Causal self-attention of projected q/k/v (one sequence per row,
    positions from 0) through the output projection: the part of the
    reference's ``attention`` after ``_project_qkv``.

    Always through ``ops.flash_attention``: K3 on a CUDA tensor, its plain
    version on a CPU tensor.  ``cfg.use_flash`` is kept in the config copy
    for parity with the reference and selects nothing here; the
    reference's einsum and chunked paths compute the same function."""
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    # at b == 1 the reshape is a strided view; K3 takes contiguous tensors
    qf = q.transpose(1, 2).reshape(b * nh, s, hd).contiguous()
    kf = k.transpose(1, 2).reshape(b * nkv, s, hd).contiguous()
    vf = v.transpose(1, 2).reshape(b * nkv, s, hd).contiguous()
    out = ops.flash_attention(qf, kf, vf, causal=True)
    out = out.reshape(b, nh, s, hd).transpose(1, 2)
    out = out.to(x_dtype).reshape(b, s, nh * hd)
    return out @ p["wo"]


def attention(p, cfg: ModelConfig, x, positions, path: str = "blocks/attn"):
    """Full self-attention over x (training / prefill without cache).

    Inside a tensor-parallel train step (``sharding.ctx.
    get_tensor_parallel()``) ``x`` is this rank's rows and the rank
    computes its heads: ``wq`` / ``wk`` / ``wv`` (and their biases)
    column-parallel, K3 on its query heads and the kv heads they read,
    ``wo`` row-parallel, its partial sums reduce-scattered into SP (or
    all-reduced with SP off).  Where ``model`` cannot give each rank
    whole heads (``tp.split_heads`` false), every rank computes every
    head: the weights gathered whole, the whole sequence after SP's
    all-gather, and the rank keeps its rows of the output (with SP off,
    the whole output, which every rank computes alike).  ``path`` is the
    rules' path of the weights (``blocks/shared_attn`` for the hybrid's
    shared block)."""
    tp = ctx.get_tensor_parallel()
    if tp is None:
        q, k, v = _project_qkv(p, cfg, x, positions)
        return _attend(p, cfg, q, k, v, x.dtype)
    if not tp.split_heads:
        local = _whole_weights(p, tp, path)

        def whole(xw):
            q, k, v = _project_qkv(local, cfg, xw, positions)
            return _attend(local, cfg, q, k, v, xw.dtype)
        return tp.whole_mixer(whole, x)
    local = _rank_weights(p, tp, path)
    x = tp.enter(x)
    q, k, v = _project_qkv(local, cfg, x, positions)
    return tp.exit(_attend(local, cfg, q, k, v, x.dtype))


def _rank_weights(p, tp, path: str):
    """The weights of the rank's heads (``tp.split_heads``): ``wq`` /
    ``wk`` / ``wv`` and their biases by columns, ``wo`` by rows, the qk
    norms whole."""
    cols = {"q": tp.q_cols, "k": tp.kv_cols, "v": tp.kv_cols}
    local = {f"w{h}": tp.part(p[f"w{h}"], f"{path}/w{h}", 1, c)
             for h, c in cols.items()}
    for h, c in cols.items():
        b = p[f"b{h}"]
        local[f"b{h}"] = None if b is None else \
            tp.part(b, f"{path}/b{h}", 0, c)
    for name in ("q_norm", "k_norm"):
        local[name] = None if p[name] is None else \
            tp.whole(p[name], f"{path}/{name}")
    local["wo"] = tp.part(p["wo"], f"{path}/wo", 0, tp.q_cols)
    return local


def _whole_weights(p, tp, path: str):
    """Every weight whole, for attention that every rank runs whole (``tp.
    split_heads`` false).  SP: each rank's share of the work is its rows'
    outputs, so the weights' and the input's gradients are partial sums
    over model; SP off: every rank repeats the whole work, gradients
    whole."""
    take = tp.mixer_take(path)
    return {name: take(w, name) for name, w in p.items()}


def attention_prefill(p, cfg: ModelConfig, x, cache: KVCache,
                      start: int = 0, path: str = "blocks/attn"):
    """Prefill: full attention over x AND the cache filled at
    [start, start+s).

    ``cache`` holds one layer's (b, max_seq, nkv, hd) buffers, written in
    place (the reference returns an updated copy).  q/k/v are projected
    once and shared by the cache write and the attention; the reference
    projects twice (its ``attention`` re-projects), which gives the same
    values and two more RMSNorm launches per layer under qk_norm.
    ``path`` is the rules' path of the weights, read on a serving step's
    model axis (``blocks/shared_attn`` for the hybrid's shared block)."""
    tp = ctx.get_tensor_parallel()
    if tp is not None:
        return _prefill_model_axis(p, cfg, x, cache, start, tp,
                                   path), cache
    b, s, _ = x.shape
    positions = start + torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    cache.k[:, start:start + s] = k
    cache.v[:, start:start + s] = v
    return _attend(p, cfg, q, k, v, x.dtype), cache


# ---------------------------------------------------------------------------
# serving with the params split over the model axis
# ---------------------------------------------------------------------------

def _prefill_model_axis(p, cfg: ModelConfig, x, cache: KVCache, start: int,
                        tp, path: str = "blocks/attn"):
    """:func:`attention_prefill` on a serving step's model axis (``tp``, a
    ``sharding.collectives.TensorParallel`` with ``kv``): ``x`` is the
    rank's rows of the prompt (SP) or the whole prompt, ``cache`` the
    rank's slice of the layer's KV (``rules.cache_specs``).

    The attention itself is the train step's (:func:`attention`): K3 on
    the rank's query heads and the kv heads they read, ``wo`` row-parallel
    (or, where ``model`` cannot give each rank whole heads, every head on
    every rank).  The cache: with the kv heads over ``model`` the rank's
    kv heads are the ones it holds, written at ``[start, start + s)``.
    With the positions over ``model`` the rank holds every kv head of its
    positions: it projects k / v of every kv head (``wk`` / ``wv``
    gathered whole over ``model``, one all-gather of each a layer) on the
    rows of the prompt that fall in its positions, from the whole sequence
    it gathered for its heads, and writes them.  That moves 2 d nkv hd
    weight elements a layer a rank, where an all-to-all of the ranks' k /
    v would move 2 b s nkv hd / model activations."""
    s = tp.seq
    positions = start + torch.arange(s, device=x.device)[None, :]
    kv = tp.kv
    if not tp.split_heads:
        local = _whole_weights(p, tp, path)

        def whole(xw):
            q, k, v = _project_qkv(local, cfg, xw, positions)
            _write_rows(cache, k, v, start, kv["pos"])
            return _attend(local, cfg, q, k, v, xw.dtype)
        return tp.whole_mixer(whole, x)
    local = _rank_weights(p, tp, path)
    xw = tp.enter(x)
    q, k, v = _project_qkv(local, cfg, xw, positions)
    if kv["layout"] == "heads":
        _write_rows(cache, k, v, start, kv["pos"])
    else:
        full = {name: None if p[name] is None else
                tp.whole(p[name], f"{path}/{name}")
                for name in ("wk", "wv", "bk", "bv", "k_norm")}
        p0, p1 = kv["pos"]
        lo, hi = max(p0, start), min(p1, start + s)
        if hi > lo:
            kr, vr = _project_kv(full, cfg, xw[:, lo - start:hi - start],
                                 positions[:, lo - start:hi - start])
            _write_rows(cache, kr, vr, lo, kv["pos"])
    return tp.exit(_attend(local, cfg, q, k, v, xw.dtype))


def _write_rows(cache: KVCache, k, v, start: int, held) -> None:
    """k / v (b, s, heads, hd) of positions ``[start, start + s)`` into the
    rank's slice ``cache`` of positions ``held`` = [p0, p1): the rows that
    fall in it."""
    p0, p1 = held
    lo, hi = max(p0, start), min(p1, start + k.shape[1])
    if hi > lo:
        cache.k[:, lo - p0:hi - p0] = k[:, lo - start:hi - start]
        cache.v[:, lo - p0:hi - p0] = v[:, lo - start:hi - start]


def _bmm_f32(a, b):
    """a @ b batched, accumulated and returned in fp32, for inputs in the
    cache's dtype (bf16 products are exact in fp32)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    return torch.bmm(a, b, out_dtype=torch.float32)


def _token_attention(cfg: ModelConfig, q, k_l, v_l, pos, per_slot: bool,
                     upcast: Optional[bool] = None):
    """The one-token masked attention shared by every decode variant
    (dense, paged, paged view): q (b, 1, nh, hd) against k_l/v_l
    (b, t, nkv, hd), valid where ``kpos <= pos``; returns the fp32
    (b, nkv, group, hd) heads.  Scores and P.V accumulate in fp32;
    probabilities are rounded to the cache's dtype before P.V, as in the
    reference.

    ``upcast`` (default: on a CPU tensor only; a ``meta`` tensor, which
    the dry run counts for the card, takes the card's form) is the plain
    version: q, k and v upcast to fp32.  Otherwise the cache is read as
    it lies, in its own dtype, with no copy: one batched GEMM of every query head against
    the keys of every kv head (rows (t, kv head) of the contiguous
    (b, t * nkv, hd) view), whose GQA pairs are a diagonal view of the fp32
    result; P.V likewise against the (b, t, nkv * hd) view.  That
    multiplies the FLOPs of a memory-bound product by nkv in place of an
    fp32 copy of the whole cache per layer (chip_smoke phase 3 times both
    forms on the card)."""
    if upcast is None:
        upcast = q.device.type == "cpu"
    b, nh, hd = q.shape[0], q.shape[2], q.shape[3]
    nkv = k_l.shape[2]
    group = nh // nkv
    t = k_l.shape[1]
    if upcast:
        qg = q.reshape(b, nkv, group, hd)
        scores = torch.einsum("bngh,btnh->bngt", qg.float(),
                              k_l.float()) / math.sqrt(hd)
    else:
        s_all = _bmm_f32(q.reshape(b, nh, hd),
                         k_l.reshape(b, t * nkv, hd).transpose(1, 2))
        scores = s_all.view(b, nkv, group, t, nkv).diagonal(
            dim1=1, dim2=4).permute(0, 3, 1, 2) / math.sqrt(hd)
    kpos = torch.arange(t, device=q.device)[None, None, None, :]
    limit = pos[:, None, None, None] if per_slot else pos
    scores = scores.masked_fill(kpos > limit, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v_l.dtype)
    if upcast:
        return torch.einsum("bngt,btnh->bngh", probs.float(), v_l.float())
    o_all = _bmm_f32(probs.reshape(b, nh, t), v_l.reshape(b, t, nkv * hd))
    return o_all.view(b, nkv, group, nkv, hd).diagonal(
        dim1=1, dim2=3).permute(0, 3, 1, 2)


def _attend_token(cfg: ModelConfig, q, k_l, v_l, pos, per_slot: bool,
                  x_dtype, wo):
    """:func:`_token_attention` through the output projection.  One code
    path for every decode variant is what makes paged decode bitwise the
    dense computation."""
    out = _token_attention(cfg, q, k_l, v_l, pos, per_slot)
    return out.to(x_dtype).reshape(q.shape[0], 1, -1) @ wo


def _write_token(k_l, v_l, k_new, v_new, pos):
    """Write one token's k/v (b, nkv, hd) into each slot's row of k_l/v_l
    (b, t, nkv, hd) at its own position ``pos`` (b,), in place; a slot at
    ``pos >= t`` writes nothing (a rewrite of the value at t - 1).  No host
    sync."""
    b, t = k_l.shape[:2]
    slots = torch.arange(b, device=k_l.device)
    idx = pos.clamp(max=t - 1)
    keep = (pos >= t)[:, None, None]
    k_new = torch.where(keep, k_l[slots, idx], k_new.to(k_l.dtype))
    v_new = torch.where(keep, v_l[slots, idx], v_new.to(v_l.dtype))
    k_l.index_put_((slots, idx), k_new)
    v_l.index_put_((slots, idx), v_new)


def attention_decode_inplace(p, cfg: ModelConfig, x, ck, cv, li: int, pos,
                             path: str = "blocks/attn"):
    """One-token decode against LAYER-STACKED caches ck/cv
    (L, b, max_seq, nkv, hd); li: layer index; returns (out, ck, cv).

    The token's k/v are written into ck/cv IN PLACE with ``index_put_`` (the
    reference's functional update, aliased by XLA, becomes a real in-place
    write): one token-sized write per layer, no copy of the cache.

    ``pos`` is a scalar (every slot at the same position; like the
    reference's dynamic-update-slice the write index clamps to the last
    position) or a (b,) tensor (each slot at its own position; a slot whose
    position has run past max_seq writes nothing, the reference's
    ``mode='drop'``).  No host sync: the drop is a masked rewrite of the
    clamped slot."""
    b = x.shape[0]
    t = ck.shape[2]
    pos = torch.as_tensor(pos, dtype=torch.long, device=x.device)
    per_slot = pos.ndim == 1
    positions = pos[:, None] if per_slot else pos.expand(b, 1)
    tp = ctx.get_tensor_parallel()
    if tp is not None:
        return _decode_model_axis(p, cfg, x, ck[li], cv[li], pos, positions,
                                  tp, path), ck, cv
    q, k, v = _project_qkv(p, cfg, x, positions)
    k_l, v_l = ck[li], cv[li]            # views: writes land in ck / cv
    if per_slot:
        _write_token(k_l, v_l, k[:, 0], v[:, 0], pos)
    else:
        slots = torch.arange(b, device=x.device)
        idx = pos.clamp(0, t - 1).expand(b)
        k_l.index_put_((slots, idx), k[:, 0].to(ck.dtype))
        v_l.index_put_((slots, idx), v[:, 0].to(cv.dtype))
    return _attend_token(cfg, q, k_l, v_l, pos, per_slot, x.dtype,
                         p["wo"]), ck, cv


def _decode_model_axis(p, cfg: ModelConfig, x, k_l, v_l, pos, positions,
                       tp, path: str = "blocks/attn"):
    """:func:`attention_decode_inplace` on a serving step's model axis:
    ``x`` (b, 1, d) the same on every rank, ``k_l`` / ``v_l`` the rank's
    slice of one layer's KV (``rules.cache_specs``), ``pos`` global.

    Kv heads over ``model``: the rank projects its query and kv heads,
    writes its kv heads at ``pos`` and attends with them alone, ``wo``
    row-parallel and the partial sums all-reduced.  Positions over
    ``model``: the rank projects its heads as well, and the token's query
    and kv heads are all-gathered over ``model``; the rank that holds
    ``pos`` writes the token (per slot, where ``pos`` is a tensor), and
    each rank computes the partial attention of every query head against
    its positions.  The partials merge by log-sum-exp over ``model``, all
    in fp32: the scores' maximum (an all-reduce max), then the sums of
    ``exp(score - max)`` and of their products with v (one all-reduce).
    The rank then takes its heads of the merged output through its rows of
    ``wo``.  Where ``model`` cannot give each rank whole heads, every rank
    projects every head with the weights gathered whole, and ``wo`` whole
    gives the output on every rank alike."""
    kv = tp.kv
    p0 = kv["pos"][0]
    if not tp.split_heads:
        local = _whole_weights(p, tp, path)
        q, k, v = _project_qkv(local, cfg, x, positions)
        _write_token_at(k_l, v_l, k[:, 0], v[:, 0], pos, p0, kv["max_seq"])
        out = _merged_token_attention(q, k_l, v_l, pos, p0, tp,
                                      kv["layout"] == "seq")
        return out.to(x.dtype).reshape(x.shape[0], 1, -1) @ local["wo"]
    local = _rank_weights(p, tp, path)
    q, k, v = _project_qkv(local, cfg, tp.enter(x), positions)
    per_slot = pos.ndim == 1
    if kv["layout"] == "heads":
        _write_token_at(k_l, v_l, k[:, 0], v[:, 0], pos, p0, kv["max_seq"])
        out = _token_attention(cfg, q, k_l, v_l, pos, per_slot)
    else:
        q_all = tp.group.all_gather(q, 2)      # every query head
        _write_token_at(k_l, v_l, tp.gather_kv(k)[:, 0],
                        tp.gather_kv(v)[:, 0], pos, p0, kv["max_seq"])
        out = _merged_token_attention(q_all, k_l, v_l, pos, p0, tp,
                                      kv["layout"] == "seq")
        h0 = tp.q_cols[0] // cfg.hd
        out = out.flatten(1, 2)[:, h0:h0 + q.shape[2]]
    y = out.to(x.dtype).reshape(x.shape[0], 1, -1) @ local["wo"]
    return tp.exit(y)


def _write_token_at(k_l, v_l, k_new, v_new, pos, p0: int,
                    max_seq: int) -> None:
    """One token's k / v (b, nkv, hd) into a slice ``k_l`` / ``v_l`` (b, t,
    nkv, hd) that holds the global positions [p0, p0 + t) of a cache of
    ``max_seq``: each slot's row at ``pos`` where this slice holds it, in
    place; elsewhere a rewrite of the value already there.  ``pos`` is a
    scalar (clamped to the last position, as :func:`attention_decode_
    inplace`'s) or a (b,) tensor (a slot at ``pos >= max_seq`` writes
    nothing).  No host sync."""
    b, t = k_l.shape[:2]
    slots = torch.arange(b, device=k_l.device)
    if pos.ndim == 1:
        at, live = pos, pos < max_seq
    else:
        at, live = pos.clamp(0, max_seq - 1).expand(b), True
    here = live & (at >= p0) & (at < p0 + t)
    idx = (at - p0).clamp(0, t - 1)
    keep = ~here[:, None, None] if torch.is_tensor(here) else False
    k_new = torch.where(keep, k_l[slots, idx], k_new.to(k_l.dtype))
    v_new = torch.where(keep, v_l[slots, idx], v_new.to(v_l.dtype))
    k_l.index_put_((slots, idx), k_new)
    v_l.index_put_((slots, idx), v_new)


def _merged_token_attention(q, k_l, v_l, pos, p0: int, tp, merge: bool):
    """The one-token attention of every query head ``q`` (b, 1, nh, hd)
    against a slice of the cache (b, t, nkv, hd) holding positions
    [p0, p0 + t), valid where ``kpos <= pos``, in fp32; with ``merge`` the
    slices of the ranks of ``model`` merged by log-sum-exp (a max and the
    sums of ``l`` and ``o`` over the group).  Returns the fp32 (b, nkv,
    group, hd) heads, as :func:`_token_attention`."""
    b, _, nh, hd = q.shape
    t, nkv = k_l.shape[1], k_l.shape[2]
    qg = q.reshape(b, nkv, nh // nkv, hd).float()
    scores = torch.einsum("bngh,btnh->bngt", qg,
                          k_l.float()) / math.sqrt(hd)
    kpos = p0 + torch.arange(t, device=q.device)[None, None, None, :]
    limit = pos[:, None, None, None] if pos.ndim == 1 else pos
    scores = scores.masked_fill(kpos > limit, float("-inf"))
    top = scores.amax(dim=-1, keepdim=True)
    if merge:
        top = tp.group.all_reduce_(top.contiguous(), op="max")
    e = torch.exp(scores - top)
    lo = torch.cat([e.sum(dim=-1, keepdim=True),
                    torch.einsum("bngt,btnh->bngh", e, v_l.float())], -1)
    if merge:
        lo = tp.group.all_reduce_(lo.contiguous())
    return lo[..., 1:] / lo[..., :1]


# ---------------------------------------------------------------------------
# chunked prefill against the cache
# ---------------------------------------------------------------------------

def _masked_attend(cfg: ModelConfig, q, k_all, v_all, qpos, kpos):
    """fp32 masked attention of q (b, sq, nh, hd) against a KV view
    (b, t, nkv, hd); valid where kpos (b|1, t) <= qpos (b, sq).  Plain
    PyTorch in the reference's einsum/softmax discipline (no K3: the
    reference's continuation chunks do not reach its Pallas kernel)."""
    b, sq, nh, hd = q.shape
    nkv = k_all.shape[2]
    qg = q.reshape(b, sq, nkv, nh // nkv, hd)
    scores = torch.einsum("bsngh,btnh->bngst", qg.float(),
                          k_all.float()) / math.sqrt(hd)
    valid = kpos[:, None, None, None, :] <= qpos[:, None, None, :, None]
    scores = scores.masked_fill(~valid, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngst,btnh->bsngh", probs, v_all.float())
    return out.reshape(b, sq, nh, hd)


def attention_prefill_cached(p, cfg: ModelConfig, x, cache: KVCache, start):
    """Continuation prefill for a CHUNKED prompt against one layer's dense
    cache (b, max_seq, nkv, hd): write this chunk's k/v at
    [start, start+s), in place, and attend q against the whole cache masked
    by ``kpos <= qpos``, so a prompt split across chunk boundaries sees
    what a single-call prefill would.  Rows of a padded tail chunk past
    ``max_seq`` are dropped (never clamped onto earlier positions)."""
    b, s, _ = x.shape
    t = cache.k.shape[1]
    positions = start + torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    n = max(0, min(s, t - start))
    cache.k[:, start:start + n] = k[:, :n]
    cache.v[:, start:start + n] = v[:, :n]
    kpos = torch.arange(t, device=x.device)[None, :]
    out = _masked_attend(cfg, q, cache.k, cache.v, positions, kpos)
    return out.to(x.dtype).reshape(b, s, -1) @ p["wo"], cache


# ---------------------------------------------------------------------------
# paged KV: page-mapped variants of prefill/decode (serve.paged owns the
# host-side block pool; table entries n_blocks are the sentinel, writes
# through them land in the trash page, reads through them are masked)
# ---------------------------------------------------------------------------

def init_paged_kv(cfg: ModelConfig, n_blocks: int, block_size: int,
                  device=None, layers: Optional[int] = None) -> KVCache:
    """A zero page pool: (n_blocks + 1, block_size, nkv, hd) pages, the
    last the trash page that dropped writes land in; with ``layers``, one
    such pool a layer, stacked on a leading axis."""
    shape = (n_blocks + 1, block_size, cfg.n_kv_heads, cfg.hd)
    if layers is not None:
        shape = (layers,) + shape
    kw = dict(dtype=cfg.torch_dtype, device=device)
    return KVCache(torch.zeros(shape, **kw), torch.zeros(shape, **kw))


def _page_slots(pos, bt, block_size: int, n_blocks: int):
    """(page, offset) for per-slot positions (b,) against per-slot table
    rows bt (b, max_blocks); positions past the table and sentinel entries
    map to page ``n_blocks``, the trash page."""
    b, mb = bt.shape
    idx = pos // block_size
    page = bt[torch.arange(b, device=bt.device), idx.clamp(0, mb - 1)]
    page = torch.where(idx < mb, page, n_blocks).clamp(max=n_blocks)
    return page, pos % block_size


def _pages_for_positions(pos, bt_row, block_size: int, n_blocks: int):
    """(page, offset) for a vector of positions against ONE table row;
    out-of-table positions and sentinel entries map to the trash page."""
    mb = bt_row.shape[0]
    idx = pos // block_size
    page = bt_row[idx.clamp(0, mb - 1)]
    page = torch.where(idx < mb, page, n_blocks).clamp(max=n_blocks)
    return page, pos % block_size


def _gather_pages(pool, bt):
    """A per-slot logical view of a page pool: pool (n_blocks + 1,
    block_size, nkv, hd), bt (b, max_blocks) -> (b, max_blocks *
    block_size, nkv, hd).  Sentinel entries read the trash page; their
    positions lie past every valid ``kpos <= pos``, so they are masked."""
    return pool[bt].reshape(bt.shape[0], -1, *pool.shape[2:])


def paged_attention_prefill(p, cfg: ModelConfig, x, ck, cv, li: int, bt_row,
                            start: int, *, first: bool):
    """Prefill one prompt chunk into LAYER-STACKED page pools, in place.

    x: (1, s, d); ck/cv: (L, n_blocks + 1, block_size, nkv, hd); bt_row:
    the slot's (max_blocks,) block-table row; start: the chunk's offset.
    k/v are scattered page by page (writes through sentinel or overflow
    entries land in the trash page).

    ``first`` selects the attention: the first chunk attends within x
    exactly like the dense :func:`attention_prefill` (through K3), so a
    paged engine is token-identical to the dense one for prompts that fit
    one chunk; continuation chunks gather the slot's pages and attend
    masked by ``kpos <= qpos``."""
    b, s, _ = x.shape
    n_blocks, bs = ck.shape[1] - 1, ck.shape[2]
    positions = start + torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    page, off = _pages_for_positions(positions[0], bt_row, bs, n_blocks)
    ck[li].index_put_((page, off), k[0].to(ck.dtype))
    cv[li].index_put_((page, off), v[0].to(cv.dtype))
    if first:
        return _attend(p, cfg, q, k, v, x.dtype), ck, cv
    k_all = _gather_pages(ck[li], bt_row[None])
    v_all = _gather_pages(cv[li], bt_row[None])
    kpos = torch.arange(k_all.shape[1], device=x.device)[None, :]
    out = _masked_attend(cfg, q, k_all, v_all, positions, kpos)
    return out.to(x.dtype).reshape(b, s, -1) @ p["wo"], ck, cv


def paged_attention_decode_inplace(p, cfg: ModelConfig, x, ck, cv, li: int,
                                   pos, bt):
    """One-token decode against layer-stacked page pools: the paged twin of
    :func:`attention_decode_inplace`'s per-slot path.

    ck/cv: (L, n_blocks + 1, block_size, nkv, hd); pos: (b,) per-slot
    positions; bt: (b, max_blocks) block tables.  The new token is written
    through the table (a parked lane, at ``pos == max_seq``, writes into
    the trash page); the read gathers each slot's pages into a
    (b, max_blocks * block_size, nkv, hd) view and runs :func:`_attend_token`
    on it, so paged decode is bitwise the dense computation when
    ``max_blocks * block_size == max_seq``."""
    b = x.shape[0]
    n_blocks, bs = ck.shape[1] - 1, ck.shape[2]
    pos = torch.as_tensor(pos, dtype=torch.long, device=x.device)
    if pos.ndim == 0:
        pos = pos.expand(b)
    q, k, v = _project_qkv(p, cfg, x, pos[:, None])
    page, off = _page_slots(pos, bt, bs, n_blocks)
    ck[li].index_put_((page, off), k[:, 0].to(ck.dtype))
    cv[li].index_put_((page, off), v[:, 0].to(cv.dtype))
    k_all = _gather_pages(ck[li], bt)
    v_all = _gather_pages(cv[li], bt)
    return _attend_token(cfg, q, k_all, v_all, pos, True, x.dtype,
                         p["wo"]), ck, cv


def gather_paged_view(ck, cv, bt):
    """The per-slot logical view of layer-stacked page pools: ck/cv
    (L, n_blocks + 1, block_size, nkv, hd), bt (b, max_blocks) ->
    (L, b, max_blocks * block_size, nkv, hd) pairs, shaped like the dense
    layer-stacked cache.  The decode chunk gathers it ONCE per chunk and
    updates it per token (:func:`paged_attention_decode_view`), so the page
    indirection is paid per chunk, not per token and layer."""
    n_layers = ck.shape[0]
    vk = ck[:, bt].reshape(n_layers, bt.shape[0], -1, *ck.shape[3:])
    vv = cv[:, bt].reshape(n_layers, bt.shape[0], -1, *cv.shape[3:])
    return vk, vv


def paged_attention_decode_view(p, cfg: ModelConfig, x, ck, cv, vk, vv,
                                li: int, pos, bt):
    """One-token decode against a pre-gathered per-slot view, in place.

    Attention and the view's update are the dense per-slot path of
    :func:`attention_decode_inplace` on (vk, vv), bitwise the dense
    computation; the new token is ALSO written into the page pool (ck, cv)
    through the block table, so the pool stays the source of truth across
    chunk boundaries.  A parked lane's writes drop both ways (past the view
    / into the trash page)."""
    b = x.shape[0]
    n_blocks, bs = ck.shape[1] - 1, ck.shape[2]
    pos = torch.as_tensor(pos, dtype=torch.long, device=x.device)
    if pos.ndim == 0:
        pos = pos.expand(b)
    q, k, v = _project_qkv(p, cfg, x, pos[:, None])
    _write_token(vk[li], vv[li], k[:, 0], v[:, 0], pos)
    page, off = _page_slots(pos, bt, bs, n_blocks)
    ck[li].index_put_((page, off), k[:, 0].to(ck.dtype))
    cv[li].index_put_((page, off), v[:, 0].to(cv.dtype))
    return _attend_token(cfg, q, vk[li], vv[li], pos, True, x.dtype,
                         p["wo"]), ck, cv, vk, vv
