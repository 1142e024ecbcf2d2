"""GQA multi-head attention, dense path: prefill (through the
flash-attention kernel K3) and one-token cached decode, qk_norm, bias.

The port of ``repro.models.attention``'s dense functions.  Layouts are the
reference's: activations (b, s, d); q (b, s, nh, hd); k/v and the KV cache
(b, s, nkv, hd), layer-stacked as (L, b, max_seq, nkv, hd).  Where JAX
returns an updated cache, the port writes the cache in place and says so.
Decode attention stays plain PyTorch, as the reference leaves it to XLA.
Paged KV arrives with its slice of the port (ROADMAP.md)."""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.kernels import ops
from .common import ModelConfig, apply_rope, init_dense, rmsnorm, rope_freqs


class KVCache(NamedTuple):
    k: torch.Tensor  # (..., b, max_seq, nkv, hd)
    v: torch.Tensor


def init_attn(generator: torch.Generator, cfg: ModelConfig
              ) -> Dict[str, Optional[torch.Tensor]]:
    d, nh, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt, dev = cfg.torch_dtype, generator.device
    zeros = lambda n: torch.zeros((n,), dtype=dt, device=dev)  # noqa: E731
    ones = lambda n: torch.ones((n,), dtype=dt, device=dev)    # noqa: E731
    return {
        "wq": init_dense(generator, d, nh * hd, dt),
        "wk": init_dense(generator, d, nkv * hd, dt),
        "wv": init_dense(generator, d, nkv * hd, dt),
        "wo": init_dense(generator, nh * hd, d, dt),
        "bq": zeros(nh * hd) if cfg.qkv_bias else None,
        "bk": zeros(nkv * hd) if cfg.qkv_bias else None,
        "bv": zeros(nkv * hd) if cfg.qkv_bias else None,
        "q_norm": ones(hd) if cfg.qk_norm else None,
        "k_norm": ones(hd) if cfg.qk_norm else None,
    }


def _project_qkv(p, cfg: ModelConfig, x, positions):
    """x: (b, s, d) -> q (b, s, nh, hd), k/v (b, s, nkv, hd), roped."""
    b, s, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if p["bq"] is not None:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, nh, hd)
    k = k.reshape(b, s, nkv, hd)
    v = v.reshape(b, s, nkv, hd)
    if p["q_norm"] is not None:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope_freqs(hd, cfg.rope_theta, positions)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _attend(p, cfg: ModelConfig, q, k, v, x_dtype):
    """Causal self-attention of projected q/k/v (one sequence per row,
    positions from 0) through the output projection: the part of the
    reference's ``attention`` after ``_project_qkv``.

    Always through ``ops.flash_attention``: K3 on a CUDA tensor, its plain
    version on a CPU tensor.  ``cfg.use_flash`` is kept in the config copy
    for parity with the reference and selects nothing here; the
    reference's einsum and chunked paths compute the same function."""
    b, s, nh, hd = q.shape
    nkv = cfg.n_kv_heads
    # at b == 1 the reshape is a strided view; K3 takes contiguous tensors
    qf = q.transpose(1, 2).reshape(b * nh, s, hd).contiguous()
    kf = k.transpose(1, 2).reshape(b * nkv, s, hd).contiguous()
    vf = v.transpose(1, 2).reshape(b * nkv, s, hd).contiguous()
    out = ops.flash_attention(qf, kf, vf, causal=True)
    out = out.reshape(b, nh, s, hd).transpose(1, 2)
    out = out.to(x_dtype).reshape(b, s, nh * hd)
    return out @ p["wo"]


def attention(p, cfg: ModelConfig, x, positions):
    """Full self-attention over x (training / prefill without cache)."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    return _attend(p, cfg, q, k, v, x.dtype)


def attention_prefill(p, cfg: ModelConfig, x, cache: KVCache,
                      start: int = 0):
    """Prefill: full attention over x AND the cache filled at
    [start, start+s).

    ``cache`` holds one layer's (b, max_seq, nkv, hd) buffers, written in
    place (the reference returns an updated copy).  q/k/v are projected
    once and shared by the cache write and the attention; the reference
    projects twice (its ``attention`` re-projects), which gives the same
    values and two more RMSNorm launches per layer under qk_norm."""
    b, s, _ = x.shape
    positions = start + torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    cache.k[:, start:start + s] = k
    cache.v[:, start:start + s] = v
    return _attend(p, cfg, q, k, v, x.dtype), cache


def _attend_token(cfg: ModelConfig, q, k_l, v_l, pos, per_slot: bool,
                  x_dtype, wo):
    """The one-token masked-attention tail of decode: q (b, 1, nh, hd)
    against k_l/v_l (b, t, nkv, hd), valid where ``kpos <= pos``.  Scores
    and P.V accumulate in fp32; probabilities are rounded to the cache's
    dtype before P.V, as in the reference."""
    b = q.shape[0]
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    qg = q.reshape(b, nkv, nh // nkv, hd)
    scores = torch.einsum("bngh,btnh->bngt", qg.float(),
                          k_l.float()) / math.sqrt(hd)
    kpos = torch.arange(k_l.shape[1], device=q.device)[None, None, None, :]
    limit = pos[:, None, None, None] if per_slot else pos
    scores = scores.masked_fill(kpos > limit, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngt,btnh->bngh", probs.to(v_l.dtype).float(),
                       v_l.float())
    out = out.to(x_dtype).reshape(b, 1, nh * hd)
    return out @ wo


def attention_decode_inplace(p, cfg: ModelConfig, x, ck, cv, li: int, pos):
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
    q, k, v = _project_qkv(p, cfg, x, positions)
    k_l, v_l = ck[li], cv[li]            # views: writes land in ck / cv
    slots = torch.arange(b, device=x.device)
    idx = (pos.clamp(max=t - 1) if per_slot
           else pos.clamp(0, t - 1).expand(b))
    k_new, v_new = k[:, 0].to(ck.dtype), v[:, 0].to(cv.dtype)
    if per_slot:
        keep = (pos >= t)[:, None, None]
        k_new = torch.where(keep, k_l[slots, idx], k_new)
        v_new = torch.where(keep, v_l[slots, idx], v_new)
    k_l.index_put_((slots, idx), k_new)
    v_l.index_put_((slots, idx), v_new)
    return _attend_token(cfg, q, k_l, v_l, pos, per_slot, x.dtype,
                         p["wo"]), ck, cv
