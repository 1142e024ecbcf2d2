"""Model assembly for the transformer families (dense, moe, vlm, audio):
pre-norm GQA transformer blocks and the Model API (forward / loss /
init_cache / prefill / decode_step, and the paged serving cache:
init_paged_cache / prefill_paged / gather_paged_view).

The port of ``repro.models.transformer.Model`` for every family that runs
the transformer block:

  * ``dense``: SwiGLU MLP;
  * ``moe`` (dbrx, grok): the MoE FFN (``ffn.moe``; inside a sharded train
    step on a mesh with a ``model`` axis, the expert-parallel all-to-all
    ``moe_ep.moe_ep``, wherever the reference takes it), its Switch
    load-balancing aux summed over layers and added to the loss as
    ``0.01 * aux``;
  * ``vlm`` (chameleon): the dense block over early-fusion token ids (the
    image frontend is a stub in the reference too);
  * ``audio`` (musicgen): ``n_codebooks`` embedding tables, one lookup
    each, summed; tokens are (b, s, K), the head one (d, vocab).

Params are a plain dict: ``embed`` (vocab, d) or (K, vocab, d), ``ln_f``
(d,), ``head`` (d, vocab) and ``blocks``, a list with one dict per layer
(``ln1``, ``attn``, ``ln2``, ``mlp``: the MLP's or the MoE's leaves) in
place of the reference's stacked leading layer axis; the layer loop is a
Python loop in place of ``lax.scan``.  The KV cache is layer-stacked as in
the reference and is updated in place.  The recurrent families (ssm,
hybrid) wait for their slice of the port (ROADMAP.md queue 1 item 8), so
the recurrent staging state of the paged methods is always None here.
Serving (``prefill``, ``prefill_paged``, ``decode_step``) always runs
``ffn.moe``, never the expert-parallel path, as the reference does.

Training: with ``cfg.remat`` and grad mode on, ``forward`` runs each block
under ``torch.utils.checkpoint`` (non-reentrant), as the reference runs its
scanned block under ``jax.checkpoint``: a block's activations (its aux
included) are recomputed in the backward, only its input is kept.  K1 and
K3 are differentiable there (their ``autograd.Function``s, backward
kernels on the card).

On a tensor-parallel train step's mesh (``sharding.ctx.
get_tensor_parallel()`` set) the same code runs each rank's part:
the vocab-parallel embedding (the audio family's K lookups summed before
SP's reduce-scatter), the blocks on the rank's sequence rows (their
attention and MLP on its heads and ff columns between SP's all-gather and
reduce-scatter: ``attention.attention``, ``ffn.mlp``; a MoE FFN on its
rows through the all-to-all), and the final norm and the head, gathered
whole over ``model``, on its rows; collectives inside remat's block run
again in its recompute."""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device, resolve_or_meta
from repro_torch.sharding import ctx
from . import attention as attn_mod
from . import ffn as ffn_mod
from . import moe_ep
from .attention import KVCache
from .common import ModelConfig, cross_entropy, init_dense, rmsnorm

FAMILIES = ("dense", "moe", "vlm", "audio")


def _norm_weight(w, path: str):
    """A block norm's weight, whole (``TensorParallel.norm_weight`` inside
    a tensor-parallel step)."""
    tp = ctx.get_tensor_parallel()
    return w if tp is None else tp.norm_weight(w, path)


def _ffn(p, cfg: ModelConfig, y):
    """The serving FFN: the MLP, or ``ffn.moe`` (its aux dropped)."""
    if cfg.n_experts:
        return ffn_mod.moe(p, cfg, y)[0]
    return ffn_mod.mlp(p, y)


def _block_fwd(p, cfg: ModelConfig, x, positions):
    """One block: ``(x, aux)``, aux the MoE's load-balancing term (None for
    the MLP)."""
    # FSDP: the layer's whole weights, gathered here so that remat gathers
    # them again in its recompute (the identity outside a sharded step)
    p = ctx.gathered(p, "blocks")
    # the reference's sequence-parallel boundaries: the identity with no
    # mesh or a mesh whose model axis has size 1; on a tensor-parallel
    # step's model axis x is this rank's sequence rows (ctx.constraint),
    # K1 normalises them and attention / mlp gather the whole sequence
    x = ctx.constraint(x, ctx.dp_axes(), "model", None)
    h = x + attn_mod.attention(
        p["attn"], cfg,
        rmsnorm(x, _norm_weight(p["ln1"], "blocks/ln1"), cfg.norm_eps),
        positions)
    h = ctx.constraint(h, ctx.dp_axes(), "model", None)
    y = rmsnorm(h, _norm_weight(p["ln2"], "blocks/ln2"), cfg.norm_eps)
    if not cfg.n_experts:
        return h + ffn_mod.mlp(p["mlp"], y), None
    if moe_ep.applicable(cfg, ctx.get_mesh()):
        out, aux = moe_ep.moe_ep(p["mlp"], cfg, y)
    else:
        if ctx.get_tensor_parallel() is not None:
            raise NotImplementedError(
                f"{cfg.name}: {cfg.n_experts} experts on a model axis that "
                f"does not divide them: the reference's GSPMD MoE with its "
                f"experts' ff dim over 'model' is not ported")
        out, aux = ffn_mod.moe(p["mlp"], cfg, y)
    return h + out, aux


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet; the port runs "
                f"{list(FAMILIES)} (see ROADMAP.md, queue 1 item 8)")
        self.cfg = cfg
        self._last_aux = None

    # -- init ---------------------------------------------------------------
    def init_params(self, generator: torch.Generator,
                    device: DeviceLike = None) -> Dict:
        """Random params drawn from ``generator`` on ``device`` (the CUDA
        device unless ``"cpu"`` is given; the generator must live there):
        the reference's distributions, torch's random bits.  ``"meta"``
        gives the shapes and dtypes alone (any generator)."""
        cfg = self.cfg
        device = resolve_or_meta(device)
        if device.type != "meta" and generator.device.type != device.type:
            raise ValueError(f"generator on {generator.device} cannot draw "
                             f"params for {device}")
        dt = cfg.torch_dtype
        ones = lambda: torch.ones((cfg.d_model,), dtype=dt,  # noqa: E731
                                  device=device)
        table = lambda: init_dense(generator, cfg.vocab,  # noqa: E731
                                   cfg.d_model, dt, scale=0.02, device=device)
        embed = (torch.stack([table() for _ in range(cfg.n_codebooks)])
                 if cfg.n_codebooks else table())
        ffn = ffn_mod.init_moe if cfg.n_experts else ffn_mod.init_mlp
        blocks = [{"ln1": ones(),
                   "attn": attn_mod.init_attn(generator, cfg, device),
                   "ln2": ones(),
                   "mlp": ffn(generator, cfg, device=device)}
                  for _ in range(cfg.n_layers)]
        return {"embed": embed, "blocks": blocks, "ln_f": ones(),
                "head": init_dense(generator, cfg.d_model, cfg.vocab, dt,
                                   device=device)}

    # -- embedding ----------------------------------------------------------
    def embed(self, params, tokens):
        """The embedding of ``tokens`` (b, s), or (b, s, K) for the audio
        family, whose K codebook lookups are summed in order."""
        return lookup(params["embed"], tokens)

    # -- forward (scoring) ---------------------------------------------------
    def forward(self, params, tokens):
        """tokens (b, s[, K]) -> logits (b, s, vocab).  Inside a
        tensor-parallel train step (``sharding.ctx.get_tensor_parallel()``):
        the logits of this rank's sequence rows ``tp.rows`` alone, (b, rows,
        vocab), from the vocab-parallel embedding and the head gathered
        whole over ``model``.  The MoE's aux, summed over layers, is left
        in ``self._last_aux`` (None for the other families), as the
        reference leaves it."""
        cfg = self.cfg
        tp = ctx.get_tensor_parallel()
        embed = ctx.gathered(params["embed"], "embed")
        x = lookup(embed, tokens) if tp is None else tp.embed(embed, tokens)
        b, s = tokens.shape[:2]
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        remat = cfg.remat and torch.is_grad_enabled()
        aux = None
        for layer in params["blocks"]:
            if remat:
                # the model draws no random numbers: no RNG state to stash
                x, a = checkpoint(_block_fwd, layer, cfg, x, positions,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a = _block_fwd(layer, cfg, x, positions)
            if a is not None:
                aux = a if aux is None else aux + a
        self._last_aux = aux
        ln_f = ctx.gathered(params["ln_f"], "ln_f")
        head = ctx.gathered(params["head"], "head")
        if tp is not None:
            x, ln_f, head = (tp.own(x), tp.whole(ln_f, "ln_f"),
                             tp.whole(head, "head"))
        return rmsnorm(x, ln_f, cfg.norm_eps) @ head

    def loss(self, params, batch):
        """Mean next-token cross entropy (fp32, z-loss 1e-4, labels -100
        masked) of ``batch["tokens"]`` (b, s[, K]) against
        ``batch["labels"]`` (b, s), plus ``0.01 * aux`` for the MoE family
        (``self._last_aux`` holds the aux after the call); inside a
        tensor-parallel step, the cross entropy is the mean over this
        rank's sequence rows (the step scales it by their share of the
        tokens, and weighs the aux by its own rule)."""
        logits = self.forward(params, batch["tokens"])
        labels = batch["labels"]
        tp = ctx.get_tensor_parallel()
        if tp is not None:
            # the rank's sequence rows: its share of the step's tokens
            labels = labels[:, tp.rows[0]:tp.rows[1]]
        loss = cross_entropy(logits, labels)
        if self.cfg.n_experts:
            loss = loss + 0.01 * self._last_aux
        return loss

    # -- serving -------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int,
                   device: DeviceLike = None) -> KVCache:
        """Zero KV cache, layer-stacked: k/v (L, batch, max_seq, nkv, hd)
        (``"meta"``: the shapes alone)."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
        kw = dict(dtype=cfg.torch_dtype, device=resolve_or_meta(device))
        return KVCache(torch.zeros(shape, **kw), torch.zeros(shape, **kw))

    # -- paged serving cache -------------------------------------------------
    def init_paged_cache(self, batch: int, max_seq: int, *, n_blocks: int,
                         block_size: int, device: DeviceLike = None
                         ) -> KVCache:
        """The ``kv_layout="paged"`` engine cache: layer-stacked page pools
        (L, n_blocks + 1, block_size, nkv, hd), the last page of each the
        trash page (``repro_torch.models.attention``).  No slot axis: slots
        map into the pool through their block tables, so ``batch`` and
        ``max_seq`` (kept for the reference's signature) size nothing."""
        return attn_mod.init_paged_kv(self.cfg, n_blocks, block_size,
                                      resolve_device(device),
                                      layers=self.cfg.n_layers)

    def split_paged_cache(self, cache):
        """(kv pools, slot-indexed recurrent state): the state is None for
        the transformer families."""
        return cache, None

    def merge_paged_cache(self, kv, state):
        """Inverse of :meth:`split_paged_cache`."""
        return kv

    def init_prefill_state(self, batch: int = 1):
        """Recurrent staging state for a chunked admission: None for the
        transformer families, whose prefill state lives entirely in the KV
        cache."""
        return None

    def prefill(self, params, tokens, cache: KVCache, start: int = 0,
                lengths: Optional[torch.Tensor] = None,
                attend_cache: bool = False):
        """Fill the cache with ``tokens`` (b, s[, K]) at [start, start+s);
        returns (last_logits (b, vocab), cache), the cache written in
        place.

        ``lengths`` ((b,) int) marks each row's real prompt length in a
        RIGHT-padded batch: logits are taken at ``lengths - 1``.  Causal
        masking keeps real tokens from attending to the padding, so a
        padded prefill is the unpadded computation.

        ``attend_cache=True`` is the CHUNKED-prefill continuation form:
        attention runs against the whole (updated) cache masked by
        ``kpos <= qpos`` instead of within ``tokens`` alone, so a chunk at
        offset ``start > 0`` sees every earlier chunk's positions."""
        cfg = self.cfg
        x = self.embed(params, tokens)
        attend = (attn_mod.attention_prefill_cached if attend_cache
                  else attn_mod.attention_prefill)
        for li, layer in enumerate(params["blocks"]):
            h_in = rmsnorm(x, layer["ln1"], cfg.norm_eps)
            y, _ = attend(layer["attn"], cfg, h_in,
                          KVCache(cache.k[li], cache.v[li]), start)
            h = x + y
            x = h + _ffn(layer["mlp"], cfg,
                         rmsnorm(h, layer["ln2"], cfg.norm_eps))
        return self._last_logits(params, x, lengths), cache

    def _last_logits(self, params, x, lengths):
        """Final norm and head at each row's last real position."""
        b, s = x.shape[:2]
        x = rmsnorm(x, params["ln_f"], self.cfg.norm_eps)
        if lengths is None:
            x_last = x[:, -1]
        else:
            idx = (torch.as_tensor(lengths, device=x.device).long() - 1
                   ).clamp(0, s - 1)
            x_last = x[torch.arange(b, device=x.device), idx]
        return x_last @ params["head"]

    def prefill_paged(self, params, tokens, kv: KVCache, bt_row, state,
                      start: int, lengths, *, first: bool):
        """Prefill one prompt chunk of ONE slot into the paged pools, in
        place.

        tokens: (1, s[, K]); kv: the engine's pools
        (:meth:`split_paged_cache`);
        bt_row: the slot's (max_blocks,) block-table row; state: the
        recurrent staging state (None here); start: the chunk's
        offset; lengths: (1,) real token count WITHIN this chunk.  Returns
        (last_logits, kv, state).

        ``first`` is the chunk-0 form: attention runs within ``tokens``
        exactly like the dense admission prefill; continuation chunks
        gather the slot's pages and attend ``kpos <= qpos``."""
        cfg = self.cfg
        x = self.embed(params, tokens)
        for li, layer in enumerate(params["blocks"]):
            h_in = rmsnorm(x, layer["ln1"], cfg.norm_eps)
            y, _, _ = attn_mod.paged_attention_prefill(
                layer["attn"], cfg, h_in, kv.k, kv.v, li, bt_row, start,
                first=first)
            h = x + y
            x = h + _ffn(layer["mlp"], cfg,
                         rmsnorm(h, layer["ln2"], cfg.norm_eps))
        return self._last_logits(params, x, lengths), kv, state

    def gather_paged_view(self, cache: KVCache, block_tables):
        """The per-slot logical (vk, vv) view of a paged cache's pools,
        gathered once per decode chunk (see
        :func:`repro_torch.models.attention.gather_paged_view`)."""
        kv, _ = self.split_paged_cache(cache)
        return attn_mod.gather_paged_view(kv.k, kv.v, block_tables)

    def decode_step(self, params, token, cache: KVCache, pos,
                    block_tables=None, kv_view=None):
        """token: (b, 1[, K]) -> (logits (b, vocab), cache), the cache
        written in place at ``pos`` (a scalar, or a (b,) per-slot position
        tensor).

        ``block_tables`` ((b, max_blocks)) selects the PAGED path: the
        cache's leaves are page pools and attention goes through
        :func:`repro_torch.models.attention.paged_attention_decode_inplace`.
        With ``kv_view`` (the (vk, vv) pair from :meth:`gather_paged_view`)
        attention runs against the view, updated in place, and the return
        value is ``(logits, cache, view)``: the decode chunk's form."""
        cfg = self.cfg
        x = self.embed(params, token)
        for li, layer in enumerate(params["blocks"]):
            h = rmsnorm(x, layer["ln1"], cfg.norm_eps)
            if kv_view is not None:
                y, _, _, _, _ = attn_mod.paged_attention_decode_view(
                    layer["attn"], cfg, h, cache.k, cache.v, kv_view[0],
                    kv_view[1], li, pos, block_tables)
            elif block_tables is not None:
                y, _, _ = attn_mod.paged_attention_decode_inplace(
                    layer["attn"], cfg, h, cache.k, cache.v, li, pos,
                    block_tables)
            else:
                y, _, _ = attn_mod.attention_decode_inplace(
                    layer["attn"], cfg, h, cache.k, cache.v, li, pos)
            x = x + y
            x = x + _ffn(layer["mlp"], cfg,
                         rmsnorm(x, layer["ln2"], cfg.norm_eps))
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        logits = x[:, -1] @ params["head"]
        if kv_view is not None:
            return logits, cache, kv_view
        return logits, cache


def lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` (vocab, d) for ``tokens``; with codebooks, table
    (K, vocab, d) and tokens (..., K): the K lookups summed in order."""
    if table.ndim == 2:
        return table[tokens]
    x = table[0][tokens[..., 0]]
    for i in range(1, table.shape[0]):
        x = x + table[i][tokens[..., i]]
    return x
