"""Model assembly for every family: blocks and the Model API (forward /
loss / init_cache / prefill / decode_step, and the paged serving cache:
init_paged_cache / prefill_paged / gather_paged_view).

The port of ``repro.models.transformer.Model``.  The families that run
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

and the recurrent families:

  * ``ssm`` (rwkv6): pre-norm time-mix / channel-mix blocks
    (``models.rwkv6``), no attention;
  * ``hybrid`` (zamba2): a mamba2 backbone (``models.mamba2``, each layer
    pre-normed by K1) in G = n_layers / attn_every groups, each group
    followed by ONE shared attention + MLP block (one set of weights,
    applied G times; its attention runs K3 at head dim d / n_heads).

Params are a plain dict: ``embed`` (vocab, d) or (K, vocab, d), ``ln_f``
(d,), ``head`` (d, vocab) and ``blocks``.  For the transformer families
``blocks`` is a list with one dict per layer (``ln1``, ``attn``, ``ln2``,
``mlp``: the MLP's or the MoE's leaves); for ssm one dict per layer
(``ln1``, ``ln2``, ``mix``: ``rwkv6``'s leaves); for the hybrid a dict:
``mamba`` and ``mamba_ln`` nested lists [group][layer] of one layer's
mamba2 leaves and norm weight, and ``shared_ln``, ``shared_attn``,
``shared_ln2``, ``shared_mlp`` once.  That replaces the reference's
stacked leading (L,) or (G, E) axes; the layer loop is a Python loop in
place of ``lax.scan``.  Serving (``prefill``, ``prefill_paged``,
``decode_step``) always runs ``ffn.moe``, never the expert-parallel
path, as the reference does.

Caches are the reference's trees, layer-stacked, and are written in
place: a ``KVCache`` (L, b, max_seq, nkv, hd) for the transformer
families; ``rwkv6.Rwkv6State`` stacked (L, b, ...) for ssm; ``{"mamba":
mamba2.Mamba2State stacked (G, E, b, ...), "kv": KVCache (G, b, max_seq,
nkv, hd)}`` for the hybrid.  In the paged layout the KV leaves are page
pools and the recurrent state stays slot-indexed (ssm's paged cache is
its dense cache).  Every recurrent state update is a ``copy_`` into the
cache's own tensors, so a decode chunk captured as a CUDA graph replays
into the buffers it was captured on.

Training: with ``cfg.remat`` and grad mode on, ``forward`` runs each block
under ``torch.utils.checkpoint`` (non-reentrant), as the reference runs its
scanned block under ``jax.checkpoint``: a block's activations (its aux
included) are recomputed in the backward, only its input is kept.  K1 and
K3 are differentiable there (their ``autograd.Function``s, backward
kernels on the card).  The recurrent families remat per layer (ssm) or
per group of ``attn_every`` mamba layers with the shared block (hybrid),
as the reference does; a group's recompute runs its time loops again.

On a tensor-parallel train step's mesh (``sharding.ctx.
get_tensor_parallel()`` set) the same code runs each rank's part:
the vocab-parallel embedding (the audio family's K lookups summed before
SP's reduce-scatter), the blocks on the rank's sequence rows (their
attention and MLP on its heads and ff columns between SP's all-gather and
reduce-scatter: ``attention.attention``, ``ffn.mlp``; a MoE FFN on its
rows through the all-to-all), and the final norm and the head, gathered
whole over ``model``, on its rows; collectives inside remat's block run
again in its recompute.  The recurrent families cross the same
boundary: each block's K1 norms on the rank's rows, rwkv6's time-mix
and mamba2 on the rank's heads of 64, rwkv6's channel-mix on its ff
columns (``models.rwkv6``, ``models.mamba2``), the hybrid's shared
attention and MLP as the dense block's, under their own rules paths
(``blocks/shared_attn``, ``blocks/shared_mlp``).

Serving on a model axis (``sharding.serving.ServingStep``: the same
context, with the rank's slice of the cache): the transformer families'
``prefill`` and ``decode_step`` run each rank's part as the train step
does (SP where ``model`` divides the prompt; a decode step never has it),
the cache written and read by ``models.attention`` in the layout of
``rules.cache_specs``, the MoE per ``ffn.moe``'s model-axis forms, and the
logits taken over the whole vocab on every rank (the final norm on the
rank's rows, the last position's vector summed over ``model``, the head
gathered whole).  The recurrent families' too: their mixers compute on
the train step's split, and each layer's state (each group's, for the
hybrid) moves from the rules' layout in the cache into the mixers'
pieces on entry and back on exit (``TensorParallel.state_in`` /
``state_out``); the hybrid's shared attention takes the transformer
families' path under its own rules path."""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.analysis import hlo_counter
from repro_torch.device import DeviceLike, resolve_device, resolve_or_meta
from repro_torch.sharding import ctx
from . import attention as attn_mod
from . import ffn as ffn_mod
from . import mamba2 as mamba_mod
from . import moe_ep
from . import rwkv6 as rwkv_mod
from .attention import KVCache
from .common import ModelConfig, cross_entropy, init_dense, rmsnorm

FAMILIES = ("dense", "moe", "vlm", "audio", "ssm", "hybrid")


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
        # on a model axis that does not divide the experts, each expert's
        # ff columns split over model (ffn.moe)
        out, aux = ffn_mod.moe(p["mlp"], cfg, y)
    return h + out, aux


def _state_at(state, *idx):
    """Views of one layer's rows of a stacked state NamedTuple."""
    return type(state)(*(t[idx] for t in state))


def _write_state(dst, src) -> None:
    """A layer's new state into its cache views, in place (a captured
    decode graph replays into these buffers)."""
    for d, s in zip(dst, src):
        d.copy_(s)


def _state_in(state, prefix: str = ""):
    """A unit of the cache's state (a layer's rows of a state NamedTuple,
    or a hybrid group's) as the mixers take it: the cache's own views, or
    on a serving step's model axis each leaf moved from the rules' piece
    into the mixer's (``TensorParallel.state_in``, leaf paths
    ``prefix + field``)."""
    tp = ctx.get_tensor_parallel()
    if tp is None or not tp.state:
        return state
    return type(state)(*(tp.state_in(prefix + f, t)
                         for f, t in zip(state._fields, state)))


def _state_out(dst, work, prefix: str = "") -> None:
    """The unit ``work`` (from :func:`_state_in`, updated in place) back
    into the cache's views ``dst``: nothing where it is those views."""
    if work is dst:
        return
    tp = ctx.get_tensor_parallel()
    for f, d, w in zip(dst._fields, dst, work):
        tp.state_out(prefix + f, w, d)


def _rwkv_block_fwd(p, cfg: ModelConfig, x, state=None, lengths=None):
    """One rwkv6 block: ``(x, Rwkv6State)``, the layer's new state."""
    p = ctx.gathered(p, "blocks")
    tm, tshift, wkv = rwkv_mod.time_mix(
        p["mix"], cfg,
        rmsnorm(x, _norm_weight(p["ln1"], "blocks/ln1"), cfg.norm_eps),
        state, lengths=lengths)
    h = x + tm
    cm, cshift = rwkv_mod.channel_mix(
        p["mix"], cfg,
        rmsnorm(h, _norm_weight(p["ln2"], "blocks/ln2"), cfg.norm_eps),
        state, lengths=lengths)
    return h + cm, rwkv_mod.Rwkv6State(tshift, cshift, wkv)


def _rwkv_train(p, cfg: ModelConfig, x):
    return _rwkv_block_fwd(p, cfg, x)[0]


def _mamba_layer(mp, ln, cfg: ModelConfig, x, state=None, lengths=None):
    """One pre-normed mamba2 layer with its residual: ``(x, Mamba2State)``."""
    mp = ctx.gathered(mp, "blocks/mamba")
    ln = _norm_weight(ctx.gathered(ln, "blocks/mamba_ln"), "blocks/mamba_ln")
    y, st = mamba_mod.forward(mp, cfg, rmsnorm(x, ln, cfg.norm_eps), state,
                              lengths=lengths)
    return x + y, st


def _shared(blocks) -> Dict:
    """The hybrid's shared attention + MLP block (one set of weights)."""
    return {k: v for k, v in blocks.items() if k.startswith("shared")}


def _shared_attn_in(hp, cfg: ModelConfig, x):
    """(the shared attention's weights, its normed input)."""
    ln = _norm_weight(ctx.gathered(hp["shared_ln"], "blocks/shared_ln"),
                      "blocks/shared_ln")
    return (ctx.gathered(hp["shared_attn"], "blocks/shared_attn"),
            rmsnorm(x, ln, cfg.norm_eps))


def _shared_mlp(hp, cfg: ModelConfig, x):
    ln2 = _norm_weight(ctx.gathered(hp["shared_ln2"], "blocks/shared_ln2"),
                       "blocks/shared_ln2")
    mlp = ctx.gathered(hp["shared_mlp"], "blocks/shared_mlp")
    return x + ffn_mod.mlp(mlp, rmsnorm(x, ln2, cfg.norm_eps),
                           path="blocks/shared_mlp")


def _hybrid_group_train(mamba, lns, hp, cfg: ModelConfig, x, positions):
    """One hybrid group in training: its mamba layers, then the shared
    block (each weight gathered where used, again in remat's
    recompute)."""
    for mp, ln in zip(mamba, lns):
        x, _ = _mamba_layer(mp, ln, cfg, x)
    attn, xa = _shared_attn_in(hp, cfg, x)
    x = x + attn_mod.attention(attn, cfg, xa, positions,
                               path="blocks/shared_attn")
    return _shared_mlp(hp, cfg, x)


# the rules' path of the hybrid's shared attention weights
_SHARED_ATTN = "blocks/shared_attn"


def _decode_attend(p, cfg: ModelConfig, h, ck, cv, li: int, pos,
                   block_tables, kv_view, path: str = "blocks/attn"):
    """One token's attention of layer (or group) ``li``: against the
    chunk's paged view, through the page tables, or against the dense
    cache, each written in place (``path``: the rules' path of the
    weights, read on a serving step's model axis)."""
    if kv_view is not None:
        return attn_mod.paged_attention_decode_view(
            p, cfg, h, ck, cv, kv_view[0], kv_view[1], li, pos,
            block_tables)[0]
    if block_tables is not None:
        return attn_mod.paged_attention_decode_inplace(
            p, cfg, h, ck, cv, li, pos, block_tables)[0]
    return attn_mod.attention_decode_inplace(p, cfg, h, ck, cv, li, pos,
                                             path=path)[0]


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r}: the port runs {list(FAMILIES)}, "
                f"the reference's families")
        self.cfg = cfg
        self._last_aux = None

    @property
    def groups(self) -> int:
        """The hybrid's groups: n_layers / attn_every."""
        return self.cfg.n_layers // self.cfg.attn_every

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
        if cfg.family == "ssm":
            blocks = [{"ln1": ones(), "ln2": ones(),
                       "mix": rwkv_mod.init_rwkv6(generator, cfg, device)}
                      for _ in range(cfg.n_layers)]
        elif cfg.family == "hybrid":
            e = range(cfg.attn_every)
            blocks = {
                "mamba": [[mamba_mod.init_mamba2(generator, cfg, device)
                           for _ in e] for _ in range(self.groups)],
                "mamba_ln": [[ones() for _ in e]
                             for _ in range(self.groups)],
                "shared_ln": ones(),
                "shared_attn": attn_mod.init_attn(generator, cfg, device),
                "shared_ln2": ones(),
                "shared_mlp": ffn_mod.init_mlp(generator, cfg,
                                               device=device)}
        else:
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

        def run(fn, *args):
            if not remat:
                return fn(*args)
            # the model draws no random numbers: no RNG state to stash
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False)
        # the layer loops run through hlo_counter.layers: the Python loop,
        # or under a scaled op count one body at the layers' weight
        blocks = params["blocks"]
        aux = None
        if cfg.family == "ssm":
            x = hlo_counter.layers(
                lambda layer, h: run(_rwkv_train, layer, cfg, h), blocks, x)
        elif cfg.family == "hybrid":
            x = hlo_counter.layers(
                lambda group, h, shared: run(_hybrid_group_train, *group,
                                             shared, cfg, h, positions),
                list(zip(blocks["mamba"], blocks["mamba_ln"])), x,
                _shared(blocks))
        else:
            def block(layer, carry):
                h, total = carry
                h, a = run(_block_fwd, layer, cfg, h, positions)
                if a is not None:
                    total = a if total is None else total + a
                return h, total
            x, aux = hlo_counter.layers(block, blocks, (x, None))
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
                   device: DeviceLike = None):
        """Zero serving cache (``"meta"``: the shapes alone): KV
        layer-stacked, k/v (L, batch, max_seq, nkv, hd); ssm: the rwkv6
        state stacked (L, batch, ...); hybrid: ``{"mamba": the mamba2
        state stacked (G, E, batch, ...), "kv": k/v (G, batch, max_seq,
        nkv, hd)}``."""
        cfg = self.cfg
        device = resolve_or_meta(device)
        if cfg.family == "ssm":
            return rwkv_mod.init_state(cfg, batch, device,
                                       lead=(cfg.n_layers,))
        layers = self.groups if cfg.family == "hybrid" else cfg.n_layers
        shape = (layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
        kw = dict(dtype=cfg.torch_dtype, device=device)
        kv = KVCache(torch.zeros(shape, **kw), torch.zeros(shape, **kw))
        if cfg.family == "hybrid":
            return {"mamba": self.init_prefill_state(batch, device),
                    "kv": kv}
        return kv

    # -- paged serving cache -------------------------------------------------
    def init_paged_cache(self, batch: int, max_seq: int, *, n_blocks: int,
                         block_size: int, device: DeviceLike = None):
        """The ``kv_layout="paged"`` engine cache: the structure of
        :meth:`init_cache` with the KV leaves layer-stacked page pools
        (L or G, n_blocks + 1, block_size, nkv, hd), the last page of each
        the trash page (``repro_torch.models.attention``).  Pools have no
        slot axis: slots map into them through their block tables.  The
        recurrent state is O(1) a slot and stays slot-indexed (``batch``
        rows); ssm has no KV, so its paged cache IS its dense cache."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return self.init_cache(batch, max_seq, device)
        device = resolve_device(device)
        pools = attn_mod.init_paged_kv(
            cfg, n_blocks, block_size, device,
            layers=self.groups if cfg.family == "hybrid" else cfg.n_layers)
        if cfg.family == "hybrid":
            return {"mamba": self.init_prefill_state(batch, device),
                    "kv": pools}
        return pools

    def split_paged_cache(self, cache):
        """(kv pools, slot-indexed recurrent state); either may be None."""
        if self.cfg.family == "ssm":
            return None, cache
        if self.cfg.family == "hybrid":
            return cache["kv"], cache["mamba"]
        return cache, None

    def merge_paged_cache(self, kv, state):
        """Inverse of :meth:`split_paged_cache`."""
        if self.cfg.family == "ssm":
            return state
        if self.cfg.family == "hybrid":
            return {"mamba": state, "kv": kv}
        return kv

    def init_prefill_state(self, batch: int = 1, device: DeviceLike = None):
        """Zero recurrent state of ``batch`` rows: the staging state of a
        chunked paged admission (ssm: its whole cache; hybrid: the mamba
        state stacked (G, E, batch, ...)); None for the transformer
        families, whose prefill state lives entirely in the KV cache."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return self.init_cache(batch, 1, device)
        if cfg.family == "hybrid":
            return mamba_mod.init_state(
                cfg, batch, resolve_or_meta(device),
                lead=(self.groups, cfg.attn_every))
        return None

    def _hybrid_groups(self, params, x, mstate, lengths, attend):
        """The hybrid's serving pass: each group's mamba layers on their
        state rows of ``mstate`` (written in place; on a model axis the
        group's state moved into the mixers' pieces and back), then the
        shared block, whose attention is ``attend(g, weights, normed
        x)``."""
        cfg, hp = self.cfg, params["blocks"]

        def group(g, h):
            dst = _state_at(mstate, g)
            work = _state_in(dst, "mamba/")
            for e in range(cfg.attn_every):
                st = _state_at(work, e)
                h, new = _mamba_layer(hp["mamba"][g][e], hp["mamba_ln"][g][e],
                                      cfg, h, st, lengths)
                _write_state(st, new)
            _state_out(dst, work, "mamba/")
            attn, xa = _shared_attn_in(hp, cfg, h)
            return _shared_mlp(hp, cfg, h + attend(g, attn, xa))
        # hlo_counter.layers: the loop, or one group at the groups' weight
        # under a scaled op count
        return hlo_counter.layers(group, list(range(self.groups)), x)

    def _rwkv_layers(self, params, x, state, lengths=None):
        """ssm's serving pass: each block on its state rows of ``state``
        (written in place; on a model axis moved into the mixers' pieces
        and back)."""
        def block(item, h):
            li, layer = item
            dst = _state_at(state, li)
            work = _state_in(dst)
            h, new = _rwkv_block_fwd(layer, self.cfg, h, work, lengths)
            _write_state(work, new)
            _state_out(dst, work)
            return h
        return hlo_counter.layers(block, list(enumerate(params["blocks"])),
                                  x)

    def prefill(self, params, tokens, cache: KVCache, start: int = 0,
                lengths: Optional[torch.Tensor] = None,
                attend_cache: bool = False):
        """Fill the cache with ``tokens`` (b, s[, K]) at [start, start+s);
        returns (last_logits (b, vocab), cache), the cache written in
        place.

        ``lengths`` ((b,) int) marks each row's real prompt length in a
        RIGHT-padded batch: logits are taken at ``lengths - 1``.  Causal
        masking keeps real tokens from attending to the padding, and the
        recurrent families mask their state updates past ``lengths``, so
        a padded prefill is the unpadded computation and leaves the
        unpadded cache.  A recurrent cache is the state the prefill starts
        from (zero for a fresh prompt, the earlier chunks' for a
        continuation), overwritten with the state after ``tokens``.

        ``attend_cache=True`` is the CHUNKED-prefill continuation form:
        attention runs against the whole (updated) cache masked by
        ``kpos <= qpos`` instead of within ``tokens`` alone, so a chunk at
        offset ``start > 0`` sees every earlier chunk's positions."""
        cfg = self.cfg
        tp = self._serving_tp(attend_cache=attend_cache)
        x = self._embed_in(params, tokens, tp)
        attend = (attn_mod.attention_prefill_cached if attend_cache
                  else attn_mod.attention_prefill)
        if cfg.family == "ssm":
            x = self._rwkv_layers(params, x, cache, lengths)
            return self._last_logits(params, x, lengths), cache
        if cfg.family == "hybrid":
            kv = cache["kv"]
            if not attend_cache:
                # its weights' rules path, read on a model axis
                attend = functools.partial(attn_mod.attention_prefill,
                                           path=_SHARED_ATTN)
            x = self._hybrid_groups(
                params, x, cache["mamba"], lengths,
                lambda g, p, xa: attend(p, cfg, xa, KVCache(
                    kv.k[g], kv.v[g]), start)[0])
            return self._last_logits(params, x, lengths), cache
        def block(item, h):
            li, layer = item
            layer = ctx.gathered(layer, "blocks")
            h_in = rmsnorm(h, _norm_weight(layer["ln1"], "blocks/ln1"),
                           cfg.norm_eps)
            y, _ = attend(layer["attn"], cfg, h_in,
                          KVCache(cache.k[li], cache.v[li]), start)
            h = h + y
            return h + _ffn(layer["mlp"], cfg, rmsnorm(
                h, _norm_weight(layer["ln2"], "blocks/ln2"), cfg.norm_eps))
        x = hlo_counter.layers(block, list(enumerate(params["blocks"])), x)
        return self._last_logits(params, x, lengths), cache

    def _serving_tp(self, attend_cache: bool = False, paged: bool = False):
        """The running serving step's ``TensorParallel`` (None off a model
        axis), for the paths that run on one: every family's dense
        prefill and decode, as the reference's dry run lowers them."""
        tp = ctx.get_tensor_parallel()
        if tp is None:
            return None
        cfg = self.cfg
        if attend_cache or paged:
            raise NotImplementedError(
                f"{cfg.name}: a chunked or paged serving step on a model "
                f"axis: the model axis reaches serving through the dense "
                f"prefill and decode_step alone, as the reference's dry "
                f"run lowers them")
        return tp

    def _embed_in(self, params, tokens, tp):
        """The embedding of ``tokens`` as the blocks take it (vocab-
        parallel on a model axis: ``TensorParallel.embed``)."""
        embed = ctx.gathered(params["embed"], "embed")
        return lookup(embed, tokens) if tp is None else \
            tp.embed(embed, tokens)

    def _last_logits(self, params, x, lengths):
        """Final norm and head at each row's last real position (on a
        model axis: the head gathered whole over ``model``, the logits of
        the whole vocab on every rank)."""
        b, s = x.shape[:2]
        tp = ctx.get_tensor_parallel()
        x = rmsnorm(x, _norm_weight(ctx.gathered(params["ln_f"], "ln_f"),
                                    "ln_f"), self.cfg.norm_eps)
        head = ctx.gathered(params["head"], "head")
        if tp is not None:
            with hlo_counter.tagged("head_gather"):
                head = tp.whole(head, "head")
            return tp.last_rows(x, lengths) @ head
        if lengths is None:
            x_last = x[:, -1]
        else:
            idx = (torch.as_tensor(lengths, device=x.device).long() - 1
                   ).clamp(0, s - 1)
            x_last = x[torch.arange(b, device=x.device), idx]
        return x_last @ head

    def prefill_paged(self, params, tokens, kv: KVCache, bt_row, state,
                      start: int, lengths, *, first: bool):
        """Prefill one prompt chunk of ONE slot into the paged pools, in
        place.

        tokens: (1, s[, K]); kv: the engine's pools
        (:meth:`split_paged_cache`; None for ssm);
        bt_row: the slot's (max_blocks,) block-table row; state: the
        batch-1 recurrent staging state (:meth:`init_prefill_state`,
        written in place; None for the transformer families); start: the
        chunk's offset; lengths: (1,) real token count WITHIN this chunk.
        Returns (last_logits, kv, state).

        ``first`` is the chunk-0 form: attention runs within ``tokens``
        exactly like the dense admission prefill; continuation chunks
        gather the slot's pages and attend ``kpos <= qpos``."""
        cfg = self.cfg
        self._serving_tp(paged=True)
        if cfg.family == "ssm":
            logits, state = self.prefill(params, tokens, state,
                                         lengths=lengths)
            return logits, kv, state
        x = self.embed(params, tokens)
        if cfg.family == "hybrid":
            x = self._hybrid_groups(
                params, x, state, lengths,
                lambda g, p, xa: attn_mod.paged_attention_prefill(
                    p, cfg, xa, kv.k, kv.v, g, bt_row, start,
                    first=first)[0])
            return self._last_logits(params, x, lengths), kv, state
        for li, layer in enumerate(params["blocks"]):
            h_in = rmsnorm(x, layer["ln1"], cfg.norm_eps)
            y, _, _ = attn_mod.paged_attention_prefill(
                layer["attn"], cfg, h_in, kv.k, kv.v, li, bt_row, start,
                first=first)
            h = x + y
            x = h + _ffn(layer["mlp"], cfg,
                         rmsnorm(h, layer["ln2"], cfg.norm_eps))
        return self._last_logits(params, x, lengths), kv, state

    def gather_paged_view(self, cache, block_tables):
        """The per-slot logical (vk, vv) view of a paged cache's pools,
        gathered once per decode chunk (see
        :func:`repro_torch.models.attention.gather_paged_view`); None for
        ssm, which has no KV."""
        kv, _ = self.split_paged_cache(cache)
        if kv is None:
            return None
        return attn_mod.gather_paged_view(kv.k, kv.v, block_tables)

    def decode_step(self, params, token, cache, pos,
                    block_tables=None, kv_view=None):
        """token: (b, 1[, K]) -> (logits (b, vocab), cache), the cache
        written in place at ``pos`` (a scalar, or a (b,) per-slot position
        tensor; the recurrent state ignores it: every lane advances its
        state, a parked lane's rows are overwritten at its next
        admission).

        ``block_tables`` ((b, max_blocks)) selects the PAGED path: the
        cache's leaves are page pools and attention goes through
        :func:`repro_torch.models.attention.paged_attention_decode_inplace`.
        With ``kv_view`` (the (vk, vv) pair from :meth:`gather_paged_view`)
        attention runs against the view, updated in place, and the return
        value is ``(logits, cache, view)``: the decode chunk's form."""
        cfg = self.cfg
        tp = self._serving_tp(paged=block_tables is not None
                              or kv_view is not None)
        x = self._embed_in(params, token, tp)
        if cfg.family == "ssm":
            x = self._rwkv_layers(params, x, cache)
        elif cfg.family == "hybrid":
            kv = cache["kv"]
            x = self._hybrid_groups(
                params, x, cache["mamba"], None,
                lambda g, p, xa: _decode_attend(
                    p, cfg, xa, kv.k, kv.v, g, pos, block_tables, kv_view,
                    path=_SHARED_ATTN))
        else:
            def block(item, h):
                li, layer = item
                layer = ctx.gathered(layer, "blocks")
                a = rmsnorm(h, _norm_weight(layer["ln1"], "blocks/ln1"),
                            cfg.norm_eps)
                h = h + _decode_attend(layer["attn"], cfg, a, cache.k,
                                       cache.v, li, pos, block_tables,
                                       kv_view)
                return h + _ffn(layer["mlp"], cfg, rmsnorm(
                    h, _norm_weight(layer["ln2"], "blocks/ln2"),
                    cfg.norm_eps))
            x = hlo_counter.layers(block, list(enumerate(params["blocks"])),
                                   x)
        logits = self._last_logits(params, x, None)
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
