"""Model assembly for the dense family: pre-norm GQA transformer blocks and
the Model API (forward / init_cache / prefill / decode_step).

The port of ``repro.models.transformer.Model`` for ``family="dense"``.
Params are a plain dict: ``embed`` (vocab, d), ``ln_f`` (d,), ``head``
(d, vocab) and ``blocks``, a list with one dict per layer (``ln1``,
``attn``, ``ln2``, ``mlp``) in place of the reference's stacked leading
layer axis; the layer loop is a Python loop in place of ``lax.scan``.  The
KV cache is layer-stacked as in the reference and is updated in place.
The other families (moe, hybrid, ssm, vlm, audio) wait for their slices of
the port (ROADMAP.md, queue 1)."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from . import attention as attn_mod
from . import ffn as ffn_mod
from .attention import KVCache
from .common import ModelConfig, init_dense, rmsnorm


def _block_fwd(p, cfg: ModelConfig, x, positions):
    h = x + attn_mod.attention(p["attn"], cfg,
                               rmsnorm(x, p["ln1"], cfg.norm_eps), positions)
    return h + ffn_mod.mlp(p["mlp"], rmsnorm(h, p["ln2"], cfg.norm_eps))


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet; only 'dense' is "
                f"(see ROADMAP.md, queue 1)")
        self.cfg = cfg

    # -- init ---------------------------------------------------------------
    def init_params(self, generator: torch.Generator,
                    device: DeviceLike = None) -> Dict:
        """Random params drawn from ``generator`` on ``device`` (the CUDA
        device unless ``"cpu"`` is given; the generator must live there):
        the reference's distributions, torch's random bits."""
        cfg = self.cfg
        device = resolve_device(device)
        if generator.device.type != device.type:
            raise ValueError(f"generator on {generator.device} cannot draw "
                             f"params for {device}")
        dt = cfg.torch_dtype
        ones = lambda: torch.ones((cfg.d_model,), dtype=dt,  # noqa: E731
                                  device=device)
        embed = init_dense(generator, cfg.vocab, cfg.d_model, dt, scale=0.02)
        blocks = [{"ln1": ones(), "attn": attn_mod.init_attn(generator, cfg),
                   "ln2": ones(), "mlp": ffn_mod.init_mlp(generator, cfg)}
                  for _ in range(cfg.n_layers)]
        return {"embed": embed, "blocks": blocks, "ln_f": ones(),
                "head": init_dense(generator, cfg.d_model, cfg.vocab, dt)}

    # -- forward (scoring) ---------------------------------------------------
    def forward(self, params, tokens):
        """tokens (b, s) -> logits (b, s, vocab)."""
        cfg = self.cfg
        x = params["embed"][tokens]
        b, s = tokens.shape
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        for layer in params["blocks"]:
            x = _block_fwd(layer, cfg, x, positions)
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        return x @ params["head"]

    # -- serving -------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int,
                   device: DeviceLike = None) -> KVCache:
        """Zero KV cache, layer-stacked: k/v (L, batch, max_seq, nkv, hd)."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
        kw = dict(dtype=cfg.torch_dtype, device=resolve_device(device))
        return KVCache(torch.zeros(shape, **kw), torch.zeros(shape, **kw))

    def prefill(self, params, tokens, cache: KVCache, start: int = 0,
                lengths: Optional[torch.Tensor] = None):
        """Fill the cache with ``tokens`` (b, s) at [start, start+s); returns
        (last_logits (b, vocab), cache), the cache written in place.

        ``lengths`` ((b,) int) marks each row's real prompt length in a
        RIGHT-padded batch: logits are taken at ``lengths - 1``.  Causal
        masking keeps real tokens from attending to the padding, so a
        padded prefill is the unpadded computation."""
        cfg = self.cfg
        x = params["embed"][tokens]
        b, s = tokens.shape
        for li, layer in enumerate(params["blocks"]):
            h_in = rmsnorm(x, layer["ln1"], cfg.norm_eps)
            y, _ = attn_mod.attention_prefill(
                layer["attn"], cfg, h_in, KVCache(cache.k[li], cache.v[li]),
                start)
            h = x + y
            x = h + ffn_mod.mlp(layer["mlp"],
                                rmsnorm(h, layer["ln2"], cfg.norm_eps))
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        if lengths is None:
            x_last = x[:, -1]
        else:
            idx = (torch.as_tensor(lengths, device=x.device).long() - 1
                   ).clamp(0, s - 1)
            x_last = x[torch.arange(b, device=x.device), idx]
        return x_last @ params["head"], cache

    def decode_step(self, params, token, cache: KVCache, pos):
        """token: (b, 1) -> (logits (b, vocab), cache), the cache written in
        place at ``pos`` (a scalar, or a (b,) per-slot position tensor)."""
        cfg = self.cfg
        x = params["embed"][token]
        for li, layer in enumerate(params["blocks"]):
            h = rmsnorm(x, layer["ln1"], cfg.norm_eps)
            y, _, _ = attn_mod.attention_decode_inplace(
                layer["attn"], cfg, h, cache.k, cache.v, li, pos)
            x = x + y
            x = x + ffn_mod.mlp(layer["mlp"],
                                rmsnorm(x, layer["ln2"], cfg.norm_eps))
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        return x[:, -1] @ params["head"], cache
