"""Model configuration + shared components (norms, RoPE, init, the loss).

The port's own copy of ``repro.models.common``: the same ``ModelConfig``
fields, the same RoPE and init distributions, with ``torch.Generator``s in
place of JAX keys (so the same seed gives other random bits)."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import ops


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str            # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None      # defaults to d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    attn_every: int = 0                 # hybrid: shared attn every k blocks
    # audio (musicgen): codebooks summed at the embedding (frontend stub)
    n_codebooks: int = 0
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # runtime / distribution knobs
    remat: bool = True
    fsdp: bool = False                  # ZeRO-style param+opt sharding on data
    opt_8bit: bool = False              # 8-bit Adam moments (100B+ configs)
    use_flash: bool = False             # the reference's K3 switch; the port
    #                                     always runs K3 in prefill
    max_seq: int = 4096

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once): the
        reference's formula, family by family."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd, nh, nkv = self.hd, self.n_heads, self.n_kv_heads
        attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        ffn = 3 * d * f  # SwiGLU
        if self.n_experts:
            ffn = self.n_experts * 3 * d * f + d * self.n_experts  # + router
        per_layer = attn + ffn + 2 * d
        if self.family == "ssm":        # rwkv6: time-mix + channel-mix
            tm = d * d * 4 + d * 64 * 2 + d * 6  # r,k,v,o + lora decay + mixes
            cm = d * f + f * d + d * d
            per_layer = tm + cm + 2 * d
        if self.family == "hybrid":
            # mamba2-only layers; the SHARED block (attn + MLP) counts once
            din = 2 * d
            nheads_m = din // 64
            mamba = (d * (2 * din + 2 * self.ssm_state + nheads_m)
                     + din * d + 2 * din)
            per_layer = mamba + d
            shared = attn + 3 * d * f + 2 * d
            return self.n_layers * per_layer + shared + v * d + v * d
        return self.n_layers * per_layer + v * d + v * d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        if not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_moe = self.n_experts * 3 * d * f
        active_moe = self.top_k * 3 * d * f
        return self.param_count() - self.n_layers * (dense_moe - active_moe)


def init_dense(generator: torch.Generator, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None, device=None) -> torch.Tensor:
    """N(0, 1) * scale (default 1/sqrt(d_in)) drawn in fp32 on the
    generator's device (or on ``device``: ``meta`` gives the shape alone),
    then cast: the reference's distribution."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator,
                    device=device or generator.device, dtype=torch.float32)
    return w.mul_(scale).to(dtype)


def rmsnorm(x, w, eps: float = 1e-6):
    return ops.rmsnorm(x, w, eps=eps)


def cross_entropy(logits, labels, *, z_loss: float = 1e-4):
    """Next-token CE in float32 with z-loss regulariser; labels -100 masked
    (``repro.models.common.cross_entropy``)."""
    logits = logits.float()
    mask = labels >= 0
    labels_safe = torch.where(mask, labels, torch.zeros_like(labels))
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels_safe[..., None].long())[..., 0] - lse
    n = mask.sum().clamp(min=1)
    loss = -(ll * mask).sum() / n
    zl = z_loss * ((lse * mask) ** 2).sum() / n
    return loss + zl


def rope_freqs(hd: int, theta: float, positions):
    """positions: (..., seq) int -> (..., seq, hd//2) cos/sin in fp32."""
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=positions.device) / hd))
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., seq, heads, hd); cos/sin: (..., seq, hd//2)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
