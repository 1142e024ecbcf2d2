"""Model configuration + shared components (norms, RoPE, init).

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


def init_dense(generator: torch.Generator, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """N(0, 1) * scale (default 1/sqrt(d_in)) drawn in fp32 on the
    generator's device, then cast: the reference's distribution."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return w.mul_(scale).to(dtype)


def rmsnorm(x, w, eps: float = 1e-6):
    return ops.rmsnorm(x, w, eps=eps)


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
