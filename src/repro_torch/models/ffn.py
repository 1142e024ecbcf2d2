"""FFN layers: the SwiGLU MLP (``repro.models.ffn.mlp``).

MoE waits for its slice of the port (ROADMAP.md)."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .common import ModelConfig, init_dense


def init_mlp(generator: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None, device=None
             ) -> Dict[str, torch.Tensor]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = cfg.torch_dtype
    return {"w_gate": init_dense(generator, d, f, dt, device=device),  # (d, f)
            "w_up": init_dense(generator, d, f, dt, device=device),    # (d, f)
            "w_down": init_dense(generator, f, d, dt, device=device)}  # (f, d)


def mlp(p: Dict[str, torch.Tensor], x):
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]
