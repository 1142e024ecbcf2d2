"""FFN layers: the SwiGLU MLP (``repro.models.ffn.mlp``).

MoE waits for its slice of the port (ROADMAP.md)."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding import ctx

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
    """The SwiGLU MLP.  Inside a tensor-parallel train step (``sharding.
    ctx.get_tensor_parallel()``) ``x`` is this rank's rows and the rank
    computes its ff columns: ``w_gate`` / ``w_up`` column-parallel,
    ``w_down`` row-parallel, its partial sums reduce-scattered into SP (or
    all-reduced with SP off)."""
    tp = ctx.get_tensor_parallel()
    if tp is not None:
        p = {"w_gate": tp.part(p["w_gate"], "blocks/mlp/w_gate", 1,
                               tp.ff_cols),
             "w_up": tp.part(p["w_up"], "blocks/mlp/w_up", 1, tp.ff_cols),
             "w_down": tp.part(p["w_down"], "blocks/mlp/w_down", 0,
                               tp.ff_cols)}
        return tp.exit(_swiglu(p, tp.enter(x)))
    return _swiglu(p, x)


def _swiglu(p, x):
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]
