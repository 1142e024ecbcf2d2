"""Mamba2 (SSD) mixer: the zamba2 hybrid's sequence-mixing block.

The port of ``repro.models.mamba2``: in-projection -> (gate z | x | B | C
| dt), a causal depthwise conv over (x | B | C) with a carried tail, the
selective state-space recurrence with a per-head scalar decay, the
``d_skip`` skip connection, the gated RMSNorm and the out-projection.  The
recurrence is a Python loop over time of plain PyTorch ops (the
reference's ``lax.scan`` in XLA); the gated norm is the reference's inline
arithmetic (it does not call ``ops.rmsnorm``), so it is not K1.

State per layer (``Mamba2State``): the conv tail (b, CONV_W - 1, din + 2N)
in the model dtype and the SSM state (b, nheads, HD, N) in fp32.  Params
are a dict with the reference's field names: ``w_in`` (d, 2 din + 2N +
nheads), ``conv_w`` (CONV_W, din + 2N), ``norm_w`` (din,), ``w_out``
(din, d) in the model dtype, ``a_log``, ``dt_bias``, ``d_skip`` (nheads,)
in fp32."""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import ModelConfig, init_dense
from .rwkv6 import len_mask

CONV_W = 4
HD = 64  # mamba2 head dim


class Mamba2State(NamedTuple):
    conv: torch.Tensor   # (..., b, CONV_W - 1, din + 2N)
    ssm: torch.Tensor    # (..., b, nheads, HD, N) float32


def dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    din = 2 * cfg.d_model
    return din, din // HD, cfg.ssm_state


def init_mamba2(generator: torch.Generator, cfg: ModelConfig, device=None
                ) -> Dict[str, torch.Tensor]:
    """One layer's params: the reference's distributions and dtypes."""
    d, dt = cfg.d_model, cfg.torch_dtype
    din, nheads, n = dims(cfg)
    dev = device or generator.device
    f32 = dict(dtype=torch.float32, device=dev)
    conv_w = torch.randn((CONV_W, din + 2 * n), generator=generator,
                         device=dev, dtype=torch.float32)
    return {
        "w_in": init_dense(generator, d, 2 * din + 2 * n + nheads, dt,
                           device=dev),
        "conv_w": conv_w.mul_(0.1).to(dt),
        "a_log": torch.zeros((nheads,), **f32),
        "dt_bias": torch.zeros((nheads,), **f32),
        "d_skip": torch.ones((nheads,), **f32),
        "norm_w": torch.ones((din,), dtype=dt, device=dev),
        "w_out": init_dense(generator, din, d, dt, device=dev),
    }


def init_state(cfg: ModelConfig, batch: int, device=None,
               lead: tuple = ()) -> Mamba2State:
    """Zero state of ``batch`` rows, with leading stack dims ``lead``."""
    din, nheads, n = dims(cfg)
    return Mamba2State(
        conv=torch.zeros(lead + (batch, CONV_W - 1, din + 2 * n),
                         dtype=cfg.torch_dtype, device=device),
        ssm=torch.zeros(lead + (batch, nheads, HD, n), dtype=torch.float32,
                        device=device))


def split_proj(cfg: ModelConfig, proj):
    """The in-projection's z | xBC | dt."""
    din, _, n = dims(cfg)
    return proj.split([din, din + 2 * n, proj.shape[-1] - 2 * din - 2 * n],
                      dim=-1)


def forward(p, cfg: ModelConfig, x, state: Optional[Mamba2State] = None,
            lengths=None):
    """x: (b, s, d) -> (y, Mamba2State); ``state`` None: a fresh sequence.

    ``lengths`` ((b,) int, optional) marks each row's real prompt length
    in a RIGHT-padded batch: the conv tail and the SSM state are masked
    off at padded positions, so the returned state is bitwise the state of
    the unpadded sequence."""
    b, s, d = x.shape
    din, nheads, n = dims(cfg)
    proj = x @ p["w_in"]
    z, xbc, dt_raw = split_proj(cfg, proj)

    conv_state = (torch.zeros((b, CONV_W - 1, xbc.shape[-1]),
                              dtype=xbc.dtype, device=x.device)
                  if state is None else state.conv.to(xbc.dtype))
    xbc_ext = torch.cat([conv_state, xbc], dim=1)
    conv = sum(p["conv_w"][i] * xbc_ext[:, i:i + s] for i in range(CONV_W))
    conv = F.silu(conv)
    if lengths is None:
        new_tail = xbc_ext[:, -(CONV_W - 1):]
    else:
        # row i's real tokens sit at ext positions [CONV_W - 1,
        # CONV_W - 1 + lengths[i]): its tail starts at ext lengths[i]
        idx = (torch.as_tensor(lengths, device=x.device).long()[:, None]
               + torch.arange(CONV_W - 1, device=x.device)[None, :])
        new_tail = torch.gather(
            xbc_ext, 1, idx[:, :, None].expand(-1, -1, xbc_ext.shape[-1]))

    xs_, b_in, c_in = conv.split([din, n, n], dim=-1)      # (b, s, N) each
    dt = F.softplus(dt_raw.float() + p["dt_bias"])           # (b, s, nh)
    a = -torch.exp(p["a_log"])                               # (nh,)
    da = torch.exp(dt * a)                                   # decay per step
    xh = xs_.reshape(b, s, nheads, HD).float()
    bf, cf = b_in.float(), c_in.float()
    dx = dt[..., None] * xh                                  # (b, s, nh, hd)
    mask = None if lengths is None else len_mask(lengths, b, s, x.device)
    h = (torch.zeros((b, nheads, HD, n), dtype=torch.float32,
                     device=x.device) if state is None else state.ssm)
    ys = []
    for t in range(s):
        h_new = h * da[:, t, :, None, None] + (
            dx[:, t, :, :, None] * bf[:, t, None, None, :])
        h = h_new if mask is None else torch.where(
            mask[:, t, None, None, None], h_new, h)
        ys.append((h @ cf[:, t, None, :, None])[..., 0])     # (b, nh, hd)
    y = torch.stack(ys, dim=1)                               # (b, s, nh, hd)
    y = y + p["d_skip"][None, None, :, None] * xh            # skip connection
    y = y.reshape(b, s, din).to(x.dtype)

    # gated rmsnorm (mamba2 style): norm(y * silu(z))
    g32 = (y * F.silu(z)).float()
    var = torch.mean(g32 * g32, dim=-1, keepdim=True)
    g = (g32 * torch.rsqrt(var + cfg.norm_eps)).to(x.dtype) * p["norm_w"]
    return g @ p["w_out"], Mamba2State(new_tail, h)


def decode_step(p, cfg: ModelConfig, x, state: Mamba2State):
    """Single-token step: x (b, 1, d)."""
    return forward(p, cfg, x, state)
