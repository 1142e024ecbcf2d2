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
in fp32.

Inside a tensor-parallel train step (``sharding.ctx.
get_tensor_parallel()``) ``x`` is this rank's sequence rows and the rank
computes its heads (``TensorParallel.mamba_columns``): ``z``, ``x`` and
``dt`` from its head columns of ``w_in`` (and ``x``'s of ``conv_w``),
``B`` and ``C`` whole on every rank for its heads (their gradients summed
over ``model``), ``a_log``, ``dt_bias``, ``d_skip`` and ``norm_w`` cut to
its heads, ``w_out`` row-parallel.  The gated norm spans all of ``din``:
its fp32 sum of squares is summed over ``model`` before the ``rsqrt``
(``collectives.all_sum``).  Where ``model`` does not divide the heads the
mixer runs whole on every rank.

A serving step on a model axis gives the mixer its state in its piece
(``TensorParallel.state_in``): the conv tail's columns of the rank's
heads followed by ``B | C`` whole (the order of its ``conv_w`` columns)
and the SSM state of its heads, every head where the mixer runs whole;
it returns the new state in the same piece, masked by ``lengths`` on the
whole sequence every rank holds."""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.analysis import hlo_counter
from repro_torch.sharding import ctx
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


def forward(p, cfg: ModelConfig, x, state: Optional[Mamba2State] = None,
            lengths=None):
    """x: (b, s, d) -> (y, Mamba2State); ``state`` None: a fresh sequence.

    ``lengths`` ((b,) int, optional) marks each row's real prompt length
    in a RIGHT-padded batch: the conv tail and the SSM state are masked
    off at padded positions, so the returned state is bitwise the state of
    the unpadded sequence.

    Inside a tensor-parallel step: ``(y of the rank's rows, the state in
    the mixer's piece)`` (module docstring)."""
    tp = ctx.get_tensor_parallel()
    if tp is not None:
        return _forward_tp(p, cfg, x, tp, state, lengths)
    return _forward(p, cfg, x, state, lengths)


def _forward_tp(p, cfg: ModelConfig, x, tp, state=None, lengths=None):
    from repro_torch.sharding.collectives import all_sum
    path = "blocks/mamba"
    if not tp.split_mixer:
        take = tp.mixer_take(path)
        local = {k: take(v, k) for k, v in p.items()}
        out = []

        def whole(xw):
            y, new = _forward(local, cfg, xw, state, lengths)
            out.append(new)
            return y
        return tp.whole_mixer(whole, x), out[0]
    cols, heads = tp.mamba_columns(cfg), tp.mixer_heads
    local = {"w_in": tp.columns(p["w_in"], f"{path}/w_in", 1,
                                cols["w_in"]),
             "conv_w": tp.columns(p["conv_w"], f"{path}/conv_w", 1,
                                  cols["conv_w"]),
             "norm_w": tp.part(p["norm_w"], f"{path}/norm_w", 0,
                               tp.mixer_cols),
             "w_out": tp.part(p["w_out"], f"{path}/w_out", 0,
                              tp.mixer_cols)}
    for k in ("a_log", "dt_bias", "d_skip"):
        local[k] = tp.part(p[k], f"{path}/{k}", 0, heads)
    y, new = _forward(local, cfg, tp.enter(x), state, lengths,
                      sum_squares=lambda t: all_sum(t, tp.group))
    return tp.exit(y), new


def _forward(p, cfg: ModelConfig, x, state, lengths, sum_squares=None):
    """The mixer on the heads of ``p`` (``a_log``'s: every head, or a
    rank's, whose gated norm's squares ``sum_squares`` sums over the
    ranks)."""
    b, s, d = x.shape
    din, _, n = dims(cfg)
    nheads = p["a_log"].shape[0]
    width = nheads * HD
    proj = x @ p["w_in"]
    z, xbc, dt_raw = proj.split([width, width + 2 * n, nheads], dim=-1)

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

    xs_, b_in, c_in = conv.split([width, n, n], dim=-1)    # (b, s, N) each
    dt = F.softplus(dt_raw.float() + p["dt_bias"])           # (b, s, nh)
    a = -torch.exp(p["a_log"])                               # (nh,)
    da = torch.exp(dt * a)                                   # decay per step
    xh = xs_.reshape(b, s, nheads, HD).float()
    bf, cf = b_in.float(), c_in.float()
    dx = dt[..., None] * xh                                  # (b, s, nh, hd)
    mask = None if lengths is None else len_mask(lengths, b, s, x.device)
    h = (torch.zeros((b, nheads, HD, n), dtype=torch.float32,
                     device=x.device) if state is None else state.ssm)

    def step(h, xt):
        da_t, dx_t, b_t, c_t, m_t = xt
        h_new = h * da_t[:, :, None, None] + (
            dx_t[:, :, :, None] * b_t[:, None, None, :])
        h = h_new if m_t is None else torch.where(
            m_t[:, None, None, None], h_new, h)
        return h, (h @ c_t[:, None, :, None])[..., 0]         # (b, nh, hd)
    # per-step slices taken once; hlo_counter.scan is the loop over time
    steps = list(zip(da.unbind(1), dx.unbind(1), bf.unbind(1), cf.unbind(1),
                     [None] * s if mask is None else mask.unbind(1)))
    h, ys = hlo_counter.scan(step, h, steps)
    y = torch.stack(ys, dim=1)                               # (b, s, nh, hd)
    y = y + p["d_skip"][None, None, :, None] * xh            # skip connection
    y = y.reshape(b, s, width).to(x.dtype)

    # gated rmsnorm (mamba2 style): norm(y * silu(z)), over all of din
    g32 = (y * F.silu(z)).float()
    if sum_squares is None:
        var = torch.mean(g32 * g32, dim=-1, keepdim=True)
    else:
        var = sum_squares(torch.sum(g32 * g32, dim=-1, keepdim=True)) / din
    g = (g32 * torch.rsqrt(var + cfg.norm_eps)).to(x.dtype) * p["norm_w"]
    return g @ p["w_out"], Mamba2State(new_tail, h)


def decode_step(p, cfg: ModelConfig, x, state: Mamba2State):
    """Single-token step: x (b, 1, d)."""
    return forward(p, cfg, x, state)
