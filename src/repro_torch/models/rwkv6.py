"""RWKV6 "Finch": attention-free time-mix with data-dependent decay.

The port of ``repro.models.rwkv6``.  Token-shift lerps, a data-dependent
LoRA for the decay ``w_t = exp(-exp(w0 + lora(x)))`` in fp32, and a
matrix-valued per-head WKV state S in R^{hd x hd}:

    o_t = r_t (S_{t-1} + u k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t

plus the squared-ReLU channel-mix.  The recurrence is a Python loop over
time of plain PyTorch ops (the reference's ``lax.scan`` in XLA, outside
any Pallas kernel); the projections are ``torch.matmul``.  State per layer:
``tshift`` and ``cshift`` (b, d) in the model dtype and ``wkv`` (b, nh, hd,
hd) in fp32.

Params are a dict with the reference's field names (``Rwkv6Params``):
the mixes (d,) and projections (d, d) / (d, f) / (f, d) in the model
dtype, ``w0`` (d,), ``w_lora_a`` (d, 64), ``w_lora_b`` (64, d) and ``u``
(nh, hd) in fp32, as the reference draws them.  The functions return new
state tensors; the model writes them into its cache in place."""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from .common import ModelConfig, init_dense

HD = 64
LORA = 64


class Rwkv6State(NamedTuple):
    tshift: torch.Tensor     # (..., b, d) last token (time-mix)
    cshift: torch.Tensor     # (..., b, d) last token (channel-mix)
    wkv: torch.Tensor        # (..., b, nh, hd, hd) float32


def nheads(cfg: ModelConfig) -> int:
    return cfg.d_model // HD


def init_rwkv6(generator: torch.Generator, cfg: ModelConfig, device=None
               ) -> Dict[str, torch.Tensor]:
    """One layer's params: the reference's distributions and dtypes."""
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.torch_dtype
    dev = device or generator.device
    f32 = torch.float32

    def full(n, v, dtype):
        return torch.full((n,), v, dtype=dtype, device=dev)

    def dense(i, o, dtype=dt, scale=None):
        return init_dense(generator, i, o, dtype, scale=scale, device=dev)
    return {
        "mix_r": full(d, 0.5, dt), "mix_k": full(d, 0.5, dt),
        "mix_v": full(d, 0.5, dt), "mix_w": full(d, 0.5, dt),
        "w_r": dense(d, d), "w_k": dense(d, d), "w_v": dense(d, d),
        "w_o": dense(d, d),
        "w0": full(d, -0.6, f32),
        "w_lora_a": dense(d, LORA, f32, 0.01),
        "w_lora_b": dense(LORA, d, f32, 0.01),
        "u": torch.zeros((nheads(cfg), HD), dtype=f32, device=dev),
        "cmix_r": full(d, 0.5, dt), "cmix_k": full(d, 0.5, dt),
        "cw_r": dense(d, d), "cw_k": dense(d, f), "cw_v": dense(f, d),
    }


def init_state(cfg: ModelConfig, batch: int, device=None,
               lead: tuple = ()) -> Rwkv6State:
    """Zero state of ``batch`` rows, with leading stack dims ``lead``."""
    d, nh = cfg.d_model, nheads(cfg)
    kw = dict(dtype=cfg.torch_dtype, device=device)
    return Rwkv6State(
        tshift=torch.zeros(lead + (batch, d), **kw),
        cshift=torch.zeros(lead + (batch, d), **kw),
        wkv=torch.zeros(lead + (batch, nh, HD, HD), dtype=torch.float32,
                        device=device))


def len_mask(lengths, b: int, s: int, device) -> torch.Tensor:
    """(b, s) bool: True at the real-token positions of a RIGHT-padded
    batch."""
    lengths = torch.as_tensor(lengths, device=device).long()
    return torch.arange(s, device=device)[None, :] < lengths[:, None]


def last_real(x, lengths) -> torch.Tensor:
    """x[:, lengths - 1, :]: each row's last REAL token (right padding)."""
    b, s = x.shape[:2]
    idx = (torch.as_tensor(lengths, device=x.device).long() - 1).clamp(
        0, s - 1)
    return x[torch.arange(b, device=x.device), idx]


def _shifted(x, shift0):
    """The previous token of every position: ``shift0`` then x[:, :-1]."""
    if shift0 is None:
        shift0 = torch.zeros_like(x[:, 0])
    return torch.cat([shift0[:, None].to(x.dtype), x[:, :-1]], dim=1)


def time_mix(p, cfg: ModelConfig, x, state: Optional[Rwkv6State] = None,
             lengths=None):
    """x: (b, s, d) -> (y, tshift, wkv).  ``state`` None: a fresh sequence
    (zero states).

    ``lengths`` ((b,) int, optional) marks each row's real prompt length
    in a RIGHT-padded batch: the wkv update is masked off at padded
    positions and the returned token-shift is the last *real* token, so
    the state after a padded prefill is bitwise the unpadded state."""
    b, s, d = x.shape
    nh = nheads(cfg)
    prev = _shifted(x, None if state is None else state.tshift)

    def lerp(mix):
        return x + (prev - x) * mix

    r = lerp(p["mix_r"]) @ p["w_r"]
    k = lerp(p["mix_k"]) @ p["w_k"]
    v = lerp(p["mix_v"]) @ p["w_v"]
    # data-dependent decay (Finch), fp32
    wx = lerp(p["mix_w"]).float()
    lora = torch.tanh(wx @ p["w_lora_a"]) @ p["w_lora_b"]
    w = torch.exp(-torch.exp(p["w0"] + lora))             # (b, s, d) in (0,1)

    rh = r.reshape(b, s, nh, HD).float()
    kh = k.reshape(b, s, nh, HD).float()
    vh = v.reshape(b, s, nh, HD).float()
    wh = w.reshape(b, s, nh, HD)
    mask = None if lengths is None else len_mask(lengths, b, s, x.device)
    u = p["u"][..., None]                                  # (nh, hd, 1)
    S = (torch.zeros((b, nh, HD, HD), dtype=torch.float32, device=x.device)
         if state is None else state.wkv)
    outs = []
    for t in range(s):
        kv = kh[:, t, :, :, None] * vh[:, t, :, None, :]   # (b, nh, hd, hd)
        outs.append((rh[:, t, :, None, :] @ (S + u * kv))[:, :, 0])
        S_new = wh[:, t, :, :, None] * S + kv
        S = S_new if mask is None else torch.where(
            mask[:, t, None, None, None], S_new, S)
    y = torch.stack(outs, dim=1).reshape(b, s, d).to(x.dtype)
    y = y @ p["w_o"]
    tshift = x[:, -1] if lengths is None else last_real(x, lengths)
    return y, tshift, S


def channel_mix(p, cfg: ModelConfig, x, state: Optional[Rwkv6State] = None,
                lengths=None):
    """x: (b, s, d) -> (y, cshift): squared ReLU, sigmoid gate."""
    prev = _shifted(x, None if state is None else state.cshift)
    xr = x + (prev - x) * p["cmix_r"]
    xk = x + (prev - x) * p["cmix_k"]
    r = torch.sigmoid(xr @ p["cw_r"])
    k = torch.square(torch.relu(xk @ p["cw_k"]))
    cshift = x[:, -1] if lengths is None else last_real(x, lengths)
    return r * (k @ p["cw_v"]), cshift
