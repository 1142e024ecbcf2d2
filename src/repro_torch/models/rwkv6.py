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
state tensors; the model writes them into its cache in place.

Inside a tensor-parallel train step (``sharding.ctx.
get_tensor_parallel()``) ``x`` is this rank's sequence rows and each
mixer computes its share (``TensorParallel``): the time-mix on the
rank's heads (``w_r`` / ``w_k`` / ``w_v``, ``w_lora_b``'s columns, ``w0``
and ``u`` cut to them, the recurrence per head over the whole sequence,
``w_o`` row-parallel), the channel-mix on its ff columns (``cw_k``
column-parallel, ``cw_v`` row-parallel); the token-shift lerps and the
LoRA's first product run whole on every rank for its heads (their
gradients summed over ``model``).  Where ``model`` does not divide the
heads, the time-mix runs whole on every rank.

A serving step on a model axis (``sharding.serving.ServingStep``) runs
the same split and gives each mixer its state in the mixer's piece
(``TensorParallel.state_in``): ``wkv`` of the rank's heads (of every head
where the time-mix runs whole), ``tshift`` / ``cshift`` whole (the lerps
read every column).  The mixers return the new state in that piece, the
shifts taken at each row's last real token of the whole sequence, which
every rank holds (SP's gather, or with SP off the rows themselves)."""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.analysis import hlo_counter
from repro_torch.sharding import ctx
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
    the state after a padded prefill is bitwise the unpadded state.

    Inside a tensor-parallel step: ``y`` of the rank's rows, and the
    state in the mixer's piece (module docstring)."""
    tp = ctx.get_tensor_parallel()
    if tp is not None:
        return _time_mix_tp(p, cfg, x, tp, state, lengths)
    return _time_mix(p, cfg, x, state, lengths)


def _time_mix_tp(p, cfg: ModelConfig, x, tp, state=None, lengths=None):
    path = "blocks/mix"
    if not tp.split_mixer:
        take = tp.mixer_take(path)
        local = {k: take(v, k) for k, v in p.items()}
        out = []

        def whole(xw):
            y, tshift, wkv = _time_mix(local, cfg, xw, state, lengths)
            out[:] = [tshift, wkv]
            return y
        return (tp.whole_mixer(whole, x), *out)
    cols, heads = tp.mixer_cols, tp.mixer_heads
    local = {k: tp.whole(p[k], f"{path}/{k}")
             for k in ("mix_r", "mix_k", "mix_v", "mix_w", "w_lora_a")}
    for k in ("w_r", "w_k", "w_v", "w_lora_b"):
        local[k] = tp.part(p[k], f"{path}/{k}", 1, cols)
    local["w0"] = tp.part(p["w0"], f"{path}/w0", 0, cols)
    local["u"] = tp.part(p["u"], f"{path}/u", 0, heads)
    local["w_o"] = tp.part(p["w_o"], f"{path}/w_o", 0, cols)
    # the whole sequence on every rank (SP's gather, or with SP off the
    # rows themselves): the shift's last real token is read from it
    y, tshift, wkv = _time_mix(local, cfg, tp.enter(x), state, lengths)
    return tp.exit(y), tshift, wkv


def _time_mix(p, cfg: ModelConfig, x, state, lengths):
    """The time-mix on the heads of ``p`` (``u``'s rows: every head, or a
    rank's)."""
    b, s, d = x.shape
    nh = p["u"].shape[0]
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

    def step(S, xt, u):
        r_t, k_t, v_t, w_t, m_t = xt
        kv = k_t[:, :, :, None] * v_t[:, :, None, :]       # (b, nh, hd, hd)
        out = (r_t[:, :, None, :] @ (S + u * kv))[:, :, 0]
        S_new = w_t[:, :, :, None] * S + kv
        return (S_new if m_t is None else torch.where(
            m_t[:, None, None, None], S_new, S)), out
    # per-step slices taken once (their gradients stacked back once);
    # hlo_counter.scan is the loop over time, or one step at s's weight
    # under a scaled op count
    steps = list(zip(rh.unbind(1), kh.unbind(1), vh.unbind(1), wh.unbind(1),
                     [None] * s if mask is None else mask.unbind(1)))
    S, outs = hlo_counter.scan(step, S, steps, u)
    y = torch.stack(outs, dim=1).reshape(b, s, nh * HD).to(x.dtype)
    y = y @ p["w_o"]
    tshift = x[:, -1] if lengths is None else last_real(x, lengths)
    return y, tshift, S


def channel_mix(p, cfg: ModelConfig, x, state: Optional[Rwkv6State] = None,
                lengths=None):
    """x: (b, s, d) -> (y, cshift): squared ReLU, sigmoid gate.  Inside a
    tensor-parallel step: ``(y of the rank's rows, cshift)``, the gate on
    the rank's rows multiplying the row-parallel product's sum, the shift
    the whole last real token."""
    tp = ctx.get_tensor_parallel()
    if tp is not None:
        return _channel_mix_tp(p, x, tp, state, lengths)
    prev = _shifted(x, None if state is None else state.cshift)
    xr = x + (prev - x) * p["cmix_r"]
    xk = x + (prev - x) * p["cmix_k"]
    r = torch.sigmoid(xr @ p["cw_r"])
    k = torch.square(torch.relu(xk @ p["cw_k"]))
    cshift = x[:, -1] if lengths is None else last_real(x, lengths)
    return r * (k @ p["cw_v"]), cshift


def _channel_mix_tp(p, x, tp, state=None, lengths=None):
    """The rank's ff columns: ``cw_k`` column-parallel on the whole
    sequence, ``cw_v`` row-parallel, its partial sums summed into the
    rank's rows (SP's reduce-scatter, or with SP off the all-reduce);
    then the gate ``sigmoid(xr @ cw_r)`` of those rows multiplies the
    sum, never a rank's partial sum.  Returns ``(y, cshift)``, the shift
    read from the whole sequence."""
    path = "blocks/mix"
    shift0 = None if state is None else state.cshift
    xw = tp.enter(x)
    prev = _shifted(xw, shift0)
    xk = xw + (prev - xw) * tp.whole(p["cmix_k"], f"{path}/cmix_k")
    k = torch.square(torch.relu(
        xk @ tp.part(p["cw_k"], f"{path}/cw_k", 1, tp.ff_cols)))
    kv = tp.exit(k @ tp.part(p["cw_v"], f"{path}/cw_v", 0, tp.ff_cols))
    # the gate: under SP the rank's rows of the whole sequence's shift;
    # with SP off every rank gates the whole sequence alike (its params'
    # gradients whole, not summed)
    if tp.sp:
        lo, hi = tp.rows
        gx, gprev = xw[:, lo:hi], prev[:, lo:hi]
    else:
        gx, gprev = x, _shifted(x, shift0)
    xr = gx + (gprev - gx) * tp.norm_weight(p["cmix_r"], f"{path}/cmix_r")
    r = torch.sigmoid(xr @ tp.norm_weight(p["cw_r"], f"{path}/cw_r"))
    cshift = xw[:, -1] if lengths is None else last_real(xw, lengths)
    return r * kv, cshift
