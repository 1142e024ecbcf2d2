"""FFN layers: the SwiGLU MLP and the top-k MoE with capacity-based
dispatch (``repro.models.ffn``).

MoE params of one layer are a dict: ``router`` (d, E) in fp32, ``w_gate``
/ ``w_up`` (E, d, f) and ``w_down`` (E, f, d) in the config's dtype (the
reference stacks them under a leading layer axis as well).

:func:`moe` is the reference's ``ffn.moe`` on the tokens it is given.
The reference routes per GShard group, one group per data-parallel shard
of its global batch; a tensor of the port is one rank's rows, which are
that rank's group, so the port routes them as one group.  Inside a
sharded train step (``sharding.ctx.get_expert_parallel()``) the
load-balancing statistics are then averaged over the data group, as the
reference's means over all groups.

Dispatch and combine keep fixed shapes (no host sync, so the decode
chunk's CUDA graph captures the MoE) and use no atomics (a bf16 run is
bitwise itself twice): each kept (token, choice) entry owns its
``(expert, slot)`` and is copied there; a dropped entry, which the
reference adds as zeros into its clipped slot, is copied into a trash
slot past the capacity that nothing reads.  The combine sums each token's
``k`` gated outputs in choice order, as the reference's scatter-add.
Every expert runs over its whole capacity buffer (``torch.matmul``, as
the reference's einsums)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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


def mlp(p: Dict[str, torch.Tensor], x, path: str = "blocks/mlp"):
    """The SwiGLU MLP.  Inside a tensor-parallel train step (``sharding.
    ctx.get_tensor_parallel()``) ``x`` is this rank's rows and the rank
    computes its ff columns: ``w_gate`` / ``w_up`` column-parallel,
    ``w_down`` row-parallel, its partial sums reduce-scattered into SP (or
    all-reduced with SP off).  ``path`` is the rules' path of the weights
    (``blocks/shared_mlp`` for the hybrid's shared block)."""
    tp = ctx.get_tensor_parallel()
    if tp is not None:
        p = {"w_gate": tp.part(p["w_gate"], f"{path}/w_gate", 1,
                               tp.ff_cols),
             "w_up": tp.part(p["w_up"], f"{path}/w_up", 1, tp.ff_cols),
             "w_down": tp.part(p["w_down"], f"{path}/w_down", 0,
                               tp.ff_cols)}
        return tp.exit(_swiglu(p, tp.enter(x)))
    return _swiglu(p, x)


def _swiglu(p, x):
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


def init_moe(generator: torch.Generator, cfg: ModelConfig, device=None
             ) -> Dict[str, torch.Tensor]:
    """One MoE layer's params, drawn as the reference's distributions."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = cfg.torch_dtype

    def stack(i, o):
        return torch.stack([init_dense(generator, i, o, dt, device=device)
                            for _ in range(e)])
    return {"router": init_dense(generator, d, e, torch.float32,
                                 device=device),
            "w_gate": stack(d, f), "w_up": stack(d, f),
            "w_down": stack(f, d)}


def capacity(cfg: ModelConfig, tl: int) -> int:
    """Slots per expert for a group of ``tl`` tokens: the reference's
    ``max(int(cf * tl * k / e), min(tl, 64), 1)`` (decode-sized groups
    never drop)."""
    return max(int(cfg.moe_capacity_factor * tl * cfg.top_k
                   / cfg.n_experts), min(tl, 64), 1)


def route(router: torch.Tensor, x: torch.Tensor, k: int):
    """Softmax routing in fp32: ``(probs, topk_p, topk_i)`` for tokens
    ``x`` (..., d), the top-k gates renormalised."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    topk_p, topk_i = torch.topk(probs, k, dim=-1)
    return probs, topk_p / topk_p.sum(dim=-1, keepdim=True), topk_i


def slots(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Each entry's position among the entries of its bucket (``idx`` along
    the last dim, values in ``[0, n)``): the reference's cumsum of one-hot
    rows."""
    oh = F.one_hot(idx, n).to(torch.int32)
    return (oh.cumsum(dim=-2) * oh).sum(dim=-1) - 1


def load_balance(probs, topk_i, e: int, k: int, mean=None):
    """The Switch aux ``e * sum(me * ce) / k`` from the router's mean
    probabilities and the mean count of choices per expert over every
    token; ``mean`` (default the identity) takes each of the two means
    over the ranks it spans."""
    me = probs.reshape(-1, e).mean(dim=0)
    ce = F.one_hot(topk_i, e).float().sum(dim=-2).reshape(-1, e).mean(dim=0)
    if mean is not None:
        me, ce = mean(me), mean(ce)
    return e * (me * ce).sum() / k


def combine(yk: torch.Tensor, gate: torch.Tensor, k: int) -> torch.Tensor:
    """``(t * k, d)`` expert outputs -> (t, d): each gated by its gate and
    the ``k`` of a token summed in choice order."""
    yk = (yk * gate[:, None].to(yk.dtype)).view(-1, k, yk.shape[-1])
    out = yk[:, 0]
    for j in range(1, k):
        out = out + yk[:, j]
    return out


def experts(p: Dict[str, torch.Tensor], buf: torch.Tensor) -> torch.Tensor:
    """SwiGLU of each expert over its buffer: ``buf`` (..., E, c, d)
    against ``w_*`` (E, d, f) / (E, f, d)."""
    h = F.silu(buf @ p["w_gate"]) * (buf @ p["w_up"])
    return h @ p["w_down"]


def moe(p: Dict[str, torch.Tensor], cfg: ModelConfig, x
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE of ``x`` (b, s, d) as one routing group: ``(out, aux)``
    (module docstring)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    tl = b * s
    cap = capacity(cfg, tl)
    xt = x.reshape(tl, d)
    probs, topk_p, topk_i = route(p["router"], xt, k)
    ep = ctx.get_expert_parallel()
    aux = load_balance(probs, topk_i, e, k,
                       mean=None if ep is None else ep.data_mean)

    flat_i = topk_i.reshape(-1)                                  # (tl * k,)
    pos = slots(flat_i, e)
    keep = pos < cap
    gate = topk_p.reshape(-1) * keep
    # kept entries to their own slot, dropped ones to the trash slot `cap`
    dest = flat_i * (cap + 1) + torch.where(keep, pos, cap)
    # each entry's token (no repeat_interleave: it syncs the host)
    tok = torch.arange(tl * k, device=x.device) // k
    buf = xt.new_zeros((e * (cap + 1), d)).index_copy(0, dest, xt[tok])
    ye = experts(p, buf.view(e, cap + 1, d)[:, :cap])            # (e, cap, d)
    yk = ye[flat_i, pos.clamp(max=cap - 1)]                      # (tl * k, d)
    out = combine(yk, gate, k)
    return out.reshape(b, s, d).to(x.dtype), aux
