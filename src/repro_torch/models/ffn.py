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
    (module docstring).  On a model axis (``sharding.ctx.
    get_tensor_parallel()``), the reference's GSPMD MoE on the rank's
    share of the experts: :func:`_moe_model_axis`."""
    tp = ctx.get_tensor_parallel()
    if tp is not None:
        return _moe_model_axis(p, cfg, x, tp)
    b, s, d = x.shape
    plan = _Routing(p["router"], cfg, x.reshape(b * s, d))
    ye = experts(p, plan.dispatch(x.reshape(b * s, d)))          # (e, cap, d)
    return plan.combine(ye).reshape(b, s, d).to(x.dtype), plan.aux


class _Routing:
    """One routing group's top-k choices of ``xt`` (tl, d): ``aux``, and
    each (token, choice) entry's expert, slot and gate (0 for an entry past
    the capacity, which is dropped); :meth:`dispatch` fills the experts'
    buffers, :meth:`combine` takes their outputs back."""

    def __init__(self, router, cfg: ModelConfig, xt, aux_grad: float = 1.0):
        tl = xt.shape[0]
        e, k = cfg.n_experts, cfg.top_k
        self.e, self.k, self.cap = e, k, capacity(cfg, tl)
        probs, topk_p, topk_i = route(router, xt, k)
        ep = ctx.get_expert_parallel()
        self.aux = load_balance(probs, topk_i, e, k,
                                mean=None if ep is None else ep.data_mean)
        if aux_grad != 1.0:
            self.aux = _ScaleGrad.apply(self.aux, aux_grad)
        cap = self.cap
        self.flat_i = topk_i.reshape(-1)                         # (tl * k,)
        self.pos = slots(self.flat_i, e)
        keep = self.pos < cap
        self.gate = topk_p.reshape(-1) * keep
        # kept entries to their own slot, dropped ones to the trash slot
        self.dest = self.flat_i * (cap + 1) + torch.where(keep, self.pos, cap)
        # each entry's token (no repeat_interleave: it syncs the host)
        self.tok = torch.arange(tl * k, device=xt.device) // k

    def dispatch(self, xt) -> torch.Tensor:
        """The experts' buffers (e, cap, d) of ``xt`` (the tokens routed)."""
        e, cap, d = self.e, self.cap, xt.shape[-1]
        buf = xt.new_zeros((e * (cap + 1), d)).index_copy(0, self.dest,
                                                          xt[self.tok])
        return buf.view(e, cap + 1, d)[:, :cap]

    def combine(self, ye) -> torch.Tensor:
        """The experts' outputs ``ye`` (e, cap, d) -> (tl, d)."""
        yk = ye[self.flat_i, self.pos.clamp(max=self.cap - 1)]  # (tl * k, d)
        return combine(yk, self.gate, self.k)


# the rules' path of a MoE layer's weights
_MOE_PATH = "blocks/mlp"


class _ScaleGrad(torch.autograd.Function):
    """The identity whose gradient is multiplied by ``scale``."""

    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def _moe_model_axis(p, cfg: ModelConfig, x, tp):
    """:func:`moe` on a model axis (``tp``, a ``sharding.collectives.
    TensorParallel``): ``x`` is the rank's rows (SP) or the whole sequence,
    and the result its rows of the output, with the aux of the whole
    routing group, the same on every rank of ``model``.

    The reference runs its GSPMD ``ffn.moe`` here, per GShard group (one a
    data shard), with the experts placed by its ``param_spec``; every rank
    routes the whole sequence of its batch rows, so capacities and drops
    are the reference's (decode's ``min(tl, 64)`` floor keeps every
    token).

      * **Experts over ``model``** (``model`` divides them): the rank runs
        its experts over their buffers and the outputs are all-gathered
        over ``model`` (the reference's one all-gather of ``ye``) for the
        combine in the reference's order.  This is every serving step on
        such a mesh, and the train step's where ``model`` does not divide
        the sequence (``models.moe_ep`` takes the others).  With SP off
        every rank repeats the routing whole, so its gradients are whole:
        the buffers' input is summed over ``model`` (only the rank's
        experts read it), and the aux's gradient is multiplied by the
        ranks of ``model``, each of which adds a share of it to the loss.
      * **Otherwise** (grok-1-314b's 8 experts on ``model=16``): the rules
        split each expert's ff dim over ``model``, and the rank runs every
        expert on its ff columns, ``w_gate`` / ``w_up`` by columns and
        ``w_down`` by rows, a row-parallel MLP: its combined partial sums
        are reduce-scattered into SP (all-reduced with SP off), and the
        routing's gradients, partial too, are summed over ``model``."""
    path = _MOE_PATH
    if tp.dims[f"{path}/w_gate"] == 0:
        return _moe_expert_split(p, cfg, x, tp)
    w = {"router": tp.whole(p["router"], f"{path}/router"),
         "w_gate": tp.part(p["w_gate"], f"{path}/w_gate", 2, tp.ff_cols),
         "w_up": tp.part(p["w_up"], f"{path}/w_up", 2, tp.ff_cols),
         "w_down": tp.part(p["w_down"], f"{path}/w_down", 1, tp.ff_cols)}
    xw = tp.enter(x)
    b, s, d = xw.shape
    xt = xw.reshape(b * s, d)
    plan = _Routing(w["router"], cfg, xt)
    out = plan.combine(experts(w, plan.dispatch(xt)))
    return tp.exit(out.reshape(b, s, d).to(x.dtype)), plan.aux


def _moe_expert_split(p, cfg: ModelConfig, x, tp):
    """The experts-over-``model`` case of :func:`_moe_model_axis`."""
    from repro_torch.sharding.collectives import (copy_to, gather_param,
                                                  gather_replicated)
    path = _MOE_PATH
    group = tp.group
    m, r = group.size, group.index
    el = cfg.n_experts // m
    w = {}
    for name in ("w_gate", "w_up", "w_down"):
        t = p[name]
        w[name] = t if t.shape[0] == el else t.narrow(0, r * el, el)
    if tp.sp:
        xw = xr = tp.enter(x)
        router, gather, aux_grad = (tp.whole(p["router"], f"{path}/router"),
                                    gather_param, 1.0)
    else:
        xw, xr = copy_to(x, group), x
        router, gather, aux_grad = (tp.replicated(p["router"],
                                                  f"{path}/router"),
                                    gather_replicated, float(m))
    b, s, d = xw.shape
    plan = _Routing(router, cfg, xr.reshape(b * s, d), aux_grad)
    buf = plan.dispatch(xw.reshape(b * s, d))[r * el:(r + 1) * el]
    ye = gather(experts(w, buf), group, 0)                       # (e, cap, d)
    out = plan.combine(ye).reshape(b, s, d).to(x.dtype)
    if tp.sp:
        lo, hi = tp.rows
        out = out[:, lo:hi].contiguous()
    return out, plan.aux
