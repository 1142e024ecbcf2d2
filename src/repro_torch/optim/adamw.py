"""AdamW with global-norm clipping, a cosine schedule and optional 8-bit
moments (per-tensor-scaled int8): the port of ``repro.optim.adamw``.

The update runs leaf by leaf and in place (the reference returns new
trees): no fp32 copy of the whole gradient tree is ever made, which is
what lets qwen3-4b's params, gradients and fp32 moments (≈ 53 GB) train on
one 80 GB card.  Each leaf's fp32 temporaries live only while that leaf
updates.

Layout.  The port keeps one dict per layer (``params["blocks"][i]``) where
the reference stacks every block leaf along a leading layer axis.  Two of
the reference's semantics read that axis, and both are kept as the
reference's layout gives them:

  * decoupled weight decay applies to leaves of ``ndim >= 2`` *in the
    reference's layout*: every block leaf (its stacked ``(L, d)`` norms
    ``ln1``, ``ln2``, ``q_norm``, ``k_norm`` included), ``embed`` and
    ``head``; not ``ln_f``;
  * an 8-bit moment has one scale per stacked leaf: the amax over all
    layers of that leaf.  Every layer's :class:`QTensor` holds the same
    scale.

A "group" below is one leaf of the reference: a top-level tensor, or the
L per-layer tensors of one block leaf."""
from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

__all__ = ["QTensor", "init", "cosine_schedule", "global_norm",
           "sum_squares", "update", "leaves", "groups", "tree_map",
           "unflatten", "decays"]


class QTensor(NamedTuple):
    q: torch.Tensor       # int8 payload
    scale: torch.Tensor   # () float32 scale of the whole stacked leaf


# ---- the port's param trees -------------------------------------------------

def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of a params-shaped tree (dicts, lists; a
    QTensor is one leaf; None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def leaves(tree, path: Tuple = ()) -> List[Tuple[Tuple, object]]:
    """``(path, leaf)`` of every non-None leaf, in a fixed order: dict keys
    sorted (the reference's pytree order), layers in order.  A QTensor is
    one leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in leaves(v, path + (i,))]
    return [(path, tree)]


def unflatten(template, flat: List):
    """A tree shaped like ``template`` whose leaves are ``flat``, in
    :func:`leaves` order."""
    it = iter(flat)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)
    return build(template)


def groups(params) -> List[Tuple[Tuple, int]]:
    """The reference's leaves as ``(path, stacked)``: a path without the
    layer indices, and how many stacked layer axes the reference's leaf
    has (0: one tensor; 1: a block leaf, one tensor a layer; 2: the
    hybrid's ``mamba`` / ``mamba_ln``, one a (group, layer)).  Ordered as
    the reference's pytree: dict keys sorted, block leaves in the order of
    the first layer's leaves (the hybrid's shared block once)."""
    out = []
    for k in sorted(params):
        if k == "blocks":
            blocks = params[k]
            if isinstance(blocks, list):
                if blocks:
                    out += [(("blocks",) + p, 1)
                            for p, _ in leaves(blocks[0])]
                continue
            for kk in sorted(blocks):
                node, n = blocks[kk], 0
                while isinstance(node, list):
                    node, n = node[0], n + 1
                out += [(("blocks", kk) + p, n) for p, _ in leaves(node)]
        elif params[k] is not None:
            out.append(((k,), 0))
    return out


def _members(tree, path: Tuple, stacked: int) -> list:
    """The tensors (or QTensors) of group ``path`` in ``tree``: one per
    layer (or per group and layer) when stacked."""
    nodes = [tree]
    for key in path:
        nodes = [node[key] for node in nodes]
        while isinstance(nodes[0], list):
            nodes = [x for node in nodes for x in node]
    return nodes


def decays(path: Tuple, leaf: torch.Tensor, stacked: int) -> bool:
    """Whether decoupled weight decay applies: ``ndim >= 2`` in the
    reference's layout, where a block leaf has its leading stacked axes."""
    return leaf.ndim + int(stacked) >= 2


# ---- the optimizer -----------------------------------------------------------

def _quantize(x: torch.Tensor, amax: Optional[torch.Tensor] = None
              ) -> QTensor:
    """int8 payload and fp32 scale ``max(amax, 1e-12) / 127``, ``amax``
    defaulting to ``max |x|`` (a stacked leaf passes its layers' amax)."""
    amax = x.abs().max() if amax is None else amax
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale)


def _dequantize(t: QTensor) -> torch.Tensor:
    return t.q.float() * t.scale


def init(params, *, use_8bit: bool = False) -> Dict:
    """Zero moments shaped like ``params`` (fp32, or 8-bit QTensors) and a
    zero int32 step, on the params' device."""
    def zero_like(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return _quantize(z) if use_8bit else z
    dev = leaves(params)[0][1].device
    return {"m": tree_map(zero_like, params),
            "v": tree_map(zero_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def cosine_schedule(step: torch.Tensor, *, base_lr: float, warmup: int,
                    total: int, min_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``base_lr``, then cosine decay to ``min_frac`` of
    it: an fp32 tensor on ``step``'s device (0 at step 0)."""
    step_f = step.float()
    warm = torch.clamp(step_f / max(warmup, 1), max=1.0)
    prog = torch.clamp((step_f - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * warm * cos


def _f32(g: torch.Tensor, div: float) -> torch.Tensor:
    """A gradient leaf in fp32, divided by ``div`` (the microbatch count,
    after a bf16 sum): may be ``g`` itself, so never written to."""
    g = g.float()
    return g if div == 1 else g / div


def sum_squares(grads, *, div: float = 1,
                keep: Optional[Callable] = None) -> torch.Tensor:
    """The sum over leaves (in :func:`leaves` order; only those whose path
    ``keep(path)`` accepts, when given) of the fp32 sum of squares of each
    leaf divided by ``div``; an fp32 zero when none is kept."""
    total = None
    for path, g in leaves(grads):
        if keep is not None and not keep(path):
            continue
        f = _f32(g, div)
        s = torch.sum(f * f)
        total = s if total is None else total + s
    if total is None:
        return torch.zeros((), dtype=torch.float32,
                           device=leaves(grads)[0][1].device)
    return total


def global_norm(grads, *, div: float = 1) -> torch.Tensor:
    """sqrt of the sum over leaves of the fp32 sum of squares (leaves in
    :func:`leaves` order), of each leaf divided by ``div``."""
    return torch.sqrt(sum_squares(grads, div=div))


def update(params, grads, state: Dict, *, lr, b1: float = 0.9,
           b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
           clip_norm: Optional[float] = 1.0, use_8bit: bool = False,
           grad_div: float = 1, grad_norm: Optional[torch.Tensor] = None,
           reduce_amax: Optional[Callable] = None) -> Dict:
    """One AdamW step, in place on ``params`` and ``state`` (``m``, ``v``,
    ``step``); returns ``{"grad_norm": ...}``.

    ``grads`` is shaped like ``params``; each leaf is taken in fp32 and
    divided by ``grad_div`` first.  ``grad_norm`` may pass the global
    norm already computed (the train step's NaN guard reads it first).

    8-bit moments are updated in two passes over every group: the new
    moments' amax of each group first, then the params and the quantized
    moments.  Between them ``reduce_amax``, when given, takes the list of
    every group's ``(amax_m, amax_v)`` and returns it reduced (the sharded
    step's one ``all_reduce(MAX)`` over ranks that hold shards)."""
    gnorm = global_norm(grads, div=grad_div) if grad_norm is None \
        else grad_norm
    if clip_norm is not None:
        scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
    else:
        scale = None
    state["step"] += 1
    step_f = state["step"].float()
    bc1 = 1 - torch.pow(b1, step_f)
    bc2 = 1 - torch.pow(b2, step_f)
    ctx = dict(lr=lr, b1=b1, b2=b2, eps=eps, scale=scale, div=grad_div,
               bc1=bc1, bc2=bc2)
    quantized = []
    with torch.no_grad():
        for path, stacked in groups(params):
            ps = _members(params, path, stacked)
            gs = _members(grads, path, stacked)
            ms = _members(state["m"], path, stacked)
            vs = _members(state["v"], path, stacked)
            wd = weight_decay if decays(path, ps[0], stacked) else 0.0
            if use_8bit:
                quantized.append((ps, gs, ms, vs, wd))
            else:
                for p, g, m, v in zip(ps, gs, ms, vs):
                    _moments(g, m, v, **ctx)
                    _apply(p, m, v, wd=wd, **ctx)
        if quantized:
            amaxes = [_amax_8bit(gs, ms, vs, **ctx)
                      for _, gs, ms, vs, _ in quantized]
            if reduce_amax is not None:
                amaxes = reduce_amax(amaxes)
            for (ps, gs, ms, vs, wd), amax in zip(quantized, amaxes):
                _apply_8bit(ps, gs, ms, vs, amax, wd=wd, **ctx)
    return {"grad_norm": gnorm}


def _scaled(g, *, scale, div, **_):
    g = _f32(g, div)
    return g * scale if scale is not None else g.clone()


def _moments(g, m, v, *, b1, b2, **ctx):
    """m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2, in place (fp32)."""
    g = _scaled(g, **ctx)
    m.mul_(b1).add_(g * (1 - b1))
    v.mul_(b2).add_(g.square_().mul_(1 - b2))


def _apply(p, m, v, *, lr, eps, bc1, bc2, wd, **_):
    """p -= lr * (mhat / (sqrt(vhat) + eps) + wd * p), in fp32, rounded
    once to p's dtype."""
    delta = torch.div(m, bc1).div_(torch.div(v, bc2).sqrt_().add_(eps))
    p32 = p.float()
    if wd:
        delta.add_(p32 * wd)
    delta.mul_(lr)
    if p32 is p:
        p.sub_(delta)
    else:
        p.copy_(p32.sub_(delta))


def _new_moments_8bit(g, m, v, *, b1, b2, **ctx):
    g = _scaled(g, **ctx)
    m_new = _dequantize(m).mul_(b1).add_(g * (1 - b1))
    v_new = _dequantize(v).mul_(b2).add_(g.square_().mul_(1 - b2))
    return m_new, v_new


def _amax_8bit(gs, ms, vs, **ctx):
    """Pass 1 of a stacked leaf's 8-bit update: its new moments' amax
    over every layer (computed and dropped)."""
    amax_m = amax_v = None
    for g, m, v in zip(gs, ms, vs):
        m_new, v_new = _new_moments_8bit(g, m, v, **ctx)
        a_m, a_v = m_new.abs().max(), v_new.abs().max()
        amax_m = a_m if amax_m is None else torch.maximum(amax_m, a_m)
        amax_v = a_v if amax_v is None else torch.maximum(amax_v, a_v)
    return amax_m, amax_v


def _apply_8bit(ps, gs, ms, vs, amax, *, wd, **ctx):
    """Pass 2: each layer's moments again, quantized with the leaf's one
    scale, and the params updated from the unquantized moments."""
    amax_m, amax_v = amax
    for p, g, m, v in zip(ps, gs, ms, vs):
        m_new, v_new = _new_moments_8bit(g, m, v, **ctx)
        _apply(p, m_new, v_new, wd=wd, **ctx)
        for t, new, a in ((m, m_new, amax_m), (v, v_new, amax_v)):
            qt = _quantize(new, a)
            t.q.copy_(qt.q)
            t.scale.copy_(qt.scale)
