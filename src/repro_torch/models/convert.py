"""Params of the reference, as numpy, into the port's layout.

``params_from_numpy(cfg, tree)`` takes the JAX ``Model.init_params`` tree
with every array already converted to numpy (``jax.tree_util.tree_map(
np.asarray, params)``; NamedTuples may stay or be ``_asdict()``-ed), so
this module needs no JAX: ``embed``, ``ln_f``, ``head`` and
``blocks``, whose leaves carry a leading layer axis of length
``cfg.n_layers`` (a MoE layer's ``MoeParams`` stacked ``(L, E, ...)``,
the router ``(L, d, E)``; ssm's ``RwkvBlockParams`` stacked ``(L, ...)``).
It returns the port's params dict, with one entry of ``blocks`` per
layer, in ``cfg.dtype`` on ``device`` (the router in fp32, as drawn; an
audio model's ``embed`` is ``(K, vocab, d)`` in both).  The hybrid's
``HybridParams`` become a dict: its ``(G, E, ...)`` ``mamba`` /
``mamba_ln`` stacks nested lists [group][layer], and ``shared_ln``,
``shared_attn``, ``shared_ln2``, ``shared_mlp`` carried once.  The
recurrent families keep each leaf's own dtype (their decay, LoRA, bonus
and SSM parameters are fp32 in a bf16 model, as drawn).  Arrays in
bfloat16 (``ml_dtypes``) convert exactly through float32.

``train_state_from_numpy(cfg, tree)`` does the same for the reference's
``make_train_state`` tree (``params``, ``opt.m``, ``opt.v``, ``opt.step``,
``step``): the port's train state (``repro_torch.train.step``), params
requiring grad, moments fp32 or 8-bit ``QTensor``s (a stacked leaf's one
scale copied to every layer)."""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from .common import ModelConfig


def _tensor(a: np.ndarray, dtype: Optional[torch.dtype],
            device) -> torch.Tensor:
    """``a`` as a tensor of ``dtype`` (None: ``a``'s own)."""
    a = np.asarray(a)
    if dtype is None:
        dtype = (torch.bfloat16 if a.dtype.name == "bfloat16"
                 else getattr(torch, a.dtype.name))
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.tensor(a, dtype=dtype, device=device)


def _is_qtensor(node) -> bool:
    """The reference's 8-bit moment leaf: a ``(q, scale)`` NamedTuple."""
    return tuple(getattr(node, "_fields", ())) == ("q", "scale")


def _layer(node: Any, i: int, leaf):
    """Layer ``i`` of a stacked subtree of the reference, each leaf (an
    array or a QTensor) through ``leaf(node, i)``."""
    if node is None:
        return None
    if hasattr(node, "_asdict") and not _is_qtensor(node):
        node = node._asdict()             # a NamedTuple of the reference
    if isinstance(node, dict):
        return {k: _layer(v, i, leaf) for k, v in node.items()}
    return leaf(node, i)


def _port_layout(cfg: ModelConfig, tree: Dict[str, Any], leaf) -> Dict:
    """A params-shaped tree of the reference in the port's layout; a
    top-level leaf goes through ``leaf(node, None)``."""
    blocks = tree["blocks"]
    if cfg.family == "hybrid":
        if hasattr(blocks, "_asdict"):
            blocks = blocks._asdict()
        g, e = cfg.n_layers // cfg.attn_every, cfg.attn_every
        blocks = {k: ([[_layer(v, (gi, ei), leaf) for ei in range(e)]
                       for gi in range(g)] if k in ("mamba", "mamba_ln")
                      else _layer(v, None, leaf))
                  for k, v in blocks.items()}
    else:
        blocks = [_layer(blocks, i, leaf) for i in range(cfg.n_layers)]
    return {
        "embed": leaf(tree["embed"], None),
        "ln_f": leaf(tree["ln_f"], None),
        "head": leaf(tree["head"], None),
        "blocks": blocks,
    }


def _pick(a, i):
    a = np.asarray(a)
    return a if i is None else a[i]


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                      device: DeviceLike = None) -> Dict:
    device = resolve_device(device)
    dt = None if cfg.family in ("ssm", "hybrid") else cfg.torch_dtype

    out = _port_layout(cfg, tree,
                       lambda a, i: _tensor(_pick(a, i), dt, device))
    if cfg.n_experts:
        # the router stays fp32 in a model of any dtype, as drawn
        router = _layer(tree["blocks"], None, lambda a, i: a)["mlp"]["router"]
        for i, layer in enumerate(out["blocks"]):
            layer["mlp"]["router"] = _tensor(_pick(router, i), torch.float32,
                                             device)
    return out


def train_state_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                           device: DeviceLike = None) -> Dict:
    """The reference's train state, as numpy, in the port's layout."""
    from repro_torch.optim import adamw
    device = resolve_device(device)
    params = params_from_numpy(cfg, tree["params"], device)
    for _, p in adamw.leaves(params):
        p.requires_grad_(True)

    def moment(node, i):
        if _is_qtensor(node):
            return adamw.QTensor(
                torch.tensor(_pick(node.q, i), dtype=torch.int8,
                             device=device),
                _tensor(node.scale, torch.float32, device))
        return _tensor(_pick(node, i), torch.float32, device)

    def step(a):
        return torch.tensor(np.asarray(a), dtype=torch.int32, device=device)
    opt = tree["opt"]
    return {"params": params,
            "opt": {"m": _port_layout(cfg, opt["m"], moment),
                    "v": _port_layout(cfg, opt["v"], moment),
                    "step": step(opt["step"])},
            "step": step(tree["step"])}
