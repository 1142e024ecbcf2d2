"""Params of the reference, as numpy, into the port's layout.

``params_from_numpy(cfg, tree)`` takes the JAX ``Model.init_params`` tree
with every array already converted to numpy (``jax.tree_util.tree_map(
np.asarray, params)``; NamedTuples may stay or be ``_asdict()``-ed), so
this module needs no JAX: ``embed``, ``ln_f``, ``head`` and
``blocks``, whose leaves carry a leading layer axis of length
``cfg.n_layers``.  It returns the port's params dict, with one entry of
``blocks`` per layer, in ``cfg.dtype`` on ``device``.  Arrays in
bfloat16 (``ml_dtypes``) convert exactly through float32."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from .common import ModelConfig


def _tensor(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.tensor(a, dtype=dtype, device=device)


def _layer(node: Any, i: int, dtype, device):
    if node is None:
        return None
    if hasattr(node, "_asdict"):          # a NamedTuple of the reference
        node = node._asdict()
    if isinstance(node, dict):
        return {k: _layer(v, i, dtype, device) for k, v in node.items()}
    return _tensor(np.asarray(node)[i], dtype, device)


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                      device: DeviceLike = None) -> Dict:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    device = resolve_device(device)
    dt = cfg.torch_dtype
    return {
        "embed": _tensor(tree["embed"], dt, device),
        "ln_f": _tensor(tree["ln_f"], dt, device),
        "head": _tensor(tree["head"], dt, device),
        "blocks": [_layer(tree["blocks"], i, dt, device)
                   for i in range(cfg.n_layers)],
    }
