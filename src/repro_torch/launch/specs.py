"""Shape stand-ins for every (arch x input-shape) cell, and the sharding
specs that go with them: the port of ``repro.launch.specs``, used by the
dry run (``launch/dryrun.py``).

Where the reference builds ``jax.ShapeDtypeStruct`` trees with
``jax.eval_shape``, these build tensors on the ``meta`` device: shapes and
dtypes, no data, no allocation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import Model
from repro_torch.sharding import rules

# the assigned shape grid (LM-family: seq_len x global_batch)
SHAPES: Dict[str, Dict] = {
    "train_4k":    {"seq": 4_096,   "batch": 256, "kind": "train"},
    "prefill_32k": {"seq": 32_768,  "batch": 32,  "kind": "prefill"},
    "decode_32k":  {"seq": 32_768,  "batch": 128, "kind": "decode"},
    "long_500k":   {"seq": 524_288, "batch": 1,   "kind": "decode"},
}


def shape_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic sequence mixing."""
    if shape == "long_500k" and not cfg.subquadratic:
        return False, ("long_500k skipped: pure full-attention architecture "
                       "(O(s^2) prefill / O(s) KV per step at 524k is out of "
                       "scope per the assignment)")
    return True, ""


def _dp_size(mesh) -> int:
    shape = rules.mesh_shape(mesh)
    return math.prod(shape[a] for a in ("pod", "data") if a in shape)


def _batch_ps(mesh, batch: int) -> rules.PS:
    dp = rules.dp_axes(mesh)
    if dp and batch % _dp_size(mesh) == 0:
        return rules.PS(dp)
    return rules.PS(None)


def _meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: str, mesh=None, *,
                info: Optional[Dict] = None):
    """(meta-tensor dict, spec dict) for the step function's data inputs
    (int32, as the reference's); ``info`` overrides ``SHAPES[shape]``."""
    info = info or SHAPES[shape]
    seq, batch, kind = info["seq"], info["batch"], info["kind"]
    tok_shape = (batch, seq)
    if cfg.n_codebooks:
        tok_shape = tok_shape + (cfg.n_codebooks,)

    if kind == "train":
        sds = {"tokens": _meta(tok_shape), "labels": _meta((batch, seq))}
        if mesh is None:
            return sds, None
        bp = _batch_ps(mesh, batch)
        return sds, {"tokens": bp, "labels": bp}

    if kind == "prefill":
        sds = {"tokens": _meta(tok_shape)}
        if mesh is None:
            return sds, None
        return sds, {"tokens": _batch_ps(mesh, batch)}

    # decode: one new token against a seq-long cache
    tok1 = (batch, 1) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
    sds = {"token": _meta(tok1), "pos": _meta(())}
    if mesh is None:
        return sds, None
    return sds, {"token": _batch_ps(mesh, batch), "pos": rules.PS()}


def model_for(cfg: ModelConfig, shape: str, *,
              info: Optional[Dict] = None) -> Model:
    info = info or SHAPES[shape]
    return Model(dataclasses.replace(cfg, max_seq=info["seq"]))


def cache_sds(model: Model, shape: str, *, info: Optional[Dict] = None):
    info = info or SHAPES[shape]
    return model.init_cache(info["batch"], info["seq"], device="meta")


def params_sds(model: Model):
    return model.init_params(torch.Generator(), "meta")


def train_state_sds(model: Model):
    from repro_torch.train.step import make_train_state
    return make_train_state(model, torch.Generator(),
                            use_8bit=model.cfg.opt_8bit, device="meta")
