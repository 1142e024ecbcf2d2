"""Serving with the params split over ``model``: one rank's prefill and
decode step on a mesh, placed as the reference's dry run places them.

The reference lowers ``model.prefill`` and ``model.decode_step`` under
``jit`` with ``rules.params_specs`` and ``rules.cache_specs`` on its
production meshes (``repro.launch.dryrun``); GSPMD then partitions them.
Its engines serve on a data axis only, as the port's do, so the model axis
reaches serving through those two calls alone.  In the port each rank is a
process that holds its pieces and calls the same ``Model`` methods under
the step's context (``sharding.ctx``):

  * the params: the rank's pieces under ``params_specs`` (FSDP's data
    split gathered where used, as in the train step);
  * the cache: its piece under ``cache_specs`` (``rules.shard_cache``):
    of the KV leaves its batch rows, and either its kv heads or its
    positions; of the recurrent state leaves (rwkv6's, the hybrid's
    mamba state) whatever the rules give, which is not the mixers' split
    (``rules.state_slice``);
  * the tokens: its batch rows, where the data axes divide the batch (else
    the whole batch, as the reference's input spec leaves it);
  * ``sharding.collectives.TensorParallel`` of the step's sequence (the
    prompt's, or 1 for a decode step) with the rank's KV slice
    (``rules.kv_slice``; none for rwkv6, which has no KV) and state slice,
    which ``models.attention``, ``models.ffn``, ``models.rwkv6``,
    ``models.mamba2`` and ``models.transformer`` read: each layer's
    state moves from the rules' piece into the mixers' and back
    (``collectives.StateMove``).

The logits come back whole over the vocab on every rank of ``model``, for
the rank's batch rows.  Every family runs here, on its dense prefill and
decode step.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

from . import ctx, rules

__all__ = ["ServingStep"]


class ServingStep:
    """One rank's serving step of ``model`` on ``mesh`` (a ``DeviceMesh``
    with named dims, or a ``collectives.CountingMesh``) for a global batch
    of ``batch`` rows and a cache of ``max_seq`` positions."""

    def __init__(self, model, mesh, batch: int, max_seq: int):
        from repro_torch.train.step import _Placement
        cfg = model.cfg
        self.model, self.mesh, self.cfg = model, mesh, cfg
        self.place = _Placement(model, mesh)
        self.coordinate = dict(zip(rules.mesh_shape(mesh),
                                   mesh.get_coordinate()))
        self.batch = batch
        layers = model.groups if cfg.family == "hybrid" else cfg.n_layers
        self.kv = None if cfg.family == "ssm" else rules.kv_slice(
            cfg, mesh, (layers, batch, max_seq, cfg.n_kv_heads, cfg.hd),
            self.coordinate)
        self.state = rules.state_slice(
            cfg, mesh, model.init_cache(batch, max_seq, device="meta"),
            self.coordinate)
        if self.place.model.size == 1 and self._state_moves():
            raise NotImplementedError(
                f"{cfg.name} on {rules.mesh_shape(mesh)}: the rules split "
                f"its recurrent state over the data axes, and the state "
                f"moves between the rules' pieces and the mixers' run on a "
                f"model axis's TensorParallel alone")
        self._tp: Dict[int, object] = {}

    def _state_moves(self) -> bool:
        """Whether a state leaf's data split is not the tokens' rows (a
        layer dim, or nothing while the rows are split): then each layer's
        state has to move between the pieces."""
        from .collectives import splits
        d = self.place.group.size
        for name, s in self.state.items():
            batch = 2 if name.startswith("mamba/") else 1
            rows = batch if d > 1 and s["shape"][batch] % d == 0 else None
            if splits(self.mesh, s["spec"])["data"] != rows:
                return True
        return False

    # -- placement ------------------------------------------------------------
    def shard_params(self, params):
        """The rank's pieces of the global ``params`` under
        ``rules.params_specs``."""
        specs = rules.params_specs(params, self.mesh, self.cfg)
        return rules.tree_map_specs(
            lambda spec, t: rules.local_shard(t, self.mesh, spec,
                                              self.coordinate).clone(),
            specs, params)

    def shard_cache(self, cache):
        """The rank's piece of the global serving ``cache``."""
        return rules.shard_cache(self.cfg, self.mesh, cache, self.coordinate)

    def rows(self, t):
        """The rank's batch rows of ``t`` (tokens, lengths): its share where
        the data axes divide the batch, else all of them."""
        group = self.place.group
        if t is None or self.batch % group.size:
            return t
        n = self.batch // group.size
        return t[group.index * n:(group.index + 1) * n]

    # -- the step -------------------------------------------------------------
    def tensor_parallel(self, seq: int):
        """The model axis's ``TensorParallel`` of a step of ``seq`` tokens
        a row, with the rank's KV and state slices."""
        from .collectives import TensorParallel
        if seq not in self._tp:
            self._tp[seq] = TensorParallel(
                self.place.model, self.place.model_dims, self.cfg, seq,
                kv=self.kv, state=self.state, data=self.place.group)
        return self._tp[seq]

    @contextlib.contextmanager
    def scope(self, seq: int):
        """The context of one step of ``seq`` tokens a row: the mesh, the
        FSDP gather where the rules split params over the data axes, and
        the model axis's ``TensorParallel``."""
        place = self.place
        prev = ctx.get_mesh()
        ctx.set_mesh(self.mesh)
        try:
            with contextlib.ExitStack() as stack:
                if place.any_split and place.group.size > 1:
                    stack.enter_context(ctx.param_gather(place.gather))
                if place.model.size > 1:
                    stack.enter_context(ctx.tensor_parallel(
                        self.tensor_parallel(seq)))
                yield
        finally:
            ctx.set_mesh(prev)

    def prefill(self, params, tokens: torch.Tensor, cache, start: int = 0,
                lengths=None):
        """``Model.prefill`` of the rank's ``tokens`` (b, s[, K]) into its
        ``cache``: (last logits (b, vocab), cache), the cache written in
        place."""
        with torch.no_grad(), self.scope(tokens.shape[1]):
            return self.model.prefill(params, tokens, cache, start=start,
                                      lengths=lengths)

    def decode_step(self, params, token: torch.Tensor, cache, pos):
        """``Model.decode_step`` of the rank's ``token`` (b, 1[, K]) at
        ``pos`` (a scalar, or a (b,) tensor of the rank's rows)."""
        with torch.no_grad(), self.scope(1):
            return self.model.decode_step(params, token, cache, pos)
