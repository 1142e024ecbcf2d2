"""The train step: microbatch gradient accumulation (optionally in bf16),
AdamW leaf by leaf in place, and the NaN guard; the port of
``repro.train.step`` on one device.

``make_train_step`` returns ``step(state, batch) -> (state, metrics)``.
The state (``make_train_state``) is ``{"params", "opt": {"m", "v",
"step"}, "step"}``; ``step`` updates it in place and returns it, as the
reference's jitted step donates its input state (``donate=True``): a
caller that needs the old state keeps a copy.  ``metrics`` are host
numbers: ``loss``, ``grad_norm``, ``lr`` and ``applied``.

The NaN guard decides before the update: the loss and the global gradient
norm are read on the host (one sync a step) and, when either is not
finite, nothing is written: params, moments and both step counters keep
their bits (the reference computes the update and selects the old state
with ``jnp.where``, which a donated, in-place state cannot do).  An
exception raised once the update has begun leaves the state partly
written; the step re-raises it as ``PartialUpdateError``, which
``TrainLoop`` does not retry without a checkpoint to restore.

Remat is the model's (``cfg.remat``: each block under
``torch.utils.checkpoint``).  Sharding (``state_specs``, a mesh of more
than one device) waits for sharded serving and training (ROADMAP.md queue 1
item 7b)."""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.ft.resilience import PartialUpdateError
from repro_torch.models.transformer import Model
from repro_torch.optim import adamw

_MESH_ITEM = ("sharded training comes with sharded serving and training "
              "(ROADMAP.md queue 1 item 7b)")


def make_train_state(model: Model, generator: torch.Generator, *,
                     use_8bit: bool = False, device: DeviceLike = None
                     ) -> Dict:
    """Params drawn from ``generator`` on ``device`` (the card unless
    ``"cpu"``), marked to require grad, zero AdamW moments and counters."""
    device = resolve_device(device)
    params = model.init_params(generator, device)
    for _, p in adamw.leaves(params):
        p.requires_grad_(True)
    return {"params": params, "opt": adamw.init(params, use_8bit=use_8bit),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def state_specs(*args, **kwargs):
    """Shardings of the train state: not ported yet."""
    raise NotImplementedError(_MESH_ITEM)


def _one_device(mesh) -> None:
    if mesh is None:
        return
    size = getattr(mesh, "size", None)
    if size != 1:
        raise NotImplementedError(f"a mesh of {size} devices: {_MESH_ITEM}")


def _to_tensors(batch: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).to(device=device, dtype=torch.long)
            for k, v in batch.items()}


def gradients(model: Model, params, batch: Dict[str, torch.Tensor], *,
              microbatches: int = 1, grad_bf16: bool = True):
    """``(loss, grads, div)``: the loss (detached) and the gradient of
    every leaf of ``params`` (in :func:`adamw.leaves` order) on ``batch``.

    With ``microbatches > 1`` the batch is cut along its first axis; each
    microbatch's gradients are cast to bf16 (``grad_bf16``, else fp32) and
    summed in that dtype in microbatch order; ``div`` is the count the
    sum is to be divided by (in fp32, by the optimizer), the loss the mean
    of the microbatches'."""
    flat = [t for _, t in adamw.leaves(params)]
    if microbatches == 1:
        loss = model.loss(params, batch)
        return loss.detach(), list(torch.autograd.grad(loss, flat)), 1
    b = batch["tokens"].shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} does not split into {microbatches} "
                         f"microbatches")
    per = b // microbatches
    acc_dtype = torch.bfloat16 if grad_bf16 else torch.float32
    acc, losses = None, []
    for i in range(microbatches):
        mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
        loss = model.loss(params, mb)
        g = torch.autograd.grad(loss, flat)
        losses.append(loss.detach())
        if acc is None:
            acc = [x.to(acc_dtype) for x in g]
        else:
            for a, x in zip(acc, g):
                a.add_(x.to(acc_dtype))
        del g
    return torch.stack(losses).mean(), acc, microbatches


def make_train_step(model: Model, mesh=None, *, microbatches: int = 1,
                    base_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10000, grad_bf16: bool = True):
    """The train step of ``model`` (see the module docstring); its
    gradients are :func:`gradients`'."""
    _one_device(mesh)
    cfg = model.cfg

    def step(state: Dict, batch: Dict):
        params = state["params"]
        batch = _to_tensors(batch, adamw.leaves(params)[0][1].device)
        loss, grads_flat, div = gradients(model, params, batch,
                                          microbatches=microbatches,
                                          grad_bf16=grad_bf16)
        grads = adamw.unflatten(params, grads_flat)
        del grads_flat
        lr = adamw.cosine_schedule(state["step"], base_lr=base_lr,
                                   warmup=warmup, total=total_steps)
        gnorm = adamw.global_norm(grads, div=div)
        loss_v, gnorm_v, lr_v = torch.stack(
            [loss.float(), gnorm, lr]).tolist()       # the step's host sync
        good = math.isfinite(loss_v) and math.isfinite(gnorm_v)
        if good:
            try:
                adamw.update(params, grads, state["opt"], lr=lr,
                             use_8bit=cfg.opt_8bit, grad_div=div,
                             grad_norm=gnorm)
                state["step"] += 1
            except Exception as exc:
                raise PartialUpdateError(
                    f"the in-place update failed partway "
                    f"({type(exc).__name__}: {exc})") from exc
        return state, {"loss": loss_v, "grad_norm": gnorm_v, "lr": lr_v,
                       "applied": int(good)}

    return step
