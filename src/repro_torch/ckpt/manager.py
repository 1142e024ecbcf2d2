"""Checkpointing: atomic, async, with retention; the port of
``repro.ckpt.manager``.

Format: one ``arrays.npz`` per checkpoint step (flattened path -> array)
plus ``manifest.json`` (step, extra such as the data state), in
``step_%010d/``.  Paths are the port's state keys joined by ``/``
(``params/blocks/0/attn/wq``, ``opt/m/embed``; an 8-bit moment's payload
and scale as ``.../q`` and ``.../scale``).  Arrays are host copies: bf16
leaves are stored as fp32 (exact) and cast back to the template's dtype
on restore, onto the template's device.  Writes go to a temp dir and an
atomic rename; the async mode copies to the host on the train thread and
writes on a worker thread, so the loop overlaps I/O with compute.

On a mesh (``CheckpointManager(..., mesh=, specs=)``, ``specs`` the train
state's ``train.step.state_specs``), a checkpoint still holds the global
state, as the reference's do (``device_get`` of global arrays): ``save``
all-gathers the leaves one at a time over the data group and the model
group (every rank calls it) and the mesh's first rank writes them;
``restore`` has that rank pick the step and every rank cut its own shard
of each leaf.  So one checkpoint moves between meshes of any data and
model sizes and one process.

Manifests go through the checksummed atomic store of
``repro_torch.ft.artefacts``.  A corrupt manifest is quarantined
(``manifest.json.quarantine/``) and its step vanishes from
``all_steps()``; ``restore_latest`` falls back to the newest step that
still verifies instead of crashing the resume path."""
from __future__ import annotations

import logging
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.ft import artefacts
from repro_torch.optim.adamw import QTensor, leaves

log = logging.getLogger("repro_torch.ckpt")


def _host(t: torch.Tensor) -> np.ndarray:
    # a copy even for a CPU tensor: an async save writes it after the train
    # thread has moved on, and the step updates its state in place
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _parts(key: str, leaf, spec):
    """``(key, tensor, spec)`` of each tensor of a leaf (a QTensor's
    payload and scale under ``.../q`` and ``.../scale``)."""
    if isinstance(leaf, QTensor):
        specs = spec if spec is not None else (None, None)
        return [(f"{key}/q", leaf.q, specs[0]),
                (f"{key}/scale", leaf.scale, specs[1])]
    return [(key, leaf, spec)]


def _flatten(state, groups=None, specs=None) -> Dict[str, np.ndarray]:
    """Every leaf of ``state`` as a host array under its path; on a mesh
    (``groups``, its ``DataGroup`` and ``ModelGroup``, and the state's
    ``specs``) each leaf gathered whole first, and only the rank at index
    0 of both keeps it."""
    from repro_torch.sharding.collectives import gather_whole
    flat = {}
    for path, leaf in leaves(state):
        key = "/".join(str(k) for k in path)
        spec = _at(specs, path) if specs is not None else None
        for name, t, sp in _parts(key, leaf, spec):
            if groups is not None:
                t = gather_whole(t.detach(), sp, *groups)
                if any(g.index != 0 for g in groups):
                    continue
            flat[name] = _host(t)
    return flat


def _unflatten_into(template, flat: Dict[str, np.ndarray], path=(),
                    cut=None, spec=None):
    """A new state shaped like ``template`` from ``flat``, each leaf in the
    template's dtype, on its device, requiring grad where it does; on a
    mesh ``cut(array, spec)`` takes the rank's piece of each array, the
    spec read from ``spec`` (the state's spec tree) along the way."""
    if template is None:
        return None

    def sub(k):
        return None if spec is None else spec[k]
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, path + (k,), cut, sub(k))
                for k, v in template.items()}
    if isinstance(template, list):
        return [_unflatten_into(v, flat, path + (i,), cut, sub(i))
                for i, v in enumerate(template)]
    if isinstance(template, QTensor):
        return QTensor(_unflatten_into(template.q, flat, path + ("q",), cut,
                                       sub(0)),
                       _unflatten_into(template.scale, flat,
                                       path + ("scale",), cut, sub(1)))
    key = "/".join(str(k) for k in path)
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    arr = flat[key]
    if cut is not None:
        arr = cut(arr, spec)
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} "
                         f"vs template {tuple(template.shape)}")
    out = torch.from_numpy(np.array(arr)).to(device=template.device,
                                             dtype=template.dtype)
    return out.requires_grad_(template.requires_grad)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True, mesh=None,
                 specs: Optional[Dict] = None):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self.specs = specs
        self.group = self.model = self.world = None
        if mesh is not None:
            if specs is None:
                raise ValueError("a checkpoint on a mesh needs the state's "
                                 "specs (train.step.state_specs)")
            from repro_torch.sharding.collectives import (DataGroup,
                                                          ModelGroup,
                                                          WorldGroup)
            self.group = DataGroup(mesh)
            self.model = ModelGroup(mesh)
            self.world = WorldGroup(mesh)
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state, *, extra: Optional[Dict] = None) -> None:
        # the host copy, on the train thread (on a mesh, every rank gathers)
        groups = None if self.group is None else (self.group, self.model)
        flat = _flatten(state, groups, self.specs)
        if self.world is not None and self.world.index != 0:
            return
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, extra or {}))
            self._thread.start()
        else:
            self._write(step, flat, extra or {})

    def _write(self, step: int, flat: Dict[str, np.ndarray],
               extra: Dict) -> None:
        tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_")
        try:
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            artefacts.save_json(os.path.join(tmp, "manifest.json"),
                                {"step": step, "extra": extra})
            final = os.path.join(self.dir, f"step_{step:010d}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)       # atomic publish
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.startswith(".tmp"):
                manifest = os.path.join(self.dir, name, "manifest.json")
                if os.path.exists(manifest):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template) -> Tuple[Any, Dict]:
        path = os.path.join(self.dir, f"step_{step:010d}")
        manifest = artefacts.load_json(os.path.join(path, "manifest.json"),
                                       what="checkpoint manifest")
        if manifest is None:
            # missing or corrupt: corrupt copies are already quarantined and
            # reported by load_json, which also removes the step from
            # all_steps() (no manifest.json left); raise so restore_latest
            # falls back to an older step
            raise ValueError(
                f"checkpoint manifest for step {step} missing or corrupt "
                f"(quarantined; see artefact.load_failed events)")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        cut = None
        if self.group is not None:
            from repro_torch.sharding import rules

            def cut(arr, spec):
                return rules.local_shard(torch.from_numpy(np.array(arr)),
                                         self.group.mesh, spec,
                                         self.group.coordinate)
        state = _unflatten_into(template, flat, cut=cut, spec=self.specs)
        return state, manifest.get("extra", {})

    def restore_latest(self, template) -> Optional[Tuple[int, Any, Dict]]:
        """Restore the newest checkpoint that VERIFIES: a corrupt manifest
        or damaged arrays skips back to the next older step instead of
        killing the resume (losing a few steps of progress beats losing
        the run).  On a mesh its first rank picks the step and every rank
        restores that one."""
        if self.world is not None and self.world.size > 1:
            found = None
            if self.world.index == 0:
                found = self._restore_latest(template)
            step = self.world.broadcast_object(
                None if found is None else found[0])
            if step is None:
                return None
            if found is not None:
                return found
            state, extra = self.restore(step, template)
            return step, state, extra
        return self._restore_latest(template)

    def _restore_latest(self, template):
        for step in reversed(self.all_steps()):
            try:
                state, extra = self.restore(step, template)
            except (ValueError, KeyError, OSError) as e:
                log.warning("checkpoint step %d failed to restore (%s: "
                            "%s); falling back to the previous step",
                            step, type(e).__name__, e)
                continue
            return step, state, extra
        return None
