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


def _flatten(state) -> Dict[str, np.ndarray]:
    """Every leaf of ``state`` as a host array under its path."""
    flat = {}
    for path, leaf in leaves(state):
        key = "/".join(str(k) for k in path)
        if isinstance(leaf, QTensor):
            flat[f"{key}/q"] = _host(leaf.q)
            flat[f"{key}/scale"] = _host(leaf.scale)
        else:
            flat[key] = _host(leaf)
    return flat


def _unflatten_into(template, flat: Dict[str, np.ndarray], path=()):
    """A new state shaped like ``template`` from ``flat``, each leaf in the
    template's dtype, on its device, requiring grad where it does."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, path + (k,))
                for k, v in template.items()}
    if isinstance(template, list):
        return [_unflatten_into(v, flat, path + (i,))
                for i, v in enumerate(template)]
    if isinstance(template, QTensor):
        return QTensor(_unflatten_into(template.q, flat, path + ("q",)),
                       _unflatten_into(template.scale, flat,
                                       path + ("scale",)))
    key = "/".join(str(k) for k in path)
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    arr = flat[key]
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} "
                         f"vs template {tuple(template.shape)}")
    out = torch.from_numpy(np.array(arr)).to(device=template.device,
                                             dtype=template.dtype)
    return out.requires_grad_(template.requires_grad)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state, *, extra: Optional[Dict] = None) -> None:
        flat = _flatten(state)   # the host copy, on the train thread
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
        state = _unflatten_into(template, flat)
        return state, manifest.get("extra", {})

    def restore_latest(self, template) -> Optional[Tuple[int, Any, Dict]]:
        """Restore the newest checkpoint that VERIFIES: a corrupt manifest
        or damaged arrays skips back to the next older step instead of
        killing the resume (losing a few steps of progress beats losing
        the run)."""
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
