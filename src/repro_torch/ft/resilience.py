"""Fault tolerance: the step watchdog (straggler detection), the NaN
guard of a train step, and the checkpointed, auto-resuming train loop.

The port's copy of ``repro.ft.resilience``:

  * :class:`Watchdog`    per-step deadline; on breach it records the
                         straggler event (the serving engines arm it around
                         each decode chunk, ``repro_torch.serve.engine``);
  * :func:`guard_update` reject non-finite losses / grad-norms;
  * :class:`TrainLoop`   checkpoint every N steps (async), restore-latest
                         on entry, bounded retry with restore on
                         exceptions, skipped (non-finite) steps counted.

``elastic_remesh`` (rebuild a mesh from the devices that are left) comes
with sharded serving and training (ROADMAP.md queue 1 item 7b) and raises
``NotImplementedError`` until then.
"""
from __future__ import annotations

import logging
import math
import threading
import time
from typing import Callable, Dict, Optional

log = logging.getLogger("repro_torch.ft")

__all__ = ["Watchdog", "guard_update", "elastic_remesh", "TrainLoop",
           "PartialUpdateError"]


class PartialUpdateError(RuntimeError):
    """A train step failed after it began writing its state in place: the
    state is partly updated, and only a restore repairs it."""


class Watchdog:
    """Flags steps exceeding ``deadline_s`` (straggler mitigation hook).

    Race-free: ``threading.Timer.cancel()`` does not stop a callback that
    has already started, so ``_fire`` can run concurrently with, or just
    after, ``disarm()`` on the step-completion path, recording a spurious
    straggler for a step that finished in time.  Every ``arm()`` therefore
    issues a generation token; ``_fire`` re-checks under the lock that its
    generation is still the armed one (and fires at most once per arm),
    and ``disarm()`` retires the generation before cancelling the timer.
    """

    def __init__(self, deadline_s: float = 300.0,
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        self.deadline = deadline_s
        self.on_straggler = on_straggler or (
            lambda step, dt: log.warning(
                "step %d exceeded deadline (%.1fs > %.1fs) — straggler "
                "suspected", step, dt, self.deadline))
        self.events = []
        self._armed_at: Optional[float] = None
        self._step = 0
        self._timer: Optional[threading.Timer] = None
        self._lock = threading.Lock()
        self._gen = 0           # incremented on every arm
        self._live_gen = -1     # the generation allowed to fire (-1: none)
        self._fired = False     # current generation already fired

    def arm(self, step: int) -> None:
        with self._lock:
            self._retire_locked()
            self._gen += 1
            self._live_gen = self._gen
            self._fired = False
            self._step = step
            self._armed_at = time.monotonic()
            self._timer = threading.Timer(self.deadline, self._fire,
                                          args=(self._gen,))
            self._timer.daemon = True
            self._timer.start()

    def _fire(self, gen: int) -> None:
        with self._lock:
            if gen != self._live_gen or self._fired:
                return  # disarmed (step completed) or duplicate firing
            self._fired = True
            step = self._step
            dt = time.monotonic() - (self._armed_at or time.monotonic())
            self.events.append((step, dt))
        self.on_straggler(step, dt)

    def disarm(self) -> None:
        with self._lock:
            self._retire_locked()

    def _retire_locked(self) -> None:
        self._live_gen = -1
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None


def guard_update(metrics: Dict) -> bool:
    """True if the step's numerics are sane (update may be applied)."""
    loss = float(metrics.get("loss", 0.0))
    gn = float(metrics.get("grad_norm", 0.0))
    return math.isfinite(loss) and math.isfinite(gn)


def elastic_remesh(preferred, axis_names=None):
    """The largest mesh the devices that are left support: not ported
    yet."""
    raise NotImplementedError(
        "elastic_remesh comes with sharded serving and training "
        "(ROADMAP.md queue 1 item 7b)")


class TrainLoop:
    """Checkpointed, auto-resuming, NaN-guarded train loop.

    ``step_fn(state, batch) -> (state, metrics)`` is a train step
    (``repro_torch.train.step``: in place, host metrics); ``data`` a
    ``SyntheticLM``; ``ckpt_mgr`` a ``CheckpointManager``, whose
    checkpoints carry the data state in their extra.

    A step that raises is retried (up to ``max_retries`` in a row) from
    the newest checkpoint, or, with none, from the state as it is, since
    a failure before the update leaves it untouched.  A failure after the
    update began (:class:`PartialUpdateError`) with no checkpoint to
    restore propagates: the reference's functional step cannot reach a
    partly written state, and retrying on one would train from it."""

    def __init__(self, step_fn, ckpt_mgr, data, *, ckpt_every: int = 100,
                 max_retries: int = 3, deadline_s: float = 600.0):
        self.step_fn = step_fn
        self.ckpt = ckpt_mgr
        self.data = data
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.watchdog = Watchdog(deadline_s)
        self.skipped_steps = 0

    def run(self, state, *, num_steps: int, on_metrics=None):
        from repro_torch.data.pipeline import DataState
        restored = self.ckpt.restore_latest(state)
        start = 0
        data_state = None
        if restored is not None:
            start, state, extra = restored
            data_state = extra.get("data_state")
            log.info("resumed from checkpoint step %d", start)

        ds = (DataState.from_dict(data_state) if data_state
              else DataState(step=start))
        it = self.data.iterator(ds)

        retries = 0
        step = start
        while step < num_steps:
            batch, ds = next(it)
            try:
                self.watchdog.arm(step)
                new_state, metrics = self.step_fn(state, batch)
                self.watchdog.disarm()
            except Exception as exc:
                self.watchdog.disarm()
                retries += 1
                if retries > self.max_retries:
                    raise
                restored = self.ckpt.restore_latest(state)
                if restored is None and isinstance(exc, PartialUpdateError):
                    raise
                log.exception("step %d failed; restoring last checkpoint "
                              "(retry %d/%d)", step, retries,
                              self.max_retries)
                if restored is not None:
                    step, state, extra = restored
                    ds = DataState.from_dict(extra.get(
                        "data_state", {"step": step}))
                    it = self.data.iterator(ds)
                continue

            if not guard_update(metrics):
                # the train step suppressed the update (train/step.py's NaN
                # guard); record the event and move on
                log.warning("step %d non-finite (loss=%s): the update was "
                            "suppressed", step, metrics.get("loss"))
                self.skipped_steps += 1

            state = new_state
            retries = 0
            if on_metrics:
                on_metrics(step, metrics)
            step += 1
            if step % self.ckpt_every == 0:
                self.ckpt.save(step, state,
                               extra={"data_state": ds.to_dict()})
        self.ckpt.wait()
        return state
