"""Fault tolerance: the step watchdog (straggler detection) and the NaN
guard of a train step.

The port's copy of ``repro.ft.resilience``:

  * :class:`Watchdog`    per-step deadline; on breach it records the
                         straggler event (the serving engines arm it around
                         each decode chunk, ``repro_torch.serve.engine``);
  * :func:`guard_update` reject non-finite losses / grad-norms.

``elastic_remesh`` (rebuild a mesh from the devices that are left) comes
with mesh and sharded serving, ROADMAP.md queue 1 item 6, and
``TrainLoop`` (checkpointed, auto-resuming train loop) with training, item
7; both raise ``NotImplementedError`` until then.
"""
from __future__ import annotations

import logging
import math
import threading
import time
from typing import Callable, Dict, Optional

log = logging.getLogger("repro_torch.ft")

__all__ = ["Watchdog", "guard_update", "elastic_remesh", "TrainLoop"]


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
        "elastic_remesh comes with mesh and sharded serving (ROADMAP.md "
        "queue 1 item 6)")


class TrainLoop:
    """Checkpointed, auto-resuming, NaN-guarded train loop: not ported
    yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "TrainLoop comes with training (ROADMAP.md queue 1 item 7)")
