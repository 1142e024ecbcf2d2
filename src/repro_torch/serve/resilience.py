"""Serving resilience: request terminal states, the engine's fault policy,
and the recording of a degradation.

The port's copy of ``repro.serve.resilience``.  A fault never crashes the
engine: it moves one request to a terminal non-``ok`` state, or moves the
*strategy* one rung down a recorded degradation ladder, while co-batched
clean requests keep their tokens bit for bit.

  * :data:`STATES` / :class:`RequestResult`: the per-request terminal
    contract surfaced by ``pop_result`` / ``take_result``;
  * :class:`ResilienceConfig`: the engine policy knobs (NaN guard, chunk
    retry budget and backoff, chunk straggler deadline, pool validation);
  * :func:`record_degradation`: the one way a fallback becomes visible: an
    obs provenance Decision with origin ``degraded(from->to)``, the
    ``serve.degradations`` counter, an event and a flight-recorder dump.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch import obs

__all__ = ["STATES", "TERMINAL_NON_OK", "RequestResult", "ResilienceConfig",
           "record_degradation"]

# Per-request terminal states (the request-lifecycle contract):
#   ok         ran to completion; tokens are the full decode output
#   timeout    e2e or TTFT deadline expired; tokens are the partial output
#   cancelled  caller cancelled; tokens are the partial output
#   failed     quarantined (non-finite logits, repeated chunk failure, or
#              explicit fail()); tokens are the partial output
STATES = ("ok", "timeout", "cancelled", "failed")
TERMINAL_NON_OK = ("timeout", "cancelled", "failed")


@dataclasses.dataclass
class RequestResult:
    """Terminal outcome of one request: tokens + state + why."""
    req_id: int
    tokens: Tuple[int, ...]
    state: str                  # one of STATES
    reason: str = ""            # human-readable cause for non-ok states
    # seconds from submission to the first token (None if it never came);
    # the port's addition: the reference reads TTFT from its obs histograms
    ttft_s: Optional[float] = None

    @property
    def ok(self) -> bool:
        return self.state == "ok"


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Engine-level fault policy (defaults are safe for production).

    ``nan_guard``: compute a per-slot non-finite flag inside the decode
    chunk (a reduction over each step's logits, no change to the token
    dataflow) and quarantine poisoned slots at the chunk boundary.

    ``max_chunk_retries`` / ``retry_backoff_s``: transient decode-chunk
    failures (a failure before the chunk was dispatched) are retried with
    linear backoff; on exhaustion every in-flight request fails and the
    device state is rebuilt rather than crashing.

    ``chunk_deadline_s``: when set, a chunk exceeding it records a
    straggler event through the hardened ``ft.resilience.Watchdog``
    (detection only: the chunk is synchronous, so mitigation is a
    scheduling concern).

    ``pool_check``: validate the paged ``BlockPool`` free-list invariants
    each chunk; corruption degrades paged -> dense instead of corrupting
    cross-request KV state.
    """
    nan_guard: bool = True
    max_chunk_retries: int = 2
    retry_backoff_s: float = 0.02
    chunk_deadline_s: Optional[float] = None
    quarantine_on_chunk_failure: bool = True
    pool_check: bool = True


def record_degradation(kind: str, kernel: str, key: str, frm: str, to: str,
                       params: Optional[Dict[str, object]] = None,
                       dump: bool = True, **kw) -> str:
    """Record one rung of the degradation ladder; returns the origin string.

    A provenance Decision with origin ``degraded(frm->to)`` (so
    ``obs.explain()`` answers why the strategy changed), the
    ``serve.degradations`` counter, and an event carrying the cause.
    ``kw`` passes through to ``obs.record`` (shape / dtype / backend /
    layout / note / ...).  ``dump=False`` suppresses the flight-recorder
    snapshot for a caller that writes its own dump for the same incident.
    """
    origin = f"degraded({frm}->{to})"
    obs.record(kind, kernel, key, params or {}, origin, **kw)
    obs.counter("serve.degradations").inc()
    obs.event("serve.degraded", kind=kind, kernel=kernel, key=key,
              origin=origin, note=str(kw.get("note", "")))
    if dump:
        # a degradation is a strategy change under duress: snapshot the
        # black box so the dump shows what led up to it
        obs.flight_dump("degradation", kind=kind, kernel=kernel, key=key,
                        frm=frm, to=to)
    return origin
