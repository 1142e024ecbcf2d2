"""Per-request terminal states, as ``Scheduler.pop_result`` reports them.

The port's copy of the part of ``repro.serve.resilience`` the scheduler
needs: :data:`STATES`, :data:`TERMINAL_NON_OK` and :class:`RequestResult`.
The engine policy (``ResilienceConfig``: NaN guard, chunk retries, the
straggler deadline, pool checks) and ``record_degradation`` come with the
rest of the serving spine, ROADMAP.md queue 1 item 4."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["STATES", "TERMINAL_NON_OK", "RequestResult"]

# Per-request terminal states (the request-lifecycle contract):
#   ok         ran to completion; tokens are the full decode output
#   timeout    e2e or TTFT deadline expired; tokens are the partial output
#   cancelled  caller cancelled; tokens are the partial output
#   failed     quarantined (explicit fail()); tokens are the partial output
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
