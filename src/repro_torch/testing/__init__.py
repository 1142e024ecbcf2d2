"""repro_torch.testing: deterministic test and bench support that ships
with the library (fault injection lives here so benches, CI and operators
can replay exact failure schedules against production code paths)."""
from __future__ import annotations

from . import faults  # noqa: F401

__all__ = ["faults"]
