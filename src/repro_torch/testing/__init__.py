"""repro_torch.testing: deterministic test and bench support that ships
with the library (fault injection lives here so benches, CI and operators
can replay exact failure schedules against production code paths), and
``ranks``, which runs a function on the ranks of a spawned
``torch.distributed`` process group (the mesh tests and the card's smoke
script use it)."""
from __future__ import annotations

from . import faults, ranks  # noqa: F401

__all__ = ["faults", "ranks"]
