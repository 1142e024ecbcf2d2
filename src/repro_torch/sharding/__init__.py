"""repro_torch.sharding: the process mesh context (``ctx``).

The reference's sharding rules (``repro.sharding.rules``) come with
training on a mesh (ROADMAP.md queue 1 item 7c)."""
from . import ctx  # noqa: F401

__all__ = ["ctx"]
