"""repro_torch.sharding: the process mesh context (``ctx``).

The reference's sharding rules (``repro.sharding.rules``) come with
sharded serving and training (ROADMAP.md queue 1 item 7b)."""
from . import ctx  # noqa: F401

__all__ = ["ctx"]
