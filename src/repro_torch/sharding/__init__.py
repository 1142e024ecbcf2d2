"""repro_torch.sharding: the process mesh context (``ctx``), the sharding
rules (``rules``, the reference's ``repro.sharding.rules``) and the
collectives of training on the data axes (``collectives``)."""
from . import ctx, rules  # noqa: F401

__all__ = ["ctx", "rules"]
