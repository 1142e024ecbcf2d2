"""Architecture configs (``--arch <id>``), copied from ``repro.configs``.

Each module defines ``config()`` (full size) and ``smoke_config()``
(reduced, same family, for CPU tests).  Only the architectures whose family
the port runs are here; the rest arrive with their slices (ROADMAP.md).
"""
import dataclasses
from importlib import import_module

ARCH_IDS = ["qwen3_4b", "yi_9b"]

# public names with dashes/dots as given in the assignment
ALIASES = {"qwen3-4b": "qwen3_4b", "yi-9b": "yi_9b"}


def get(arch: str):
    mod_name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCH_IDS:
        raise ValueError(f"arch {arch!r} is not ported yet (ported: "
                         f"{ARCH_IDS}; see ROADMAP.md)")
    return import_module(f"repro_torch.configs.{mod_name}")


def config(arch: str, **overrides):
    cfg = get(arch).config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def smoke_config(arch: str, **overrides):
    cfg = get(arch).smoke_config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
