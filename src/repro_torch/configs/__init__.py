"""Architecture configs (``--arch <id>``), copied from ``repro.configs``.

Each module defines ``config()`` (full size) and ``smoke_config()``
(reduced, same family, for CPU tests).  Only the architectures whose family
the port runs are here: every transformer family (dense, moe, vlm, audio);
the recurrent ones (``rwkv6_1_6b``, ``zamba2_2_7b``) arrive with their
slice (ROADMAP.md queue 1 item 8).
"""
import dataclasses
from importlib import import_module

ARCH_IDS = [
    "stablelm_1_6b", "qwen1_5_32b", "yi_9b", "qwen3_4b", "dbrx_132b",
    "grok_1_314b", "chameleon_34b", "musicgen_large",
]

# public names with dashes/dots as given in the assignment
ALIASES = {
    "stablelm-1.6b": "stablelm_1_6b",
    "qwen1.5-32b": "qwen1_5_32b",
    "yi-9b": "yi_9b",
    "qwen3-4b": "qwen3_4b",
    "dbrx-132b": "dbrx_132b",
    "grok-1-314b": "grok_1_314b",
    "chameleon-34b": "chameleon_34b",
    "musicgen-large": "musicgen_large",
}

# the reference's architectures whose family is not ported yet
NOT_PORTED = ["rwkv6_1_6b", "zamba2_2_7b"]


def get(arch: str):
    mod_name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCH_IDS:
        raise ValueError(f"arch {arch!r} is not ported yet (not ported: "
                         f"{NOT_PORTED}; see ROADMAP.md queue 1 item 8)")
    return import_module(f"repro_torch.configs.{mod_name}")


def config(arch: str, **overrides):
    cfg = get(arch).config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def smoke_config(arch: str, **overrides):
    cfg = get(arch).smoke_config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
