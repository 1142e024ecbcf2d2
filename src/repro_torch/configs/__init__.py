"""Architecture configs (``--arch <id>``), copied from ``repro.configs``.

Each module defines ``config()`` (full size) and ``smoke_config()``
(reduced, same family, for CPU tests): the reference's ten
architectures, every family (dense, moe, vlm, audio, ssm, hybrid).
"""
import dataclasses
from importlib import import_module

ARCH_IDS = [
    "stablelm_1_6b", "qwen1_5_32b", "yi_9b", "qwen3_4b", "zamba2_2_7b",
    "dbrx_132b", "grok_1_314b", "chameleon_34b", "rwkv6_1_6b",
    "musicgen_large",
]

# public names with dashes/dots as given in the assignment
ALIASES = {
    "stablelm-1.6b": "stablelm_1_6b",
    "qwen1.5-32b": "qwen1_5_32b",
    "yi-9b": "yi_9b",
    "qwen3-4b": "qwen3_4b",
    "zamba2-2.7b": "zamba2_2_7b",
    "dbrx-132b": "dbrx_132b",
    "grok-1-314b": "grok_1_314b",
    "chameleon-34b": "chameleon_34b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "musicgen-large": "musicgen_large",
}


def get(arch: str):
    mod_name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    return import_module(f"repro_torch.configs.{mod_name}")


def config(arch: str, **overrides):
    cfg = get(arch).config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def smoke_config(arch: str, **overrides):
    cfg = get(arch).smoke_config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
