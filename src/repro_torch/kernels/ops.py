"""The port's kernel API, as the models call it.

``rmsnorm(x, w, eps=1e-6)`` and ``flash_attention(q, k, v, *, causal=True,
scale=None, q_offset=0)`` take the arguments of ``repro.kernels.ops``'s
functions of the same names.  Dispatch follows the tensor, not an impl
name: a CPU tensor goes to the plain PyTorch version, a CUDA tensor
launches the hand-written kernel (K1 Triton RMSNorm, K3 CUDA flash
attention) or raises.  There is no fallback from the card to a plain
version.

The other ops, the impl-name table and the DPIA rows of the reference's
``ops`` arrive with their slices of the port (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict

from . import flash_attention as _fa
from . import rmsnorm as _rms

rmsnorm = _rms.rmsnorm
flash_attention = _fa.flash_attention

_KERNEL_MODULES = {"rmsnorm": _rms, "flash_attention": _fa}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: mod.launches for name, mod in _KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _KERNEL_MODULES.values():
        mod.launches = 0
