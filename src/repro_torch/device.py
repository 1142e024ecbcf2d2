"""Where the port runs.

The port is the GPU target: its entry points run on the CUDA device, and
the CPU is used only when the caller asks for it by name.  There is no
environment switch and no silent move to the CPU when no card is present.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the current CUDA device; ``"cuda"``/``"cuda:N"`` name
    one; ``"cpu"`` runs the plain PyTorch versions of every kernel.  A CUDA
    request on a host without CUDA raises instead of falling back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
