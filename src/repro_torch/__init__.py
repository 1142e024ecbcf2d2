"""PyTorch / CUDA port of :mod:`repro` for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package mirrors its module
layout (``kernels``, ``models``, ``configs``, ``serve``, ``launch``,
``core.dpia``, ``compiler``, ``obs``, ``ft``, ``testing``) and is held
against it by the ``tests/test_torch_*.py`` parity tests.  It imports
neither JAX nor anything of ``repro``.

Every Pallas kernel on a ported path becomes a hand-written Hopper kernel
(``kernels/``).  Entry points run on the CUDA device unless the caller
passes ``device="cpu"`` (:func:`repro_torch.device.resolve_device`); on the
CPU every kernel wrapper takes its plain PyTorch version.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
