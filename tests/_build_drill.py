"""The worker of ``test_torch_mesh``'s concurrent-build drill.

It lives apart from the test module so that each spawned process imports
only ``repro_torch.kernels._build`` (and torch), not the JAX reference.
"""
import time
from pathlib import Path


def build_same_program(i, tmp, fake_nvcc, text, barrier):
    """One process of the drill: every process builds the same generated
    source into the same directory, the i-th 15 ms after the first, so
    writes fall among the other compilers' reads."""
    from repro_torch.kernels import _build
    _build.DPIA_DIR = Path(tmp)
    _build.nvcc = lambda: fake_nvcc
    barrier.wait(timeout=240)
    time.sleep(0.015 * i)
    _build.build_generated([("same", text)])
    return _build.generated_target("same", text).read_text()
