"""K2: tiled matrix product ``C = A @ B`` as a hand-written CUDA C++ kernel for
Hopper (``csrc/matmul.cu``).

Replaces the Pallas TPU kernel ``repro.kernels.matmul.matmul``
(``_matmul_kernel``): A (M, K) and B (K, N), both float32 or both bfloat16;
products accumulated in fp32; the result cast to ``out_dtype`` (default
``a.dtype``, float32 or bfloat16).  Unlike the TPU kernel, ragged M / N / K
are masked in the kernel rather than asserted to divide the tiles.  Bound by
operations at the port's projection shapes; the source's header note says
how it is laid out.

``matmul`` computes the plain version (:func:`ref.matmul`) for CPU tensors
and launches the kernel for CUDA tensors; a CUDA call the kernel does not
take raises.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

launches = 0


@functools.cache
def _entry():
    """The C entry point, built and loaded on first use."""
    return _build.function("matmul", "repro_matmul", _ARGTYPES)


def matmul(a, b, *, out_dtype=None):
    """``a @ b`` accumulated in fp32, cast to ``out_dtype``."""
    if a.device.type == "cpu":
        return ref.matmul(a, b, out_dtype=out_dtype)
    return _launch(a, b, out_dtype or a.dtype)


def _launch(a, b, out_dtype):
    global launches
    if a.device.type != "cuda":
        raise ValueError(f"matmul: no kernel for device {a.device}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: want (M, K) x (K, N); got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    if a.dtype not in _DTYPE_CODES or b.dtype != a.dtype \
            or out_dtype not in _DTYPE_CODES:
        raise ValueError(f"matmul: dtypes {a.dtype}/{b.dtype} -> "
                         f"{out_dtype}; the kernel takes float32 or "
                         f"bfloat16 inputs, alike, and either as output")
    if b.device != a.device:
        raise ValueError("matmul: a and b on different devices")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul: a and b must be contiguous")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _entry()(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                      _DTYPE_CODES[a.dtype], _DTYPE_CODES[out_dtype], stream)
    _build.check(rc, "matmul")
    launches += 1
    return out
