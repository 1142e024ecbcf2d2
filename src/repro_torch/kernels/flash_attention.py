"""K3: flash attention (online softmax, causal + GQA) as hand-written CUDA
C++ kernels for Hopper (``csrc/flash_attention.cu``), in two variants chosen
by dtype alone (:func:`variant`):

- ``mma`` for bf16: FA2-style on the tensor cores (mma.sync, ldmatrix,
  cp.async double buffering; ``csrc/tc_sm80.cuh``);
- ``simt`` for fp32: fp32 FMAs on the CUDA cores (TF32 would change the
  numbers the fp32 checks hold).

Replaces the Pallas TPU kernel ``repro.kernels.flash_attention._fa_kernel``.
Layout as there: q (BH, Sq, D), k/v (BKV, Sk, D), BH % BKV == 0.  Unlike the
TPU kernel, ragged Sq / Sk are masked in the kernel rather than asserted to
divide the tiles.  The source's header note says what bounds it on the card
and how each variant is laid out.

``flash_attention`` computes the plain version (:func:`ref.flash_attention`)
for CPU tensors and launches the kernel for CUDA tensors; a CUDA call the
kernel does not take raises.  ``launches`` counts kernel launches,
``launches_by_variant`` per variant.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build, ref

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

launches = 0
launches_by_variant = {"mma": 0, "simt": 0}


def variant(dtype) -> str:
    """The kernel a CUDA call of ``dtype`` launches: ``mma`` (bf16, tensor
    cores) or ``simt`` (fp32, CUDA cores)."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention: no kernel for {dtype}")
    return "mma" if dtype == torch.bfloat16 else "simt"


@functools.cache
def _entry():
    """The C entry point, built and loaded on first use."""
    return _build.function("flash_attention", "repro_flash_attention",
                           _ARGTYPES)


def flash_attention(q, k, v, *, causal: bool = True, scale=None,
                    q_offset: int = 0):
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, scale=scale,
                                   q_offset=q_offset)
    return _launch(q, k, v, causal=causal, scale=scale, q_offset=q_offset)


def _launch(q, k, v, *, causal, scale, q_offset):
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape:
        raise ValueError(f"flash_attention: want q (BH, Sq, D), k/v "
                         f"(BKV, Sk, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, sq, d = q.shape
    bkv, sk, dk = k.shape
    if dk != d or bh % bkv:
        raise ValueError(f"flash_attention: head dims {d}/{dk} differ or "
                         f"{bh} query heads are not a multiple of {bkv}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; the kernel takes float32 or bfloat16, "
                         f"all alike")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    out = torch.empty_like(q)
    if out.numel() == 0 or sk == 0:
        return out.zero_()
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPE_CODES[q.dtype], bh, bkv, sq, sk, d, scale,
                int(causal), int(q_offset), stream)
    _build.check(rc, f"flash_attention ({variant(q.dtype)})")
    launches += 1
    launches_by_variant[variant(q.dtype)] += 1
    return out
