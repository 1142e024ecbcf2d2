"""K1: fused RMSNorm as a hand-written CUDA C++ kernel for Hopper
(``csrc/rmsnorm.cu``), in three variants chosen by :func:`plan` from the
row count, the row length and the dtype:

- ``packed``: rows of at most 16 accesses, several rows a warp (a 128-wide
  bf16 qk_norm row is 16 lanes of one 16-byte vector each);
- ``warp``: a row a warp, held in registers (d_model 2560 bf16 is 10
  vectors a lane);
- ``block``: a row a block, warps reduced through shared memory: rows too
  long for a warp, and rows too few to give every SM a warp (a decode
  step's four d_model rows: one vector a thread).

Replaces the Pallas TPU kernel ``repro.kernels.rmsnorm._rmsnorm_kernel``:
``y = (x * rsqrt(mean(x^2) + eps)).astype(x.dtype) * w``, statistics in
fp32, the normalised row rounded to ``x.dtype`` *before* ``* w`` and the
product rounded once more to ``x.dtype`` (the reference's rounding order).
The source's header note says what bounds it on the card and how each
variant is laid out.

``rmsnorm`` computes the plain version (:func:`ref.rmsnorm`) for CPU tensors
and launches the kernel for CUDA tensors; a CUDA call the kernel does not
take, or a failed build or launch, raises.  ``launches`` counts kernel
launches, ``launches_by_variant`` per variant.  The library is built and
loaded on the first launch, so this module imports without ``nvcc``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build, ref

_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float]
             + [ctypes.c_int] * 6 + [ctypes.c_void_p])

SMS = 132                 # streaming multiprocessors of an H100 SXM
MAX_BLOCK = 256           # threads of a packed or warp block
PACKED_MAX = 16           # accesses of a row that a lane group of <= 16 holds
WARP_VPT = (1, 2, 4, 6, 8, 10, 12, 16, 20)   # the warp kernel's instances
BLOCK_VPT = 4             # accesses a thread of the block variant holds
FEW_ROWS_WARPS = 4        # warps a packed or warp block of too few rows
BLOCK_MAX = 1024

launches = 0
launches_by_variant = {"packed": 0, "warp": 0, "block": 0}


class Plan(NamedTuple):
    variant: str               # "packed", "warp" or "block"
    vector: bool               # 16-byte accesses, else one element each
    threads_per_row: int
    vectors_per_thread: int    # accesses a thread holds per pass
    rows_per_block: int
    threads: int               # threads a block
    grid: int                  # blocks


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(rows: int, d: int, dtype, aligned: bool = True) -> Plan:
    """The variant, lane layout, block and grid of a launch over ``rows``
    rows of ``d`` elements of ``dtype``, as pure arithmetic.

    The rule:

    - accesses are 16 bytes (8 bf16, 4 fp32) when ``d * itemsize`` is a
      multiple of 16 and ``aligned`` (every pointer 16-byte aligned), else
      one element; ``n`` accesses a row;
    - ``n <= 16``: ``packed``, ``next_pow2(n)`` lanes a row, one access a
      lane;
    - fewer than 132 rows and ``32 < n <= 1024``: ``block``, one row a
      block of ``ceil(n / 32)`` warps, one access a thread (the shortest
      chain of work a thread when the rows cannot fill the SMs anyway);
    - ``n <= 32 * 20``: ``warp``, the smallest instance of ``WARP_VPT``
      accesses a lane that holds the row; else ``block``, one row a block
      of the fewest warps that hold it at four accesses a thread (256 to
      1024 threads; a longer row takes several passes);
    - a packed or warp block holds the most rows (up to 256 threads) that
      still leaves at least 132 blocks; where even one warp's rows a block
      leave fewer, the rows cannot fill the SMs and a block takes four
      warps' rows (fewer, fuller blocks: ``tools/k1_plans.py`` timed
      (128, 128) bf16 on an H100 at 16 blocks of 4 warps below 64 blocks
      of one).
    """
    if dtype not in _DTYPES:
        raise ValueError(f"rmsnorm: no kernel for {dtype}")
    itemsize = 4 if dtype == torch.float32 else 2
    vector = aligned and (d * itemsize) % 16 == 0
    n = d // (16 // itemsize) if vector else d
    if 32 < n <= BLOCK_MAX and rows < SMS:
        # too few rows to give every SM a warp: a row's accesses spread
        # over a block, one a thread, for the shortest chain a thread
        threads = 32 * _cdiv(n, 32)
        return Plan("block", vector, threads, 1, 1, threads, rows)
    if n > 32 * WARP_VPT[-1]:
        threads = min(BLOCK_MAX, max(256, 32 * _cdiv(n, 32 * BLOCK_VPT)))
        return Plan("block", vector, threads, BLOCK_VPT, 1, threads, rows)
    if n <= PACKED_MAX:
        variant, tpr, vpt = "packed", 1 << (n - 1).bit_length(), 1
    else:
        variant, tpr = "warp", 32
        vpt = next(v for v in WARP_VPT if 32 * v >= n)
    per_warp = 32 // tpr
    rpb = per_warp * FEW_ROWS_WARPS        # rows too few to fill the SMs
    for warps in (MAX_BLOCK // 32, 4, 2, 1):
        if _cdiv(rows, per_warp * warps) >= SMS:
            rpb = per_warp * warps
            break
    return Plan(variant, vector, tpr, vpt, rpb, rpb * tpr, _cdiv(rows, rpb))


_fn = None                 # the C entry point, resolved on the first launch


def _entry():
    global _fn
    if _fn is None:
        _fn = _build.function("rmsnorm", "repro_rmsnorm", _ARGTYPES)
    return _fn


def rmsnorm(x, w, eps: float = 1e-6):
    """RMSNorm over the last axis of ``x`` (any leading dims) scaled by
    ``w`` of shape ``(d,)``."""
    if x.device.type == "cpu":
        return ref.rmsnorm(x, w, eps=eps)
    return _launch(x, w, eps)


def _launch(x, w, eps):
    global launches
    if not x.is_cuda:
        raise ValueError(f"rmsnorm: no kernel for device {x.device}")
    d = x.shape[-1]
    dev = x.get_device()
    if w.shape != (d,) or w.get_device() != dev:
        raise ValueError(f"rmsnorm: weight {tuple(w.shape)} on {w.device} "
                         f"does not match x {tuple(x.shape)} on {x.device}")
    dtype = x.dtype
    if dtype not in _DTYPES or w.dtype != dtype:
        raise ValueError(f"rmsnorm: dtypes {dtype}/{w.dtype}; the kernel "
                         f"takes one of {_DTYPES} for both")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm: x and w must be contiguous")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    xp, wp = x.data_ptr(), w.data_ptr()
    p = plan(rows, d, dtype, aligned=not (xp | wp) & 15)
    # the current stream, read on every call: a CUDA graph capture sets it
    args = (xp, wp, out.data_ptr(), rows, d, eps,
            int(dtype == torch.bfloat16), p.vector, p.threads_per_row,
            p.vectors_per_thread, p.threads, p.grid,
            torch._C._cuda_getCurrentRawStream(dev))
    if dev == torch._C._cuda_getDevice():
        rc = (_fn or _entry())(*args)
    else:
        with torch.cuda.device(dev):
            rc = (_fn or _entry())(*args)
    _build.check(rc, f"rmsnorm ({p.variant})")
    launches += 1
    launches_by_variant[p.variant] += 1
    return out
