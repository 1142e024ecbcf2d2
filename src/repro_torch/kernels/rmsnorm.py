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

The backward (``repro_rmsnorm_bwd`` in the same source, laid out by
:func:`bwd_plan`) recomputes the row's fp32 ``rstd`` and gives ``dx`` and
``dw`` from one read of ``x`` and ``dy``, rows held in registers as 16-byte
accesses where the row allows; ``dw`` is a fixed-order column sum (each
block's fp32 partials, kept in registers while it walks its rows, then one
reduction kernel), so a gradient is the same bits every time.
:class:`_RMSNormFn` ties the two together for autograd.

``rmsnorm`` computes the plain version (:func:`ref.rmsnorm`, backward
:func:`ref.rmsnorm_bwd`) for CPU tensors (and ``meta`` ones inside an
op count: shapes only) and launches the kernels for CUDA tensors; a CUDA call a kernel does not
take, or a failed build or launch, raises.  Each call declares its work
to a running op count (``analysis.hlo_counter.kernel``: ``chip_smoke``'s
bound formulas, forward 4 FLOPs and backward 10 an element, each input
read and each output written once), the same on every device.  It goes through :class:`_RMSNormFn` only when autograd will need
a gradient (grad mode on and an input that requires one); otherwise it
calls the forward alone, as serving and CUDA graph captures do.
``launches`` counts forward launches, ``launches_by_variant`` per variant,
``backward.launches`` calls of the backward (two kernels each).  The
library is built and loaded on the first launch, so this module imports
without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import types
from typing import NamedTuple

import torch

from repro_torch.analysis import hlo_counter
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

_BWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                 + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
BWD_THREADS = 256         # threads of a backward block
BWD_VPT = (1, 2, 4, 10)   # accesses a thread, rows of up to 32 threads
BWD_WIDE_VPT = 10         # accesses a thread, rows of 64-256 threads
BWD_MAX_D = 10240         # a row of 256 threads x 40 elements (one an access)

launches = 0
launches_by_variant = {"packed": 0, "warp": 0, "block": 0}
backward = types.SimpleNamespace(launches=0)


class BwdPlan(NamedTuple):
    vector: bool               # 16-byte accesses, else one element each
    threads_per_row: int       # 1-32 lanes of a warp, or 64-256 threads
    vectors_per_thread: int    # accesses a thread holds
    blocks: int                # blocks of BWD_THREADS; partial rows of dw


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


def bwd_plan(rows: int, d: int, dtype, aligned: bool = True) -> BwdPlan:
    """The layout and grid of a backward launch over ``rows`` rows of ``d``
    elements of ``dtype``, as pure arithmetic.

    The rule:

    - accesses as the forward's (16 bytes when ``d * itemsize`` is a
      multiple of 16 and ``aligned``, else one element); ``n`` a row;
    - ``n <= 32``: ``next_pow2(n)`` lanes a row, one access a lane (a
      128-wide bf16 qk_norm row is 16 lanes, two rows a warp);
    - else the fewest of 32, 64, 128 or 256 threads a row that hold it at
      10 accesses a thread, and the fewest of ``BWD_VPT`` (32 threads) or
      10 accesses that hold it (d_model 2560 bf16: 32 x 10); a row of one
      element an access longer than 2560 takes 256 x 40;
    - blocks: as many as fit an SM at once (by a count of the registers
      that hold x, dy and dw, a thread), times 132, or fewer where the rows
      run out, then as few as hold the same rows a block; each block walks
      its rows and writes one fp32 partial row of dw.
    """
    if dtype not in _DTYPES:
        raise ValueError(f"rmsnorm_bwd: no kernel for {dtype}")
    if not 0 < d <= BWD_MAX_D:
        raise ValueError(f"rmsnorm_bwd: rows of {d} elements; the kernel "
                         f"takes 1 to {BWD_MAX_D}")
    itemsize = 4 if dtype == torch.float32 else 2
    vector = aligned and (d * itemsize) % 16 == 0
    per = 16 // itemsize if vector else 1
    n = d // per
    if n <= 32:
        tpr, vpt = 1 << (n - 1).bit_length(), 1
    elif n > 256 * BWD_WIDE_VPT:
        tpr, vpt = 256, 40
    else:
        tpr = next(t for t in (32, 64, 128, 256) if n <= t * BWD_WIDE_VPT)
        vpt = (next(v for v in BWD_VPT if 32 * v >= n) if tpr == 32
               else BWD_WIDE_VPT)
    # registers a thread: x and dy as loaded (itemsize / 2 words an
    # element for the two), dw in fp32 (one), and ~32 more
    regs = vpt * per * (itemsize // 2 + 1) + 32
    per_sm = max(1, min(8, 65536 // (BWD_THREADS * regs)))
    blocks = max(1, min(_cdiv(rows, BWD_THREADS // tpr), per_sm * SMS))
    # the same rows a block (the kernel's rows_per_block), none idle
    return BwdPlan(vector, tpr, vpt, _cdiv(rows, _cdiv(rows, blocks)))


def rmsnorm(x, w, eps: float = 1e-6):
    """RMSNorm over the last axis of ``x`` (any leading dims) scaled by
    ``w`` of shape ``(d,)``; differentiable."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RMSNormFn.apply(x, w, eps)
    return _forward(x, w, eps)


def _forward(x, w, eps):
    n, d = x.numel(), x.shape[-1]
    with hlo_counter.kernel("rmsnorm", flops=4 * n,
                            nbytes=(2 * n + d) * x.element_size()):
        if hlo_counter.plain(x):
            return ref.rmsnorm(x, w, eps=eps)
        return _launch(x, w, eps)


def _backward(x, w, dy, eps):
    n, d = x.numel(), x.shape[-1]
    with hlo_counter.kernel("rmsnorm_bwd", flops=10 * n,
                            nbytes=(3 * n + 2 * d) * x.element_size()):
        if hlo_counter.plain(x):
            return ref.rmsnorm_bwd(x, w, dy, eps=eps)
        return _launch_bwd(x, w, dy, eps)


class _RMSNormFn(torch.autograd.Function):
    """K1 and its backward kernel for autograd (the plain versions on the
    CPU).  Saves ``x`` and ``w``; the backward recomputes ``rstd``."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _forward(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = _backward(x, w, dy.contiguous(), ctx.eps)
        need_x, need_w, _ = ctx.needs_input_grad
        return dx if need_x else None, dw if need_w else None, None


def _check(x, w, what="rmsnorm"):
    if not x.is_cuda:
        raise ValueError(f"{what}: no kernel for device {x.device}")
    d = x.shape[-1]
    if w.shape != (d,) or w.get_device() != x.get_device():
        raise ValueError(f"{what}: weight {tuple(w.shape)} on {w.device} "
                         f"does not match x {tuple(x.shape)} on {x.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(f"{what}: dtypes {x.dtype}/{w.dtype}; the kernel "
                         f"takes one of {_DTYPES} for both")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{what}: x and w must be contiguous")


def _launch(x, w, eps):
    global launches
    _check(x, w)
    d = x.shape[-1]
    dev = x.get_device()
    dtype = x.dtype
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
    hlo_counter.launched("rmsnorm")
    launches += 1
    launches_by_variant[p.variant] += 1
    return out


_bwd_fn = None             # the backward's C entry point, on first launch


def _launch_bwd(x, w, dy, eps):
    """``(dx, dw)`` from ``repro_rmsnorm_bwd`` for CUDA tensors ``x``,
    ``w`` and the output gradient ``dy`` (x's shape and dtype)."""
    global _bwd_fn
    _check(x, w, "rmsnorm_bwd")
    d = x.shape[-1]
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous() \
            or dy.device != x.device:
        raise ValueError(f"rmsnorm_bwd: dy {tuple(dy.shape)} {dy.dtype} on "
                         f"{dy.device} must be a contiguous tensor like x "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if d > BWD_MAX_D:
        raise ValueError(f"rmsnorm_bwd: rows of {d} > {BWD_MAX_D} elements")
    dx = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return dx, torch.zeros_like(w)
    ptrs = x.data_ptr() | w.data_ptr() | dy.data_ptr() | dx.data_ptr()
    p = bwd_plan(rows, d, x.dtype, aligned=not ptrs & 15)
    dw = torch.empty_like(w)
    partial = torch.empty((p.blocks, d), dtype=torch.float32,
                          device=x.device)
    if _bwd_fn is None:
        _bwd_fn = _build.function("rmsnorm", "repro_rmsnorm_bwd",
                                  _BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        rc = _bwd_fn(x.data_ptr(), w.data_ptr(), dy.data_ptr(),
                     dx.data_ptr(), dw.data_ptr(), partial.data_ptr(), rows,
                     d, eps, int(x.dtype == torch.bfloat16), p.vector,
                     p.threads_per_row, p.vectors_per_thread, p.blocks,
                     torch._C._cuda_getCurrentRawStream(x.get_device()))
    _build.check(rc, "rmsnorm_bwd")
    hlo_counter.launched("rmsnorm_bwd")
    backward.launches += 1
    return dx, dw
