"""K2: matrix product ``C = A @ B`` as hand-written CUDA C++ kernels for
Hopper, in four regimes chosen by :func:`plan` from dtype and shape alone:

- ``wgmma`` (``csrc/matmul_wgmma.cu``): bf16 inputs whose rows TMA can
  describe (K % 8 == 0 and N % 8 == 0), on the tensor cores -- a
  warp-specialised wgmma + TMA ring, split K below one wave of tiles (then a
  second kernel, ``splitk_reduce``, sums the partials in a fixed order);
- ``skinny`` (``csrc/matmul.cu``): fp32 with M <= 16, bound by B's bytes:
  128-column panels of B streamed by 16-byte loads on the CUDA cores, K
  split until the panels fill a wave, the parts' fp32 partials summed in a
  fixed order by a second kernel (``skinny_reduce``);
- ``tf32x3`` (``csrc/matmul.cu``): fp32 with M > 16, bound by operations:
  128 x 128 or (M <= 64) 64 x 64 tiles on the tensor cores in 3xTF32 (each operand split into two tf32 halves, three products),
  fp32-level error where plain TF32 would break the fp32 checks;
- ``mma`` (``csrc/matmul.cu``): bf16 whose rows TMA cannot describe, such
  as (37, 100, 75): 64 x 64 ``mma.sync`` tiles on masked 2-byte loads.

Replaces the Pallas TPU kernel ``repro.kernels.matmul.matmul``
(``_matmul_kernel``): A (M, K) and B (K, N), both float32 or both bfloat16;
products accumulated in fp32; the result cast to ``out_dtype`` (default
``a.dtype``, float32 or bfloat16).  Unlike the TPU kernel, ragged M / N / K
are handled in the kernels rather than asserted to divide the tiles.  The
sources' header notes say what bounds each regime on the card, what its
design does about it, and (``matmul.cu``) why 3xTF32 keeps fp32's error.

``matmul`` computes the plain version (:func:`ref.matmul`) for CPU tensors
and launches the planned kernel for CUDA tensors; a CUDA call a kernel does
not take, or a failed build or launch, raises -- no regime stands in for
another.  ``launches`` counts kernel launches in total (a split call
launches two), ``launches_by_variant`` per kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.analysis import hlo_counter
from . import _build, ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
             + [ctypes.c_void_p])
_WGMMA_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
# csrc/matmul.cu's regime codes
_VARIANT_CODES = {"skinny": 0, "tf32x3": 1, "mma": 2}
# the kernel that sums a split's partials, per regime that splits
_REDUCE = {"wgmma": "splitk_reduce", "skinny": "skinny_reduce"}

SMS = 132                  # streaming multiprocessors of an H100 SXM
BLOCK_M, BLOCK_K = 128, 64
MIN_K_TILES_PER_SPLIT = 4  # a split part keeps the ring at least this deep
# time of a 128 x 256 tile over a 128 x 128 one: twice the work at better
# operand reuse.  chip_smoke's tile-width check (phase 6) measured the
# ratio of per-wave times at 1.41-1.60 on an H100 at (800, 2560) x (2560,
# 4096 | 9728); PERF.md has the run.
WIDE_TILE_COST = 1.5

SKINNY_MAX_M = 16          # fp32 rows the skinny regime takes
SKINNY_PANEL = 128         # B columns a skinny block
SKINNY_MIN_ROWS = 64       # K rows a split part keeps at least (8 a warp)
TF32_SMALL_M = 64          # fp32 rows that take 64 x 64 tf32x3 tiles
MMA_TILE = 64              # the bf16 mma regime's square tile

launches = 0
launches_by_variant = {"wgmma": 0, "splitk_reduce": 0, "skinny": 0,
                       "skinny_reduce": 0, "tf32x3": 0, "mma": 0}


class Plan(NamedTuple):
    variant: str                    # "wgmma", "skinny", "tf32x3" or "mma"
    grid: Tuple[int, int, int]      # (n tiles or panels, m tiles or split
                                    # parts, split)
    split: int                      # parts of K (wgmma, skinny)
    workspace_bytes: int            # fp32 (split, M, N) partials, or 0
    block_n: int                    # tile (panel) width
    block_m: int = BLOCK_M          # tile rows (skinny: the most rows)

    @property
    def launches(self) -> int:
        return 2 if self.split > 1 else 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(m: int, n: int, k: int, dtype) -> Plan:
    """The kernel, grid, split and workspace for ``(m, k) @ (k, n)`` with
    inputs of ``dtype``, as pure arithmetic on the shape.

    The rule:

    - ``wgmma`` iff the inputs are bf16, K >= 1, and K % 8 == N % 8 == 0
      (TMA needs 16-byte row strides); other bf16 shapes ``mma`` on 64 x
      64 tiles; fp32 ``skinny`` if M <= 16, else ``tf32x3``;
    - wgmma tiles are 128 rows by ``block_n`` columns.  When the 128-wide
      grid is below one wave (fewer tiles than the 132 SMs), K is split
      into ``split = max(1, min(132 // tiles, k_tiles // 4))`` parts (at
      least 4 k-tiles of 64 each), with fp32 partials in a
      ``split * M * N * 4``-byte workspace; ``block_n`` stays 128;
      otherwise ``split = 1`` and ``block_n`` is 256 when the wide grid's
      waves, weighted by ``WIDE_TILE_COST``, undercut the narrow grid's
      (``ceil(t256 / 132) * WIDE_TILE_COST < ceil(t128 / 132)``), else 128;
    - skinny blocks take 128-column panels of B; ``split`` starts at 1 and
      doubles while the blocks fall short of one wave (``panels * split <
      132``) and twice as many parts would each keep at least 64 rows of
      K; with ``split > 1`` the fp32 partials take ``split * M * N * 4``
      bytes;
    - tf32x3 tiles are 64 x 64 when M <= 64, else 128 x 128.

    The grid is ``(ceil(N / block_n), ceil(M / block_m), split)`` (wgmma:
    tiles times split blocks; skinny: ``(panels, split, 1)``).
    """
    if dtype == torch.float32:
        if m <= SKINNY_MAX_M:
            panels = _cdiv(n, SKINNY_PANEL)
            split = 1
            while panels * split < SMS and \
                    k // (2 * split) >= SKINNY_MIN_ROWS:
                split *= 2
            ws = split * m * n * 4 if split > 1 else 0
            return Plan("skinny", (panels, split, 1), split, ws,
                        SKINNY_PANEL, SKINNY_MAX_M)
        if m <= TF32_SMALL_M:
            return Plan("tf32x3", (_cdiv(n, 64), 1, 1), 1, 0, 64, 64)
        return Plan("tf32x3", (_cdiv(n, 128), _cdiv(m, 128), 1), 1, 0, 128,
                    128)
    if not (dtype == torch.bfloat16 and k >= 1 and k % 8 == 0
            and n % 8 == 0):
        return Plan("mma", (_cdiv(n, MMA_TILE), _cdiv(m, MMA_TILE), 1), 1, 0,
                    MMA_TILE, MMA_TILE)
    m_tiles, k_tiles = _cdiv(m, BLOCK_M), _cdiv(k, BLOCK_K)
    narrow = m_tiles * _cdiv(n, 128)
    if narrow < SMS:
        bn = 128
        split = max(1, min(SMS // max(narrow, 1),
                           k_tiles // MIN_K_TILES_PER_SPLIT))
    else:
        wide = m_tiles * _cdiv(n, 256)
        bn = 256 if _cdiv(wide, SMS) * WIDE_TILE_COST < _cdiv(narrow, SMS) \
            else 128
        split = 1
    ws = split * m * n * 4 if split > 1 else 0
    return Plan("wgmma", (_cdiv(n, bn), m_tiles, split), split, ws, bn)


@functools.cache
def _entry():
    """``csrc/matmul.cu``'s C entry point (skinny, tf32x3, mma), built and
    loaded on first use."""
    return _build.function("matmul", "repro_matmul", _ARGTYPES)


@functools.cache
def _wgmma_entry():
    """The wgmma kernel's C entry point, built and loaded on first use."""
    return _build.function("matmul_wgmma", "repro_matmul_wgmma",
                           _WGMMA_ARGTYPES)


def matmul(a, b, *, out_dtype=None):
    """``a @ b`` accumulated in fp32, cast to ``out_dtype``.  A running op
    count is told its work (``chip_smoke``'s bound: 2 M N K FLOPs, a and
    b read and the product written once)."""
    out_dtype = out_dtype or a.dtype
    m, n = a.shape[0], b.shape[-1]
    with hlo_counter.kernel(
            "matmul", flops=2 * m * n * a.shape[-1],
            nbytes=(a.numel() + b.numel()) * a.element_size()
            + m * n * out_dtype.itemsize):
        if hlo_counter.plain(a):
            return ref.matmul(a, b, out_dtype=out_dtype)
        return _launch(a, b, out_dtype)


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
                         f"{out_dtype}; the kernels take float32 or "
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
    p = plan(m, n, k, a.dtype)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        work = (torch.empty(p.workspace_bytes // 4, dtype=torch.float32,
                            device=a.device) if p.split > 1 else None)
        work_ptr = None if work is None else work.data_ptr()
        if p.variant == "wgmma":
            if a.data_ptr() % 16 or b.data_ptr() % 16:
                raise ValueError("matmul: the wgmma kernel reads a and b by "
                                 "TMA, which needs 16-byte aligned data")
            rc = _wgmma_entry()(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), work_ptr, m, n,
                k, _DTYPE_CODES[out_dtype], p.block_n, p.split, stream)
        else:
            rc = _entry()(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                          work_ptr, m, n, k, _DTYPE_CODES[a.dtype],
                          _DTYPE_CODES[out_dtype], _VARIANT_CODES[p.variant],
                          p.block_m, p.block_n, p.split, stream)
    _build.check(rc, f"matmul ({p.variant})")
    hlo_counter.launched("matmul")
    launches += p.launches
    launches_by_variant[p.variant] += 1
    if p.split > 1:
        launches_by_variant[_REDUCE[p.variant]] += 1
    return out
