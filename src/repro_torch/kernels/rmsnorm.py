"""K1: fused RMSNorm as a hand-written Triton kernel for Hopper.

Replaces the Pallas TPU kernel ``repro.kernels.rmsnorm._rmsnorm_kernel``:
``y = (x * rsqrt(mean(x^2) + eps)).astype(x.dtype) * w``, statistics in
fp32, the normalised row rounded to ``x.dtype`` *before* ``* w`` and the
product rounded once more to ``x.dtype`` (the reference's rounding order).

Why Triton and not CUDA C++: the kernel is one row reduction plus an
elementwise scale, so it is bound by bytes (each element read once, written
once).  Triton's masked block loads give the same coalesced one-read,
one-write pass a hand CUDA kernel would.  Design: one program per row, the
whole row in one block of ``next_pow2(d)`` lanes (masked), so no row is
read twice and no padding rows are added (the TPU kernel padded rows to its
256-row blocks; a Hopper grid has no such constraint).

``rmsnorm`` computes the plain version (:func:`ref.rmsnorm`) for CPU tensors
and launches the kernel for CUDA tensors; a CUDA call the kernel does not
take raises.  ``launches`` counts kernel launches.  Triton is imported when
the kernel is first launched, so this module imports without it.
"""
from __future__ import annotations

import functools

import torch

from . import _build, ref

_DTYPES = (torch.float32, torch.bfloat16)

launches = 0

tl = None   # triton.language, bound by _kernel() before the first compile


def _rmsnorm_rows(x_ptr, w_ptr, o_ptr, d, eps, BLOCK: tl.constexpr):
    # Triton source: compiled by triton.jit in _kernel(), never called as
    # Python.  One program normalises one row of length d.
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK)
    mask = cols < d
    x = tl.load(x_ptr + row * d + cols, mask=mask, other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=0) / d
    y = (x * tl.rsqrt(var + eps)).to(o_ptr.dtype.element_ty)
    w = tl.load(w_ptr + cols, mask=mask, other=0.0)
    tl.store(o_ptr + row * d + cols, (y * w).to(o_ptr.dtype.element_ty),
             mask=mask)


@functools.cache
def _kernel():
    """``triton.jit`` of :func:`_rmsnorm_rows`, made on first launch."""
    global tl
    triton = _build.import_triton()
    import triton.language
    tl = triton.language
    return triton.jit(_rmsnorm_rows)


def rmsnorm(x, w, eps: float = 1e-6):
    """RMSNorm over the last axis of ``x`` (any leading dims) scaled by
    ``w`` of shape ``(d,)``."""
    if x.device.type == "cpu":
        return ref.rmsnorm(x, w, eps=eps)
    return _launch(x, w, eps)


def _launch(x, w, eps):
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: no kernel for device {x.device}")
    d = x.shape[-1]
    if w.shape != (d,) or w.device != x.device:
        raise ValueError(f"rmsnorm: weight {tuple(w.shape)} on {w.device} "
                         f"does not match x {tuple(x.shape)} on {x.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(f"rmsnorm: dtypes {x.dtype}/{w.dtype}; the kernel "
                         f"takes one of {_DTYPES} for both")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm: x and w must be contiguous")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    block = 1 << (d - 1).bit_length()          # next power of two
    with torch.cuda.device(x.device):
        _kernel()[(rows,)](x, w, out, d, float(eps), BLOCK=block,
                           num_warps=max(1, min(16, block // 256)))
    launches += 1
    return out
