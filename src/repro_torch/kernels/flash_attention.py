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

Both variants can also write each row's fp32 log-sum-exp (``lse``), which
the backward ``repro_flash_attention_bwd`` (same source; causal or not,
GQA, ``q_offset`` 0) reads to rebuild the probabilities tile by tile
without materialising S x S.  Its variant is chosen by dtype alone
(:func:`bwd_variant`): FA2's backward on the tensor cores, dK / dV and dQ
in separate kernels, no atomics -- ``mma`` for bf16 (mma.m16n8k16),
``tf32x3`` for fp32 (mma.m16n8k8 in 3xTF32: each fp32 operand split into
two tf32 halves, three products, fp32-level error).
:class:`_FlashAttentionFn` ties the two together for autograd.

``flash_attention`` computes the plain version (:func:`ref.flash_attention`,
backward :func:`ref.flash_attention_bwd`) for CPU tensors and launches the
kernels for CUDA tensors; a CUDA call a kernel does not take raises.  It
goes through :class:`_FlashAttentionFn` only when autograd will need a
gradient; otherwise it launches the forward alone, with no ``lse``, as
serving does.  ``launches`` counts forward launches, ``launches_by_variant``
per variant, ``backward.launches`` calls of the backward (three kernels
each) and ``backward.launches_by_variant`` those per variant.
"""
from __future__ import annotations

import ctypes
import functools
import math
import types

import torch

from . import _build, ref

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

launches = 0
launches_by_variant = {"mma": 0, "simt": 0}
backward = types.SimpleNamespace(launches=0,
                                 launches_by_variant={"mma": 0, "tf32x3": 0})


def variant(dtype) -> str:
    """The kernel a CUDA call of ``dtype`` launches: ``mma`` (bf16, tensor
    cores) or ``simt`` (fp32, CUDA cores)."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention: no kernel for {dtype}")
    return "mma" if dtype == torch.bfloat16 else "simt"


def bwd_variant(dtype) -> str:
    """The backward kernels a CUDA call of ``dtype`` launches: ``mma``
    (bf16) or ``tf32x3`` (fp32, 3xTF32), both on the tensor cores."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention_bwd: no kernel for {dtype}")
    return "mma" if dtype == torch.bfloat16 else "tf32x3"


@functools.cache
def _entry():
    """The C entry point, built and loaded on first use."""
    return _build.function("flash_attention", "repro_flash_attention",
                           _ARGTYPES)


@functools.cache
def _bwd_entry():
    return _build.function("flash_attention", "repro_flash_attention_bwd",
                           _BWD_ARGTYPES)


def flash_attention(q, k, v, *, causal: bool = True, scale=None,
                    q_offset: int = 0):
    """Attention (see :func:`ref.flash_attention`); differentiable at
    ``q_offset`` 0."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if q_offset:
            raise ValueError(f"flash_attention: the backward takes q_offset "
                             f"0, not {q_offset}")
        return _FlashAttentionFn.apply(q, k, v, causal, scale)
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, scale=scale,
                                   q_offset=q_offset)
    return _launch(q, k, v, causal=causal, scale=scale, q_offset=q_offset)


class _FlashAttentionFn(torch.autograd.Function):
    """K3 and its backward kernel for autograd (the plain versions on the
    CPU).  Saves q, k, v, the output and the row log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        if q.device.type == "cpu":
            o, lse = ref.flash_attention(q, k, v, causal=causal, scale=scale,
                                         return_lse=True)
        else:
            o, lse = _launch(q, k, v, causal=causal, scale=scale, q_offset=0,
                             with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = ref.flash_attention_bwd(q, k, v, o, lse, do,
                                            causal=ctx.causal,
                                            scale=ctx.scale)
        else:
            grads = _launch_bwd(q, k, v, o, lse, do.contiguous(),
                                causal=ctx.causal, scale=ctx.scale)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)),
                None, None)


def _check(q, k, v):
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


def _launch(q, k, v, *, causal, scale, q_offset, with_lse=False):
    """K3's output, and with ``with_lse`` its fp32 row log-sum-exp (bh,
    sq) too."""
    global launches
    _check(q, k, v)
    bh, sq, d = q.shape
    bkv, sk, _ = k.shape
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    out = torch.empty_like(q)
    lse = (torch.empty((bh, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0 or sk == 0:
        out.zero_()
        return (out, lse.fill_(float("-inf"))) if with_lse else out
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      lse.data_ptr() if with_lse else None,
                      _DTYPE_CODES[q.dtype], bh, bkv, sq, sk, d, scale,
                      int(causal), int(q_offset), stream)
    _build.check(rc, f"flash_attention ({variant(q.dtype)})")
    launches += 1
    launches_by_variant[variant(q.dtype)] += 1
    return (out, lse) if with_lse else out


def _launch_bwd(q, k, v, o, lse, do, *, causal, scale):
    """``(dq, dk, dv)`` from ``repro_flash_attention_bwd`` for CUDA
    tensors: the forward's inputs, its output ``o`` and row log-sum-exp
    ``lse``, and the output gradient ``do`` (``o``'s shape and dtype)."""
    _check(q, k, v)
    bh, sq, d = q.shape
    bkv, sk, _ = k.shape
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or \
                not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} "
                             f"{tuple(t.shape)} {t.dtype} must be a "
                             f"contiguous tensor like q {tuple(q.shape)} "
                             f"{q.dtype} on {q.device}")
    if lse.shape != (bh, sq) or lse.dtype != torch.float32 or \
            not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype} must be contiguous float32 "
                         f"({bh}, {sq}) on {q.device}")
    # the kernels stage rows by 16-byte copies: an operand that is not
    # 16-byte aligned (a contiguous view at an odd offset) is copied to a
    # fresh buffer on the card first
    q, k, v, o, do = (t.clone() if t.data_ptr() % 16 else t
                      for t in (q, k, v, o, do))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _bwd_entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), lse.data_ptr(), do.data_ptr(),
                          dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                          delta.data_ptr(), _DTYPE_CODES[q.dtype], bh, bkv,
                          sq, sk, d, scale, int(causal), stream)
    _build.check(rc, f"flash_attention_bwd ({bwd_variant(q.dtype)})")
    backward.launches += 1
    backward.launches_by_variant[bwd_variant(q.dtype)] += 1
    return dq, dk, dv
