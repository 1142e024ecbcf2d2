"""Plain PyTorch versions of every kernel: the port's copy of the oracles in
``repro.kernels.ref``, with the same rounding order.

These are what a kernel wrapper computes for a CPU tensor, and what the
card's kernels are held against on the card."""
from __future__ import annotations

import math

import torch

# ---- paper section 7 benchmark ops (BLAS level 1/2) ------------------------


def scal(alpha, x):
    """BLAS scal: alpha * x."""
    return alpha * x


def asum(x):
    """BLAS asum: sum of absolute values."""
    return x.abs().sum()


def dot(x, y):
    """BLAS dot: sum(x * y)."""
    return (x * y).sum()


def gemv(a, x):
    """BLAS gemv: A @ x."""
    return a @ x


# ---- transformer kernels ----------------------------------------------------

def _acc(t):
    """``t`` in the accumulation type: fp32, or fp64 for fp64 inputs (which
    only ``torch.autograd.gradcheck`` passes)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def matmul(a, b, *, out_dtype=None):
    """A @ B accumulated in fp32, then cast to ``out_dtype``."""
    out_dtype = out_dtype or a.dtype
    return (a.float() @ b.float()).to(out_dtype)


def rmsnorm(x, w, eps: float = 1e-6):
    """fp32 statistics (fp64 for fp64 inputs); the normalised row is cast to ``x.dtype`` *before*
    the ``* w`` (the reference's rounding order)."""
    x32 = _acc(x)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def rmsnorm_bwd(x, w, dy, eps: float = 1e-6):
    """The gradients ``(dx, dw)`` of :func:`rmsnorm` for the output gradient
    ``dy``, in fp32, each rounded once to its input's dtype.

    With ``r = rsqrt(mean(x^2) + eps)`` and ``dn = dy * w``:
    ``dx = r * dn - x * r^3 * mean(dn * x)``; ``dw`` sums ``dy * n`` over
    the rows, where ``n`` is the normalised row rounded to ``x.dtype`` (the
    forward's rounding order: ``n`` is what multiplies ``w``)."""
    d = x.shape[-1]
    x32 = _acc(x)
    r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    n = _acc((x32 * r).to(x.dtype))
    dy32 = _acc(dy)
    dn = dy32 * _acc(w)
    dx = r * dn - x32 * (r * r * r) * (dn * x32).mean(dim=-1, keepdim=True)
    dw = (dy32 * n).reshape(-1, d).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


def softmax(x, dim: int = -1):
    return torch.softmax(x.float(), dim=dim).to(x.dtype)


def _scores(q, k, causal, scale, q_offset):
    """The scaled fp32 scores of every query head against its kv head
    (GQA: query head ``i`` reads kv head ``i // (bh // bkv)``), the causal
    mask applied as -inf; returns (scores, group, scale)."""
    bh, sq, d = q.shape
    bkv, sk, _ = k.shape
    if bh % bkv:
        raise ValueError(f"query heads {bh} not a multiple of kv heads {bkv}")
    group = bh // bkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kq = k.repeat_interleave(group, dim=0)
    s = torch.einsum("bqd,bkd->bqk", _acc(q), _acc(kq)) * scale
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
    return s, group, scale


def flash_attention(q, k, v, *, causal: bool = True, scale=None,
                    q_offset: int = 0, return_lse: bool = False):
    """Multi-head attention with GQA.

    q: (bh, sq, d); k, v: (bkv, sk, d) with bh % bkv == 0 (GQA groups: query
    head ``i`` reads kv head ``i // (bh // bkv)``).  ``q_offset`` places the
    queries in the kv sequence: query i attends to keys <= q_offset + i.
    ``return_lse`` also returns each row's fp32 log-sum-exp of the scaled
    scores, (bh, sq): what the backward needs to rebuild the probabilities.
    """
    s, group, _ = _scores(q, k, causal, scale, q_offset)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", p,
                       _acc(v.repeat_interleave(group, dim=0))).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        scale=None):
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention`
    (``q_offset`` 0) for the output gradient ``do``, in fp32, each rounded
    once to its input's dtype.

    The probabilities are rebuilt from the forward's row log-sum-exp
    ``lse``: ``P = exp(S - lse)``.  With ``D = rowsum(dO * O)``:
    ``dV = P^T dO``, ``dS = P * (dO V^T - D)``, ``dQ = scale * dS K``,
    ``dK = scale * dS^T Q``; a kv head's dK and dV sum over the query heads
    of its group."""
    s, group, scale = _scores(q, k, causal, scale, 0)
    bkv = k.shape[0]
    p = torch.exp(s - _acc(lse)[..., None])
    do32 = _acc(do)
    vq = _acc(v.repeat_interleave(group, dim=0))
    kq = _acc(k.repeat_interleave(group, dim=0))
    dv = torch.einsum("bqk,bqd->bkd", p, do32)
    dp = torch.einsum("bqd,bkd->bqk", do32, vq)
    delta = (do32 * _acc(o)).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bqk,bkd->bqd", ds, kq) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, _acc(q)) * scale
    fold = lambda t: t.reshape(bkv, group, *t.shape[1:]).sum(dim=1)  # noqa: E731
    return dq.to(q.dtype), fold(dk).to(k.dtype), fold(dv).to(v.dtype)
