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

def matmul(a, b, *, out_dtype=None):
    """A @ B accumulated in fp32, then cast to ``out_dtype``."""
    out_dtype = out_dtype or a.dtype
    return (a.float() @ b.float()).to(out_dtype)


def rmsnorm(x, w, eps: float = 1e-6):
    """fp32 statistics; the normalised row is cast to ``x.dtype`` *before*
    the ``* w`` (the reference's rounding order)."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def softmax(x, dim: int = -1):
    return torch.softmax(x.float(), dim=dim).to(x.dtype)


def flash_attention(q, k, v, *, causal: bool = True, scale=None,
                    q_offset: int = 0):
    """Multi-head attention with GQA.

    q: (bh, sq, d); k, v: (bkv, sk, d) with bh % bkv == 0 (GQA groups: query
    head ``i`` reads kv head ``i // (bh // bkv)``).  ``q_offset`` places the
    queries in the kv sequence: query i attends to keys <= q_offset + i.
    """
    bh, sq, d = q.shape
    bkv, sk, _ = k.shape
    if bh % bkv:
        raise ValueError(f"query heads {bh} not a multiple of kv heads {bkv}")
    group = bh // bkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kq = k.repeat_interleave(group, dim=0)
    vq = v.repeat_interleave(group, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), kq.float()) * scale
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", p, vq.float())
    return out.to(q.dtype)
