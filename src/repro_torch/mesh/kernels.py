"""Mesh-level DPIA strategies for the tuned kernel set.

The port's copy of ``repro.mesh.kernels``: the same terms, so the two
packages' Stage II texts of every per-shard body agree.  Each builder
returns ``(expr, arg_vars)`` like ``repro_torch.kernels.dpia_blas``, but
with the *top* map/reduce bound to a named mesh axis
(:class:`repro_torch.mesh.MeshStrategy` vocabulary):

  dot / asum      reduce-form — ``reduce[mesh(ax)]`` over per-shard partial
                  reductions: the shardmap backend issues exactly one
                  ``all_reduce`` on the axis group, dictated by the term;
  scal / rmsnorm / softmax / matmul
                  map-form — ``map[mesh(ax)]`` over ``split`` shards the
                  leading extent; the small operands (alpha, w, B) stay
                  replicated; outputs come back sharded over the axis.

``block`` / ``row_block`` / ``bk`` optionally give each shard the familiar
single-device grid/sequential blocking *inside* the mesh level — the chunk
factor of the mesh strategy space — compiled by the inner backend exactly as
on one device (``inner="cuda"``: K4, where a GRID level is a CUDA grid and
a body without one is a kernel of one block).  All builders are pure term
constructors: no mesh object is needed, only the shard count, so the
autotuner can enumerate candidates from a cache descriptor alone.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..core.dpia import phrases as P
from ..core.dpia.types import Arr, Num
from ..kernels.dpia_blas import _softmax_row

Expr = P.Phrase

__all__ = ["mesh_dot", "mesh_asum", "mesh_scal", "mesh_rmsnorm",
           "mesh_softmax", "mesh_matmul", "MESH_KERNELS"]


def _chunk_of(extent: int, shards: int, what: str) -> int:
    if shards < 1 or extent % shards != 0:
        raise ValueError(f"{what}: extent {extent} not divisible into "
                         f"{shards} mesh shards")
    return extent // shards


def _reduce_leaf(op_block: str, block: Optional[int], chunk: int):
    """Per-shard body for the reduce-form kernels: one whole-chunk
    FullReduce, or grid-blocked partials combined sequentially."""
    def leaf(elem):
        if op_block == "abs":
            return P.UnOp("abs", elem)
        return P.mul(P.Fst(elem), P.Snd(elem))

    def body(blk):
        if block is None or block >= chunk:
            return P.FullReduce("add", leaf(blk))
        return P.Reduce(
            lambda x, a: P.add(a, x), P.lit(0.0),
            P.Map(lambda b2: P.FullReduce("add", leaf(b2)),
                  P.Split(block, blk), level=P.GRID(0)),
            level=P.SEQ)
    return body


def mesh_dot(n: int, axis: str, shards: int, block: Optional[int] = None
             ) -> Tuple[Expr, List[P.Var]]:
    """Distributed dot: mesh-map partial dots + one mesh reduce."""
    chunk = _chunk_of(n, shards, "mesh_dot")
    xs = P.var_exp("xs", Arr(n, Num()))
    ys = P.var_exp("ys", Arr(n, Num()))
    e = P.Reduce(
        lambda x, a: P.add(a, x), P.lit(0.0),
        P.Map(_reduce_leaf("mul", block, chunk),
              P.Split(chunk, P.Zip(xs, ys)), level=P.MESH(axis)),
        level=P.MESH(axis))
    return e, [xs, ys]


def mesh_asum(n: int, axis: str, shards: int, block: Optional[int] = None
              ) -> Tuple[Expr, List[P.Var]]:
    """Distributed asum: per-shard |x| partial sums + one mesh reduce."""
    chunk = _chunk_of(n, shards, "mesh_asum")
    xs = P.var_exp("xs", Arr(n, Num()))
    e = P.Reduce(
        lambda x, a: P.add(a, x), P.lit(0.0),
        P.Map(_reduce_leaf("abs", block, chunk),
              P.Split(chunk, xs), level=P.MESH(axis)),
        level=P.MESH(axis))
    return e, [xs]


def mesh_scal(n: int, axis: str, shards: int, block: Optional[int] = None
              ) -> Tuple[Expr, List[P.Var]]:
    """Sharded scal: each shard scales its chunk; alpha is replicated."""
    chunk = _chunk_of(n, shards, "mesh_scal")
    alpha = P.var_exp("alpha", Num())
    xs = P.var_exp("xs", Arr(n, Num()))

    def body(blk):
        if block is None or block >= chunk:
            return P.mul(alpha, blk)
        return P.Join(P.Map(lambda b2: P.mul(alpha, b2),
                            P.Split(block, blk), level=P.GRID(0)))

    e = P.Join(P.Map(body, P.Split(chunk, xs), level=P.MESH(axis)))
    return e, [alpha, xs]


def _rows_body(per_row, row_block: Optional[int], chunk: int):
    def body(blk):
        if row_block is None or row_block >= chunk:
            return P.Map(per_row, blk, level=P.SEQ)
        return P.Join(P.Map(
            lambda rb: P.Map(per_row, rb, level=P.SEQ),
            P.Split(row_block, blk), level=P.GRID(0)))
    return body


def mesh_rmsnorm(rows: int, d: int, eps: float = 1e-6, *, axis: str,
                 shards: int, row_block: Optional[int] = None
                 ) -> Tuple[Expr, List[P.Var]]:
    """Row-sharded rmsnorm: rows split over the axis, weights replicated."""
    chunk = _chunk_of(rows, shards, "mesh_rmsnorm")
    xs = P.var_exp("xs", Arr(rows, Arr(d, Num())))
    w = P.var_exp("w", Arr(d, Num()))

    def per_row(row):
        ss = P.FullReduce("add", P.mul(row, row))
        inv = P.UnOp("rsqrt", P.add(P.div(ss, P.lit(float(d))), P.lit(eps)))
        return P.mul(P.mul(row, inv), w)

    e = P.Join(P.Map(_rows_body(per_row, row_block, chunk),
                     P.Split(chunk, xs), level=P.MESH(axis)))
    return e, [xs, w]


def mesh_softmax(rows: int, d: int, *, axis: str, shards: int,
                 row_block: Optional[int] = None) -> Tuple[Expr, List[P.Var]]:
    """Row-sharded softmax (rows are independent, so no collective at all)."""
    chunk = _chunk_of(rows, shards, "mesh_softmax")
    xs = P.var_exp("xs", Arr(rows, Arr(d, Num())))
    e = P.Join(P.Map(_rows_body(_softmax_row, row_block, chunk),
                     P.Split(chunk, xs), level=P.MESH(axis)))
    return e, [xs]


def mesh_matmul(m: int, k: int, n: int, *, axis: str, shards: int,
                bk: Optional[int] = None) -> Tuple[Expr, List[P.Var]]:
    """Row-sharded matmul: A's rows split over the axis, B replicated on
    every shard (the replicate side of replicate-vs-reduce; the contraction
    stays shard-local so no collective is emitted).  ``bk`` optionally blocks
    the contraction per shard as in ``dpia_blas.strategy_matmul``."""
    chunk = _chunk_of(m, shards, "mesh_matmul")
    a = P.var_exp("A", Arr(m, Arr(k, Num())))
    b = P.var_exp("B", Arr(k, Arr(n, Num())))

    def body(ablk):
        if bk is None or bk >= k:
            return P.DotBlock(ablk, b)
        zipped = P.Zip(P.Split(bk, P.Transpose(ablk)), P.Split(bk, b))
        return P.Reduce(
            lambda ab, acc: P.add(
                acc, P.DotBlock(P.Transpose(P.Fst(ab)), P.Snd(ab))),
            P.Lit(0.0, Arr(chunk, Arr(n, Num()))),
            zipped, level=P.SEQ)

    e = P.Join(P.Map(body, P.Split(chunk, a), level=P.MESH(axis)))
    return e, [a, b]


# kernel name -> (builder(shape..., axis=, shards=, <chunk param>), the
# logical extent the mesh axis shards) — the dispatch table mesh.space and
# kernels.ops build candidates from
MESH_KERNELS = {
    "dot": (lambda axis, shards, block=None, *, n:
            mesh_dot(n, axis, shards, block), "n"),
    "asum": (lambda axis, shards, block=None, *, n:
             mesh_asum(n, axis, shards, block), "n"),
    "scal": (lambda axis, shards, block=None, *, n:
             mesh_scal(n, axis, shards, block), "n"),
    "rmsnorm": (lambda axis, shards, row_block=None, *, rows, d, eps=1e-6:
                mesh_rmsnorm(rows, d, eps, axis=axis, shards=shards,
                             row_block=row_block), "rows"),
    "softmax": (lambda axis, shards, row_block=None, *, rows, d:
                mesh_softmax(rows, d, axis=axis, shards=shards,
                             row_block=row_block), "rows"),
    "matmul": (lambda axis, shards, bk=None, *, m, k, n:
               mesh_matmul(m, k, n, axis=axis, shards=shards, bk=bk), "m"),
}
