"""The paper's benchmark ops (scal/asum/dot/gemv, section 7) + rmsnorm/matmul/
softmax, expressed as DPIA functional terms with strategies and compiled
through the formal pipeline (Stage I -> II -> III).

The port's copy of ``repro.kernels.dpia_blas``: the same terms, so the two
packages' Stage II texts agree.  The strategies are the reference's,
shaped for the TPU; on Hopper each grid-level map becomes one CUDA grid of
the generated kernel (``core.dpia.stage3_cuda``).  ``mesh_dot`` waits for
the port's mesh slice.

Each op comes in two forms:
  * ``naive_*``    — the high-level specification (paper eq. (1) style);
  * ``strategy_*`` — a TPU-shaped strategy (paper eq. (2)/section 6.3 style):
    grid-blocked (`map[grid]` over `split`), whole-block VPU leaf ops (the
    lanes level), sequential combine.

Build functions return ``(expr, arg_vars)``; compile them through the staged
API — ``repro_torch.compiler.Program(expr, arg_vars).check().lower()
.compile(backend)``.
"""
from __future__ import annotations

from typing import List, Tuple

from ..core.dpia import phrases as P
from ..core.dpia.types import Arr, Num

Expr = P.Phrase


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------

def naive_scal(n: int) -> Tuple[Expr, List[P.Var]]:
    alpha = P.var_exp("alpha", Num())
    xs = P.var_exp("xs", Arr(n, Num()))
    e = P.Map(lambda x: P.mul(alpha, x), xs)
    return e, [alpha, xs]


def strategy_scal(n: int, block: int = 2048) -> Tuple[Expr, List[P.Var]]:
    alpha = P.var_exp("alpha", Num())
    xs = P.var_exp("xs", Arr(n, Num()))
    e = P.Join(P.Map(lambda blk: P.mul(alpha, blk),
                     P.Split(block, xs), level=P.GRID(0)))
    return e, [alpha, xs]


def wholeblock_scal(n: int) -> Tuple[Expr, List[P.Var]]:
    """Single whole-array VPU block op (one grid step) — the optimal strategy
    when the array fits one kernel invocation's streaming pass."""
    alpha = P.var_exp("alpha", Num())
    xs = P.var_exp("xs", Arr(n, Num()))
    e = P.Join(P.Map(lambda blk: P.mul(alpha, blk),
                     P.Split(n, xs), level=P.GRID(0)))
    return e, [alpha, xs]


def naive_asum(n: int) -> Tuple[Expr, List[P.Var]]:
    xs = P.var_exp("xs", Arr(n, Num()))
    e = P.Reduce(lambda x, a: P.add(a, x), P.lit(0.0),
                 P.Map(lambda x: P.UnOp("abs", x), xs))
    return e, [xs]


def strategy_asum(n: int, block: int = 2048) -> Tuple[Expr, List[P.Var]]:
    xs = P.var_exp("xs", Arr(n, Num()))
    partials = P.Map(lambda blk: P.FullReduce("add", P.UnOp("abs", blk)),
                     P.Split(block, xs), level=P.GRID(0))
    e = P.Reduce(lambda x, a: P.add(a, x), P.lit(0.0), partials, level=P.SEQ)
    return e, [xs]


def naive_dot(n: int) -> Tuple[Expr, List[P.Var]]:
    xs = P.var_exp("xs", Arr(n, Num()))
    ys = P.var_exp("ys", Arr(n, Num()))
    e = P.Reduce(lambda x, a: P.add(a, x), P.lit(0.0),
                 P.Map(lambda z: P.mul(P.Fst(z), P.Snd(z)), P.Zip(xs, ys)))
    return e, [xs, ys]


def strategy_dot(n: int, block: int = 2048) -> Tuple[Expr, List[P.Var]]:
    xs = P.var_exp("xs", Arr(n, Num()))
    ys = P.var_exp("ys", Arr(n, Num()))
    partials = P.Map(
        lambda blk: P.FullReduce("add", P.mul(P.Fst(blk), P.Snd(blk))),
        P.Split(block, P.Zip(xs, ys)), level=P.GRID(0))
    e = P.Reduce(lambda x, a: P.add(a, x), P.lit(0.0), partials, level=P.SEQ)
    return e, [xs, ys]


def naive_gemv(m: int, n: int) -> Tuple[Expr, List[P.Var]]:
    a = P.var_exp("A", Arr(m, Arr(n, Num())))
    x = P.var_exp("x", Arr(n, Num()))
    e = P.Map(lambda row: P.Reduce(
        lambda z, acc: P.add(acc, z), P.lit(0.0),
        P.Map(lambda p: P.mul(P.Fst(p), P.Snd(p)), P.Zip(row, x))), a)
    return e, [a, x]


def strategy_gemv(m: int, n: int, row_block: int = 128
                  ) -> Tuple[Expr, List[P.Var]]:
    a = P.var_exp("A", Arr(m, Arr(n, Num())))
    x = P.var_exp("x", Arr(n, Num()))
    e = P.Join(P.Map(lambda rows: P.DotBlock(rows, x),
                     P.Split(row_block, a), level=P.GRID(0)))
    return e, [a, x]


def rmsnorm_row(d: int, eps: float, w: P.Var):
    """The per-row rmsnorm body both builders share: mean(x^2) -> rsqrt ->
    scale (whole-row VPU sum leaf)."""
    def per_row(row):
        ss = P.FullReduce("add", P.mul(row, row))
        inv = P.UnOp("rsqrt", P.add(P.div(ss, P.lit(float(d))), P.lit(eps)))
        return P.mul(P.mul(row, inv), w)
    return per_row


def naive_rmsnorm(rows: int, d: int, eps: float = 1e-6
                  ) -> Tuple[Expr, List[P.Var]]:
    """Row-wise rmsnorm spec: one map over rows, no blocking decided yet."""
    xs = P.var_exp("xs", Arr(rows, Arr(d, Num())))
    w = P.var_exp("w", Arr(d, Num()))
    return P.Map(rmsnorm_row(d, eps, w), xs), [xs, w]


def strategy_rmsnorm(rows: int, d: int, eps: float = 1e-6,
                     row_block: int = 8) -> Tuple[Expr, List[P.Var]]:
    """Fused rmsnorm through DPIA: per row-block, mean(x^2) -> rsqrt -> scale."""
    xs = P.var_exp("xs", Arr(rows, Arr(d, Num())))
    w = P.var_exp("w", Arr(d, Num()))
    e = P.Join(P.Map(
        lambda blk: P.Map(rmsnorm_row(d, eps, w), blk, level=P.SEQ),
        P.Split(row_block, xs), level=P.GRID(0)))
    return e, [xs, w]


def _softmax_row(row: Expr) -> Expr:
    """The one softmax spec both builders share: exp(x - max x) / sum."""
    mx = P.FullReduce("max", row)
    ex = P.UnOp("exp", P.sub(row, mx))
    return P.div(ex, P.FullReduce("add", ex))


def naive_softmax(rows: int, d: int) -> Tuple[Expr, List[P.Var]]:
    """Row softmax spec: per row, exp(x - max x) / sum exp(x - max x)."""
    xs = P.var_exp("xs", Arr(rows, Arr(d, Num())))
    return P.Map(_softmax_row, xs), [xs]


def strategy_softmax(rows: int, d: int, row_block: int = 8
                     ) -> Tuple[Expr, List[P.Var]]:
    """Softmax with rmsnorm's strategy shape: grid over row blocks,
    sequential rows within a block, whole-row VPU max/sum leaves."""
    xs = P.var_exp("xs", Arr(rows, Arr(d, Num())))
    e = P.Join(P.Map(
        lambda blk: P.Map(_softmax_row, blk, level=P.SEQ),
        P.Split(row_block, xs), level=P.GRID(0)))
    return e, [xs]


def naive_matmul(m: int, k: int, n: int) -> Tuple[Expr, List[P.Var]]:
    """Matmul spec: per A row, per B^T column, a dot product — the blocking
    and MXU mapping are strategy decisions (``tile_matmul``), not spec."""
    a = P.var_exp("A", Arr(m, Arr(k, Num())))
    b = P.var_exp("B", Arr(k, Arr(n, Num())))
    e = P.Map(lambda row: P.Map(
        lambda col: P.Reduce(
            lambda q, acc: P.add(acc, q), P.lit(0.0),
            P.Map(lambda z: P.mul(P.Fst(z), P.Snd(z)), P.Zip(row, col))),
        P.Transpose(b)), a)
    return e, [a, b]


def strategy_matmul(m: int, k: int, n: int, bm: int = 128, bk: int = 128
                    ) -> Tuple[Expr, List[P.Var]]:
    """Blocked matmul: grid over row blocks, sequential MXU accumulation over
    k chunks (the canonical TPU matmul shape, in DPIA vocabulary) — the
    same term ``strategies.tile_matmul`` derives from ``naive_matmul``."""
    from ..core.dpia.strategies import tiled_matmul_expr
    a = P.var_exp("A", Arr(m, Arr(k, Num())))
    b = P.var_exp("B", Arr(k, Arr(n, Num())))
    return tiled_matmul_expr(a, b, n, bm, bk), [a, b]
