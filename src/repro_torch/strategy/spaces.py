"""Strategy *programs* for the autotune spaces.

The six hand-written kernel spaces in ``repro_torch.autotune.space`` used to
pick one of several builder functions per params dict; here every point of
every space is instead a :class:`~repro_torch.strategy.lang.Strategy`
program applied to the kernel's *naive spec* — the schedule is derived, never hand-built,
and the derivation (the :class:`StrategyTrace`) travels with the winner
into the tuning cache.  ``autotune.space`` delegates to
:func:`spec_builder` + :func:`program_for`, with oracle-equality against
the legacy builders pinned in tests/test_strategy.py.

:func:`generic_space` is the open-ended version the language buys us: the
same rules composed blindly over *any* well-typed DPIA term, ill-typed or
inapplicable compositions failing harmlessly — demonstrated on a fused
RMSNorm→matmul program (:func:`fused_rmsnorm_matmul`) that has no hand
space anywhere in the repo.

The port's copy of ``repro.strategy.spaces``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

from repro_torch.core.dpia import phrases as P
from repro_torch.core.dpia.types import Arr, Num

from . import traverse
from .lang import Result, Strategy, id_, rule, seq, try_

__all__ = ["spec_builder", "program_for", "generic_programs",
           "generic_space", "fused_rmsnorm_matmul", "GRID0"]

GRID0 = "grid(0)"

Builder = Callable[[], Tuple[P.Phrase, List[P.Var]]]


# ---------------------------------------------------------------------------
# the six kernel spaces, as (naive spec, params -> strategy program)
# ---------------------------------------------------------------------------

def spec_builder(kernel: str, **shape) -> Builder:
    """The naive (strategy-free) spec each kernel's space derives from."""
    from repro_torch.kernels import dpia_blas
    if kernel in ("dot", "asum", "scal"):
        naive = getattr(dpia_blas, f"naive_{kernel}")
        n = shape["n"]
        return lambda: naive(n)
    if kernel == "matmul":
        m, k, n = shape["m"], shape["k"], shape["n"]
        return lambda: dpia_blas.naive_matmul(m, k, n)
    if kernel == "rmsnorm":
        rows, d = shape["rows"], shape["d"]
        eps = shape.get("eps", 1e-6)
        return lambda: dpia_blas.naive_rmsnorm(rows, d, eps)
    if kernel == "softmax":
        rows, d = shape["rows"], shape["d"]
        return lambda: dpia_blas.naive_softmax(rows, d)
    raise ValueError(f"spec_builder: unknown kernel {kernel!r}")


def _blocked_reduce_program(block: int, leaf: str) -> Strategy:
    prog = seq(rule("fuse_map_into_reduce"),
               rule("blocked_reduce", block=block,
                    partial_level=GRID0, combine="add"))
    if leaf == "vpu":
        # innermost-first: the per-block sequential reduce (inside the grid
        # map's binder) becomes the whole-block VPU FullReduce; topdown
        # would wrongly fire on the outer partials-combine instead
        prog = seq(prog, traverse.bottomup(rule("vpu_reduce")))
    return prog


def _row_block_program(row_block: int) -> Strategy:
    return seq(rule("split_join", block=row_block),
               traverse.one(rule("with_level", level=GRID0)))


def program_for(kernel: str, params: Dict[str, object]) -> Strategy:
    """The strategy program one params dict of a kernel's space denotes.

    Shape-independent: divisibility and typing side conditions live in the
    rules, so an inapplicable program *fails* rather than building a bad
    term."""
    if kernel in ("dot", "asum"):
        if params.get("block") is None:
            return id_()
        return _blocked_reduce_program(int(params["block"]),
                                       str(params.get("leaf", "vpu")))
    if kernel == "scal":
        if params.get("block") is None:
            return id_()
        prog = _row_block_program(int(params["block"]))
        if params.get("vector") is None:
            # the block handled as one lifted VPU op (the lanes reading)
            return seq(prog, traverse.bottomup(rule("lift_lanes")))
        return seq(prog, traverse.bottomup(
            rule("vectorize", width=int(params["vector"]))))
    if kernel == "matmul":
        return rule("tile_matmul", bm=int(params["bm"]),
                    bk=int(params["bk"]))
    if kernel in ("rmsnorm", "softmax"):
        return _row_block_program(int(params["row_block"]))
    raise ValueError(f"program_for: unknown kernel {kernel!r}")


# ---------------------------------------------------------------------------
# the generic space: any well-typed term, strategies for free
# ---------------------------------------------------------------------------

def generic_programs(blocks: Sequence[int],
                     lanes: Sequence[int] = (128,),
                     tiles: Sequence[int] = (32, 64, 128, 256)
                     ) -> List[Tuple[Dict[str, object], Strategy]]:
    """Candidate (params, program) pairs composing the rule vocabulary.

    Deliberately over-generates: programs whose side conditions a given
    term cannot meet simply fail at ``apply`` time and are dropped by
    :func:`generic_space` — failure-as-a-value is what lets one menu serve
    every term."""
    out: List[Tuple[Dict[str, object], Strategy]] = [
        ({"rewrite": "id"}, id_()),
    ]
    for b in blocks:
        out.append((
            {"rewrite": "blocked_reduce", "block": b},
            rule("blocked_reduce", block=b, partial_level=GRID0)))
        out.append((
            {"rewrite": "fuse+blocked", "block": b},
            _blocked_reduce_program(b, "seq")))
        out.append((
            {"rewrite": "fuse+blocked+vpu", "block": b},
            _blocked_reduce_program(b, "vpu")))
        out.append((
            {"rewrite": "split_join", "block": b},
            _row_block_program(b)))
        out.append((
            {"rewrite": "split+lanes", "block": b},
            seq(_row_block_program(b), traverse.bottomup(rule("lift_lanes")))))
        for w in lanes:
            if b % w == 0:
                out.append((
                    {"rewrite": "split+vec", "block": b, "vector": w},
                    seq(_row_block_program(b),
                        traverse.bottomup(rule("vectorize", width=w)))))
    for bm in tiles:
        for bk in tiles:
            out.append((
                {"rewrite": "tile_matmul", "bm": bm, "bk": bk},
                rule("tile_matmul", bm=bm, bk=bk)))
            out.append((
                {"rewrite": "tile_matmul+vmem", "bm": bm, "bk": bk},
                seq(rule("tile_matmul", bm=bm, bk=bk),
                    try_(rule("stage_vmem")))))
    return out


def generic_space(expr: P.Phrase,
                  blocks: Sequence[int] = (128, 256, 512, 1024, 2048),
                  lanes: Sequence[int] = (128,),
                  tiles: Sequence[int] = (32, 64, 128, 256)
                  ) -> List[Tuple[Dict[str, object], Strategy, Result]]:
    """Every generic program that *succeeds* on ``expr``, deduplicated by
    the structural fingerprint of the rewritten term.  The identity always
    survives, so the space is never empty for a well-typed term."""
    out, seen = [], set()
    for params, prog in generic_programs(blocks, lanes, tiles):
        res = prog.apply(expr)
        if not res.ok:
            continue
        fp = traverse.fingerprint(res.phrase)
        if fp in seen:
            continue
        seen.add(fp)
        out.append((params, prog, res))
    return out


def fused_rmsnorm_matmul(rows: int, d: int, n: int, eps: float = 1e-6
                         ) -> Tuple[P.Phrase, List[P.Var]]:
    """RMSNorm fused into a matmul — ``(rmsnorm(xs, w)) @ B`` as one term.

    No hand space exists for this op anywhere in the repo; the generic
    space gives it MXU tiling (``tile_matmul`` matches the outer matmul
    shape with the normalisation riding along as the lhs operand) and row
    blocking for free."""
    from repro_torch.kernels import dpia_blas
    xs = P.var_exp("xs", Arr(rows, Arr(d, Num())))
    w = P.var_exp("w", Arr(d, Num()))
    b = P.var_exp("B", Arr(d, Arr(n, Num())))
    normed = P.Map(dpia_blas.rmsnorm_row(d, eps, w), xs)
    e = P.Map(lambda row: P.Map(
        lambda col: P.Reduce(
            lambda q, acc: P.add(acc, q), P.lit(0.0),
            P.Map(lambda z: P.mul(P.Fst(z), P.Snd(z)), P.Zip(row, col))),
        P.Transpose(b)), normed)
    return e, [xs, w, b]
