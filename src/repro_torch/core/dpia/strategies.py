"""Semantics-preserving strategy rewrites (Steuwer et al. 2015 layer).

The paper assumes parallelisation strategies are *derived* at the functional
level by semantics-preserving rewriting and only then compiled.  These are the
rewrite rules we use, each a function Expr -> Expr whose oracle-equality is
property-tested (tests/test_dpia_strategies.py):

  split_join   map f xs            = join (map (map f) (split b xs))
  blocked_reduce (assoc f, unit z)
               reduce f z xs       = reduce f z (map (reduce f z) (split b xs))
  fuse_map_into_reduce
               reduce f z (map g xs) = reduce (λx a. f (g x) a) z xs
  vectorize    map (scalar op) xs  = asScalar (map (vector op) (asVector w xs))
  distribute   assign mesh/grid/seq levels to maps/reduces
  stage_vmem   wrap an expression so its materialisation lands in VMEM
  vpu_reduce   reduce (λx a. a ⊕ g x) 1⊕ xs = fullReduce ⊕ (g* xs)
  lift_lanes   map (elementwise g) xs = g* xs  (one whole-block VPU op)
  tile_matmul  naive row×col matmul = grid-blocked MXU k-chunk accumulation

plus a tiny exhaustive strategy search used by the benchmarks (the analogue
of the ICFP'15 stochastic search, feasible here because our kernels have a
small, structured strategy space).

The port's copy of ``repro.core.dpia.strategies``.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Optional

from . import phrases as P
from .types import Arr, Num, Pair, Vec


def split_join(m: P.Map, b: int) -> P.Phrase:
    """map f xs  ->  join (map[level] (map f) (split b xs))."""
    d = P.exp_data(m.e)
    assert isinstance(d, Arr) and d.n % b == 0
    return P.Join(P.Map(
        lambda blk: P.Map(m.f, blk, level=P.SEQ, space=m.space),
        P.Split(b, m.e),
        level=m.level))


def blocked_reduce(r: P.Reduce, b: int, *,
                   partial_level: Optional[P.Par] = None,
                   combine=None) -> P.Phrase:
    """reduce f z xs -> reduce g z (map (reduce f z) (split b xs)).

    ``g`` (``combine``) merges per-block partials; it defaults to ``f`` when
    the reducer is homogeneous (d1 == d2).  Caller asserts associativity of
    the combine with unit z (the rewrite system's semantic side condition,
    as in the paper's provenance)."""
    d = P.exp_data(r.e)
    assert isinstance(d, Arr) and d.n % b == 0
    g = combine or r.f
    return P.Reduce(
        g, r.init,
        P.Map(lambda blk: P.Reduce(r.f, r.init, blk, level=P.SEQ),
              P.Split(b, r.e),
              level=partial_level or P.PAR),
        level=r.level)


def fuse_map_into_reduce(r: P.Reduce) -> P.Phrase:
    """reduce f z (map g xs) -> reduce (λx a. f (g x) a) z xs."""
    m = r.e
    assert isinstance(m, P.Map), "reduce input is not a map"
    return P.Reduce(lambda x, a: r.f(m.f(x), a), r.init, m.e, level=r.level)


def vectorize(m: P.Map, w: int) -> P.Phrase:
    """map f xs -> asScalar (map f_vec (asVector w xs)) for pointwise f.

    Our UnOp/BinOp are already elementwise at vector types, so ``f`` applied
    to a vector element *is* f_vec — the paper's asVector story (section 6.2),
    with w = TPU lane width rather than OpenCL's float4."""
    d = P.exp_data(m.e)
    assert isinstance(d, Arr) and isinstance(d.elem, Num) and d.n % w == 0
    return P.AsScalar(P.Map(m.f, P.AsVector(w, m.e), level=m.level))


def with_level(e: P.Phrase, level: P.Par) -> P.Phrase:
    """Assign an execution level to the outermost map/reduce."""
    if isinstance(e, P.Map):
        return P.Map(e.f, e.e, level=level, space=e.space)
    if isinstance(e, P.Reduce):
        return P.Reduce(e.f, e.init, e.e, level=level)
    raise TypeError("with_level: not a map/reduce")


def stage_vmem(e: P.Phrase) -> P.Phrase:
    """toVMEM wrapper: materialise the value in VMEM (paper's toLocal)."""
    return P.ToMem(P.VMEM, e)


# ---------------------------------------------------------------------------
# leaf-lowering rewrites (the "lanes" reading of an inner loop): these turn
# derived sequential leaves into the whole-block VPU/MXU forms the
# hand-written strategy_* builders use, so a full TPU schedule is derivable
# from the naive spec by rewriting alone.
# ---------------------------------------------------------------------------

def _subst(e: P.Phrase, name: str, repl: P.Phrase) -> P.Phrase:
    """Capture-avoiding substitution of the free Var ``name`` in a
    functional term (fresh() names are globally unique, so HOAS binder
    arguments can never shadow it)."""
    import dataclasses
    if isinstance(e, P.Var):
        return repl if e.name == name else e
    if isinstance(e, P.Lit):
        return e
    if isinstance(e, P.Map):
        return P.Map(lambda *a: _subst(e.f(*a), name, repl),
                     _subst(e.e, name, repl), level=e.level, space=e.space)
    if isinstance(e, P.Reduce):
        return P.Reduce(lambda *a: _subst(e.f(*a), name, repl),
                        _subst(e.init, name, repl),
                        _subst(e.e, name, repl), level=e.level)
    kw, changed = {}, False
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, P.Phrase):
            v2 = _subst(v, name, repl)
            changed |= v2 is not v
            kw[f.name] = v2
        else:
            kw[f.name] = v
    return type(e)(**kw) if changed else e


_ELEMWISE_NODES = (P.Var, P.Lit, P.UnOp, P.BinOp, P.Fst, P.Snd)


def _elementwise_over(e: P.Phrase, bound: str,
                      forbid: Optional[str] = None) -> bool:
    """Is ``e`` an elementwise (VPU-liftable) expression over Var ``bound``?

    Returns whether ``bound`` actually occurs; raises AssertionError on any
    non-elementwise node or on an occurrence of ``forbid`` (the accumulator
    in vpu_reduce's side condition)."""
    assert isinstance(e, _ELEMWISE_NODES), \
        f"not elementwise: {type(e).__name__}"
    if isinstance(e, P.Var):
        assert forbid is None or e.name != forbid, \
            "accumulator occurs inside the mapped expression"
        return e.name == bound
    occurs = False
    for fname in ("e", "a", "b"):
        sub = getattr(e, fname, None)
        if isinstance(sub, P.Phrase):
            occurs |= _elementwise_over(sub, bound, forbid)
    return occurs


def vpu_reduce(r: P.Reduce) -> P.Phrase:
    """reduce (λx a. a ⊕ g x) z xs  ->  fullReduce ⊕ (g* xs).

    Side conditions: ⊕ is add/max with z its unit literal, g is elementwise
    in x and free of the accumulator — then the whole reduction is one
    whole-block VPU op over the lifted g (UnOp/BinOp are elementwise at
    array types already, so substituting xs for x *is* the lift g*)."""
    assert isinstance(r, P.Reduce), "vpu_reduce: not a reduce"
    d = P.exp_data(r.e)
    assert isinstance(d, Arr), "vpu_reduce: input is not an array"
    x = P.Var(P.fresh("_vx"), P.ExpT(d.elem))
    a = P.Var(P.fresh("_va"), P.ExpT(P.exp_data(r.init)))
    body = r.f(x, a)
    assert isinstance(body, P.BinOp) and body.op in ("add", "max"), \
        "vpu_reduce: reducer is not acc ⊕ g(x) for ⊕ in {add, max}"
    if isinstance(body.a, P.Var) and body.a.name == a.name:
        g = body.b
    elif isinstance(body.b, P.Var) and body.b.name == a.name:
        g = body.a
    else:
        raise AssertionError("vpu_reduce: accumulator is not a bare operand")
    assert _elementwise_over(g, x.name, forbid=a.name), \
        "vpu_reduce: mapped expression must be elementwise in x"
    assert isinstance(r.init, P.Lit) and (
        (body.op == "add" and float(r.init.value) == 0.0)
        or (body.op == "max" and float(r.init.value) == float("-inf"))), \
        "vpu_reduce: init is not the unit of ⊕"
    return P.FullReduce(body.op, _subst(g, x.name, r.e))


def lift_lanes(m: P.Map) -> P.Phrase:
    """map (λx. g x) xs  ->  g* xs — one whole-block VPU op (lanes level).

    g must be elementwise in x (and mention it); broadcasting scalar frees
    like ``alpha`` are fine, which is exactly how ``strategy_scal``'s
    per-block body arises from the naive spec."""
    assert isinstance(m, P.Map), "lift_lanes: not a map"
    d = P.exp_data(m.e)
    assert isinstance(d, Arr) and isinstance(d.elem, (Num, Vec)), \
        "lift_lanes: input is not an array of scalars/vectors"
    x = P.Var(P.fresh("_lx"), P.ExpT(d.elem))
    body = m.f(x)
    assert _elementwise_over(body, x.name), \
        "lift_lanes: body must be elementwise in x (and mention it)"
    return _subst(body, x.name, m.e)


def tiled_matmul_expr(a: P.Phrase, b: P.Phrase, n: int, bm: int, bk: int
                      ) -> P.Phrase:
    """The canonical TPU matmul shape over operands ``a : (m,k)`` and
    ``b : (k,n)``: grid over bm row blocks of A, sequential MXU
    accumulation over bk-wide k chunks.  Shared by the ``strategy_matmul``
    builder and the ``tile_matmul`` rewrite, so the derived and the
    hand-written schedules are the same term."""
    def per_block(ablk):
        # k-chunks of the A block as pure re-views (no materialisation):
        # Split(bk, Transpose(ablk)) : (k/bk, bk, bm) — chunk^T per step.
        zipped = P.Zip(P.Split(bk, P.Transpose(ablk)), P.Split(bk, b))
        return P.Reduce(
            lambda ab, acc: P.add(
                acc, P.DotBlock(P.Transpose(P.Fst(ab)), P.Snd(ab))),
            P.Lit(0.0, Arr(bm, Arr(n, Num()))),
            zipped, level=P.SEQ)

    return P.Join(P.Map(per_block, P.Split(bm, a), level=P.GRID(0)))


def tile_matmul(e: P.Phrase, bm: int, bk: int) -> P.Phrase:
    """naive matmul (map over A rows of a map over B^T columns of a dot)
    ->  grid-blocked MXU accumulation (``tiled_matmul_expr``)."""
    assert isinstance(e, P.Map), "tile_matmul: not a map"
    da = P.exp_data(e.e)
    assert isinstance(da, Arr) and isinstance(da.elem, Arr), \
        "tile_matmul: lhs is not a matrix"
    m, k = da.n, da.elem.n
    row = P.Var(P.fresh("_row"), P.ExpT(da.elem))
    body = e.f(row)
    assert isinstance(body, P.Map) and isinstance(body.e, P.Transpose), \
        "tile_matmul: body is not a map over a transposed rhs"
    bexpr = body.e.e
    db = P.exp_data(bexpr)
    assert isinstance(db, Arr) and isinstance(db.elem, Arr) and db.n == k, \
        "tile_matmul: rhs contraction extent mismatch"
    col = P.Var(P.fresh("_col"), P.ExpT(Arr(k, db.elem.elem)))
    assert isinstance(body.f(col), P.Reduce), \
        "tile_matmul: inner body is not a dot-style reduction"
    assert m % bm == 0 and k % bk == 0, "tile_matmul: tiles must divide"
    return tiled_matmul_expr(e.e, bexpr, db.elem.n, bm, bk)


# ---------------------------------------------------------------------------
# strategy enumeration / search (the ICFP'15 search, miniaturised).
# The real autotuner lives in repro_torch.autotune (generalised spaces,
# analytic cost model, measured refinement, persistent cache); these entry
# points are kept as thin compatibility shims over it.
# ---------------------------------------------------------------------------

def enumerate_dot_strategies(n: int, blocks: Iterable[int] = (256, 1024, 2048),
                             lanes: Iterable[int] = (128,)) -> List[dict]:
    """Strategy space for dot-product-like reductions of length n.

    Compatibility shim: delegates to ``repro_torch.autotune.space`` (which
    holds the generalised per-kernel spaces) and preserves the seed's
    output format of ``{"block": b, "vector": w|None}`` dicts."""
    from repro_torch.autotune import space as _space
    return _space.dot_param_grid(n, blocks=blocks, lanes=lanes)


def search(candidates: List[P.Phrase], cost_fn: Callable[[P.Phrase], float]
           ) -> P.Phrase:
    """Pick the candidate strategy minimising ``cost_fn`` (compiled cost).

    Deterministic: NaN costs are treated as +inf, and ties (including the
    all-infinite case) are broken by earliest position in ``candidates``,
    so a fixed candidate order always yields the same winner.

    A ``cost_fn`` that *raises* on some candidate (a cost model that cannot
    price an exotic term) skips that candidate — warned once per process,
    with an obs event per occurrence — instead of aborting the search; if
    every candidate raises, the first is returned like the all-infinite
    case."""
    if not candidates:
        raise ValueError(
            "strategies.search: empty candidate list — enumerate a "
            "non-empty strategy space first (see repro_torch.autotune.space; "
            "e.g. no block size divides the input extent)")
    best, best_c = candidates[0], float("inf")
    for i, c in enumerate(candidates):
        try:
            cost = cost_fn(c)
        except Exception as e:  # noqa: BLE001 — cost failure skips, not aborts
            _warn_cost_failure(i, e)
            continue
        if cost == cost and cost < best_c:  # NaN-safe strict improvement
            best, best_c = c, cost
    return best


_warned_cost_failure = False


def _warn_cost_failure(index: int, exc: Exception) -> None:
    global _warned_cost_failure
    try:
        from repro_torch import obs
        obs.event("strategies.search.cost_error", candidate=index,
                  error=f"{type(exc).__name__}: {exc}")
    except Exception:
        pass  # observability must never break the search
    if not _warned_cost_failure:
        _warned_cost_failure = True
        import warnings
        warnings.warn(
            f"strategies.search: cost_fn raised on candidate {index} "
            f"({type(exc).__name__}: {exc}); skipping it (warned once "
            f"per process, every occurrence emits an obs event)",
            RuntimeWarning, stacklevel=3)
