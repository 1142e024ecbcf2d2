"""Strategy-space enumeration over the DPIA rewrites.

Every candidate is the *same mathematical function* as the naive spec —
derived by the semantics-preserving rewrites of
``repro_torch.core.dpia.strategies`` (split_join, blocked_reduce,
fuse_map_into_reduce, vectorize) plus level assignment — so the tuner can
only ever trade performance, never correctness.  Candidates are described
by a small JSON-able ``params`` dict so tuning decisions survive in the
persistent cache (see cache.py) and can be rebuilt later with
``candidate_from_params``.

Since the ``repro_torch.strategy`` subsystem landed, each params dict denotes a
strategy *program* (``repro_torch.strategy.spaces.program_for``) applied to the
kernel's naive spec, and every candidate can report the derivation it took
(:meth:`Candidate.trace_doc`) — the legacy hand-built builders survive as
``legacy_candidate``, the oracle the strategy-program path is equality-
tested against.

Parameter vocabulary per kernel family:

  dot / reduce   {"block": int|None, "leaf": "vpu"|"seq"}
                 block=None is the unrewritten spec; leaf picks whether a
                 block is reduced by a whole-block VPU FullReduce or by a
                 sequential (rewrite-derived) inner reduce.
  map / scal     {"block": int|None, "vector": int|None}
                 split_join grid blocking, optionally vectorize(w) inside.
  matmul         {"bm": int, "bk": int}   MXU row/contraction tiles.
  rmsnorm        {"row_block": int}
  softmax        {"row_block": int}

The port's copy of ``repro.autotune.space``.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.dpia import phrases as P
from repro_torch.core.dpia import strategies
from repro_torch.core.dpia.types import Arr, Num, show_data

Expr = P.Phrase
Builder = Callable[[], Tuple[Expr, List[P.Var]]]

# candidate tile/block menus (filtered by divisibility per shape)
SPLIT_BLOCKS: Tuple[int, ...] = (128, 256, 512, 1024, 2048, 4096, 8192)
ROW_BLOCKS: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128)
MXU_TILES: Tuple[int, ...] = (32, 64, 128, 256)
LANE_WIDTHS: Tuple[int, ...] = (128,)


@dataclass(frozen=True)
class Candidate:
    """One point of the strategy space: params + a builder for its expr.

    ``strategy``/``spec`` (a ``repro_torch.strategy`` program + the
    naive-spec builder it applies to) are present on strategy-derived
    candidates and power :meth:`trace_doc`; builder-only candidates (legacy
    oracles, hand-edited params) simply have no derivation to report.
    ``shape``, on strategy-derived candidates, names the program as the op
    layer names its executor of these params (:func:`program_name`), so a
    source the tuner built is the library the op table loads."""
    kernel: str
    params: Tuple[Tuple[str, object], ...]
    build: Builder = field(compare=False, repr=False)
    strategy: object = field(default=None, compare=False, repr=False)
    spec: object = field(default=None, compare=False, repr=False)
    shape: Optional[Dict[str, object]] = field(default=None, compare=False,
                                               repr=False)

    @property
    def params_dict(self) -> Dict[str, object]:
        return dict(self.params)

    def params_key(self) -> str:
        return params_key(self.params_dict)

    def trace_doc(self) -> Optional[dict]:
        """The serialised StrategyTrace of this candidate's derivation, or
        None when the candidate was not built by a strategy program."""
        if self.strategy is None or self.spec is None:
            return None
        expr, _ = self.spec()
        res = self.strategy.apply(expr)
        return res.trace.to_doc() if res.ok else None

    def program(self):
        """This candidate as a ``repro_torch.compiler.Program``: the staged
        entry the tuner's measure/compile paths consume."""
        from repro_torch.compiler import Program
        expr, arg_vars = self.build()
        name = (program_name(self.kernel, self.params_dict, **self.shape)
                if self.shape is not None
                else f"{self.kernel}[{self.params_key()}]")
        prog = Program(expr, arg_vars, name=name)
        try:
            prog.strategy_trace = self.trace_doc()
        except Exception:
            prog.strategy_trace = None
        return prog


def params_key(params: Dict[str, object]) -> str:
    """Canonical string form of a params dict (cache / timing-table key)."""
    return ",".join(f"{k}={params[k]}" for k in sorted(params))


def program_name(kernel: str, params: Optional[Dict[str, object]] = None,
                 **shape) -> str:
    """The port's name of ``kernel``'s program at ``shape`` (a generated
    source is built as ``build/dpia/<name>-<hash>.so``): the kernel and the
    shape's values, and ``[k=v,...]`` when ``params`` are given."""
    name = "_".join([kernel] + [str(v) for v in shape.values()])
    return name if params is None else f"{name}[{params_key(params)}]"


def _cand(kernel: str, params: Dict[str, object], build: Builder) -> Candidate:
    return Candidate(kernel, tuple(sorted(params.items())), build)


def _strategy_cand(kernel: str, params: Dict[str, object],
                   shape: Dict[str, object]) -> Candidate:
    """A candidate whose expr is derived by the strategy program its params
    denote, applied to the kernel's naive spec."""
    from repro_torch import strategy as strategy_mod
    spec = strategy_mod.spec_builder(kernel, **shape)
    program = strategy_mod.program_for(kernel, params)

    def build():
        expr, argv = spec()
        res = program.apply(expr)
        if not res.ok:
            raise ValueError(
                f"strategy program for {kernel} {params_key(params)} "
                f"failed: {res.reason}")
        return res.phrase, argv

    return Candidate(kernel, tuple(sorted(params.items())), build,
                     strategy=program, spec=spec, shape=dict(shape))


def _divides(blocks: Iterable[int], n: int) -> List[int]:
    return [b for b in blocks if 0 < b <= n and n % b == 0]


# ---------------------------------------------------------------------------
# per-kernel spaces (params grids; every candidate built by its strategy
# program via _strategy_cand)
# ---------------------------------------------------------------------------

def _reduce_builder(kernel: str, n: int, block: Optional[int],
                    leaf: str) -> Builder:
    """Legacy hand-built builder for the reduce-shaped kernels (dot, asum) —
    kept as the oracle ``legacy_candidate`` exposes; enumeration goes
    through the strategy programs."""
    def build():
        from repro_torch.kernels import dpia_blas
        naive = getattr(dpia_blas, f"naive_{kernel}")
        strat = getattr(dpia_blas, f"strategy_{kernel}")
        if block is None:
            return naive(n)
        if leaf == "vpu":
            return strat(n, block)
        # leaf == "seq": derive by the rewrites themselves (quickstart's path)
        expr, argv = naive(n)
        fused = strategies.fuse_map_into_reduce(expr)
        blocked = strategies.blocked_reduce(
            fused, block, partial_level=P.GRID(0),
            combine=lambda x, a: P.add(a, x))
        return blocked, argv
    return build


def _reduce_space(kernel: str, n: int,
                  blocks: Sequence[int]) -> List[Candidate]:
    shape = {"n": n}
    out = [_strategy_cand(kernel, {"block": None, "leaf": "seq"}, shape)]
    for b in _divides(tuple(blocks) + (n,), n):
        for leaf in ("vpu", "seq"):
            out.append(_strategy_cand(kernel, {"block": b, "leaf": leaf},
                                      shape))
    return _dedup(out)


def dot_space(n: int, blocks: Sequence[int] = SPLIT_BLOCKS) -> List[Candidate]:
    return _reduce_space("dot", n, blocks)


def asum_space(n: int, blocks: Sequence[int] = SPLIT_BLOCKS) -> List[Candidate]:
    return _reduce_space("asum", n, blocks)


def _scal_builder(n: int, block: Optional[int],
                  vector: Optional[int]) -> Builder:
    """Legacy hand-built scal builder (oracle for the strategy programs)."""
    from repro_torch.kernels import dpia_blas

    def build():
        if block is None:
            return dpia_blas.naive_scal(n)
        if vector is None:
            # split_join at the grid level with the block handled as one
            # lifted VPU op (the lanes reading of the inner map)
            return dpia_blas.strategy_scal(n, block)
        # grid-blocked, with each block's map vectorize(w)-rewritten
        expr, argv = dpia_blas.naive_scal(n)
        alpha, xs = argv

        def per_block(blk):
            return strategies.vectorize(
                P.Map(lambda x: P.mul(alpha, x), blk, level=P.SEQ), vector)
        return P.Join(P.Map(per_block, P.Split(block, xs),
                            level=P.GRID(0))), argv
    return build


def scal_space(n: int, blocks: Sequence[int] = SPLIT_BLOCKS,
               lanes: Sequence[int] = LANE_WIDTHS) -> List[Candidate]:
    shape = {"n": n}
    out = [_strategy_cand("scal", {"block": None, "vector": None}, shape)]
    for b in _divides(tuple(blocks) + (n,), n):
        out.append(_strategy_cand("scal", {"block": b, "vector": None},
                                  shape))
        for w in lanes:
            if b % w == 0:
                out.append(_strategy_cand("scal",
                                          {"block": b, "vector": w}, shape))
    return _dedup(out)


def matmul_space(m: int, k: int, n: int,
                 tiles: Sequence[int] = MXU_TILES) -> List[Candidate]:
    shape = {"m": m, "k": k, "n": n}
    out = []
    bms = _divides(tuple(tiles) + (min(128, m),), m)
    bks = _divides(tuple(tiles) + (min(128, k),), k)
    for bm in bms:
        for bk in bks:
            out.append(_strategy_cand("matmul", {"bm": bm, "bk": bk}, shape))
    return _dedup(out)


def rmsnorm_space(rows: int, d: int, eps: float = 1e-6,
                  row_blocks: Sequence[int] = ROW_BLOCKS) -> List[Candidate]:
    shape = {"rows": rows, "d": d, "eps": eps}
    return _dedup([
        _strategy_cand("rmsnorm", {"row_block": rb}, shape)
        for rb in _divides(tuple(row_blocks) + (rows,), rows)])


def softmax_space(rows: int, d: int,
                  row_blocks: Sequence[int] = ROW_BLOCKS) -> List[Candidate]:
    shape = {"rows": rows, "d": d}
    return _dedup([
        _strategy_cand("softmax", {"row_block": rb}, shape)
        for rb in _divides(tuple(row_blocks) + (rows,), rows)])


def legacy_candidate(kernel: str, params: Dict[str, object],
                     **shape) -> Candidate:
    """The pre-strategy-language hand-built candidate for a params dict —
    the oracle ``tests/test_strategy.py`` pins the strategy programs
    against (phrase-identical by structural fingerprint)."""
    from repro_torch.kernels import dpia_blas
    if kernel in ("dot", "asum"):
        return _cand(kernel, params, _reduce_builder(
            kernel, shape["n"], params.get("block"),
            params.get("leaf", "vpu")))
    if kernel == "scal":
        return _cand(kernel, params, _scal_builder(
            shape["n"], params.get("block"), params.get("vector")))
    if kernel == "matmul":
        m, k, n = shape["m"], shape["k"], shape["n"]
        bm, bk = int(params["bm"]), int(params["bk"])
        return _cand(kernel, params,
                     lambda: dpia_blas.strategy_matmul(m, k, n, bm=bm, bk=bk))
    if kernel == "rmsnorm":
        rows, d = shape["rows"], shape["d"]
        eps = shape.get("eps", 1e-6)
        rb = int(params["row_block"])
        return _cand(kernel, params,
                     lambda: dpia_blas.strategy_rmsnorm(rows, d, eps, rb))
    if kernel == "softmax":
        rows, d = shape["rows"], shape["d"]
        rb = int(params["row_block"])
        return _cand(kernel, params,
                     lambda: dpia_blas.strategy_softmax(rows, d, rb))
    raise ValueError(f"legacy_candidate: unknown kernel {kernel!r}")


def _dedup(cands: List[Candidate]) -> List[Candidate]:
    seen, out = set(), []
    for c in cands:
        if c.params not in seen:
            seen.add(c.params)
            out.append(c)
    return out


_SPACES = {
    "dot": lambda n: dot_space(n),
    "asum": lambda n: asum_space(n),
    "scal": lambda n: scal_space(n),
    "matmul": lambda m, k, n: matmul_space(m, k, n),
    "rmsnorm": lambda rows, d, eps=1e-6: rmsnorm_space(rows, d, eps),
    "softmax": lambda rows, d: softmax_space(rows, d),
}


def enumerate_space(kernel: str, **shape) -> List[Candidate]:
    """All strategy candidates for a named kernel at a concrete shape."""
    try:
        mk = _SPACES[kernel]
    except KeyError:
        raise ValueError(
            f"enumerate_space: unknown kernel {kernel!r}; "
            f"known: {sorted(_SPACES)}") from None
    return mk(**shape)


def default_params(kernel: str, **shape) -> Dict[str, object]:
    """The un-tuned strategy each kernel ships with (the op layer's
    defaults: ``repro_torch.kernels.ops.default_params`` is this)."""
    if kernel in ("dot", "asum"):
        n = shape["n"]
        b = 2048 if n % 2048 == 0 else max(_divides(SPLIT_BLOCKS + (n,), n))
        return {"block": b, "leaf": "vpu"}
    if kernel == "scal":
        n = shape["n"]
        b = 2048 if n % 2048 == 0 else max(_divides(SPLIT_BLOCKS + (n,), n))
        return {"block": b, "vector": None}
    if kernel == "matmul":
        m, k = shape["m"], shape["k"]
        return {"bm": min(128, m), "bk": min(128, k)}
    if kernel == "rmsnorm":
        rows = shape["rows"]
        return {"row_block": 8 if rows % 8 == 0 else 1}
    if kernel == "softmax":
        rows = shape["rows"]
        return {"row_block": 8 if rows % 8 == 0 else 1}
    raise ValueError(f"default_params: unknown kernel {kernel!r}")


def candidate_from_params(kernel: str, params: Dict[str, object],
                          **shape) -> Candidate:
    """Rebuild the Candidate a cached/tuned params dict describes."""
    for c in enumerate_space(kernel, **shape):
        if c.params_dict == params:
            return c
    # params outside the enumerated menu (e.g. hand-edited cache): build
    # directly where the vocabulary allows it.
    if kernel in ("dot", "asum"):
        return _cand(kernel, params, _reduce_builder(
            kernel, shape["n"], params.get("block"),
            params.get("leaf", "vpu")))
    if kernel == "scal":
        return _cand(kernel, params, _scal_builder(
            shape["n"], params.get("block"), params.get("vector")))
    if kernel in ("matmul", "rmsnorm", "softmax"):
        # the strategy programs are shape-independent: side conditions are
        # checked at apply time, so off-menu (hand-edited) params still build
        return _strategy_cand(kernel, dict(params), dict(shape))
    raise ValueError(
        f"candidate_from_params: {kernel} has no candidate {params!r}")


def strategy_candidates(kernel: str, strategies, *,
                        expr: Optional[Expr] = None,
                        arg_vars: Optional[List[P.Var]] = None,
                        **shape) -> List[Candidate]:
    """Candidates from explicit ``repro_torch.strategy`` programs (tune's
    ``strategies=`` path).

    Each program is applied to the kernel's naive spec (or to ``expr`` when
    given); programs that fail on the term are dropped.  The identity is
    prepended so the spec itself is always in the race.  Params are
    ``{"strategy": name}`` — such tuned records replay via their recorded
    ``strategy_trace`` rather than through ``candidate_from_params``."""
    from repro_torch import strategy as strategy_mod
    if expr is not None:
        if arg_vars is None:
            raise ValueError("strategy_candidates: arg_vars required with "
                             "an explicit expr")
        spec = lambda: (expr, arg_vars)  # noqa: E731
    else:
        spec = strategy_mod.spec_builder(kernel, **shape)
    progs = [("id", strategy_mod.id_())]
    for i, s in enumerate(strategies):
        if not isinstance(s, strategy_mod.Strategy):
            raise TypeError(f"strategy_candidates: candidate {i} is not a "
                            f"Strategy: {type(s).__name__}")
        progs.append((s.name, s))
    out, seen = [], set()
    for name, prog in progs:
        e0, argv = spec()
        res = prog.apply(e0)
        if not res.ok:
            continue
        from repro_torch.strategy import traverse as traverse_mod
        fp = traverse_mod.fingerprint(res.phrase)
        if fp in seen:
            continue
        seen.add(fp)
        out.append(Candidate(
            kernel, (("strategy", name),),
            (lambda prog=prog: _apply_or_raise(prog, spec)),
            strategy=prog, spec=spec))
    return out


def _apply_or_raise(prog, spec):
    e0, argv = spec()
    res = prog.apply(e0)
    if not res.ok:
        raise ValueError(f"strategy {prog.name} failed: {res.reason}")
    return res.phrase, argv


# ---------------------------------------------------------------------------
# generic, expression-driven enumeration (tune(expr, ...) path)
# ---------------------------------------------------------------------------

def rewrite_candidates(expr: Expr, arg_vars: List[P.Var],
                       blocks: Sequence[int] = SPLIT_BLOCKS
                       ) -> List[Candidate]:
    """Candidates for an arbitrary functional expression, derived by applying
    the rewrite rules to ``expr`` itself.  Ill-typed rewrites (a side
    condition not met) are dropped via the DPIA type checker."""
    def const(e):
        return lambda: (e, arg_vars)

    out = [_cand("expr", {"rewrite": "id"}, const(expr))]

    def admit(params: Dict[str, object], e: Expr) -> None:
        try:
            P.type_of(e)
        except P.DpiaTypeError:
            return
        out.append(_cand("expr", params, const(e)))

    if isinstance(expr, P.Reduce):
        d = P.exp_data(expr.e)
        if isinstance(d, Arr):
            fused = None
            if isinstance(expr.e, P.Map):
                try:
                    fused = strategies.fuse_map_into_reduce(expr)
                except AssertionError:            # pragma: no cover
                    fused = None
            base = fused if fused is not None else expr
            combine = (lambda x, a: expr.f(x, a)) if fused is not None else None
            for b in _divides(tuple(blocks) + (d.n,), d.n):
                try:
                    blocked = strategies.blocked_reduce(
                        base, b, partial_level=P.GRID(0), combine=combine)
                except AssertionError:
                    continue
                admit({"rewrite": "blocked_reduce", "block": b,
                       "fused": fused is not None}, blocked)
    elif isinstance(expr, P.Map):
        d = P.exp_data(expr.e)
        if isinstance(d, Arr):
            for b in _divides(tuple(blocks) + (d.n,), d.n):
                blocked = strategies.split_join(expr, b)
                assert isinstance(blocked, P.Join)
                inner = blocked.e
                assert isinstance(inner, P.Map)
                grid = P.Join(P.Map(inner.f, inner.e, level=P.GRID(0)))
                admit({"rewrite": "split_join", "block": b}, grid)
            if isinstance(d.elem, Num):
                for w in LANE_WIDTHS:
                    if d.n % w == 0:
                        try:
                            vec = strategies.vectorize(expr, w)
                        except AssertionError:
                            continue
                        admit({"rewrite": "vectorize", "vector": w}, vec)
    return _dedup(out)


def expr_signature(expr: Expr) -> str:
    """Stable structural signature of an expression (persistent-cache key for
    the tune(expr) path).  Binders are instantiated with depth-indexed names
    so the signature is identical across processes."""
    parts: List[str] = []

    def go(p: Expr, depth: int) -> None:
        name = type(p).__name__
        if isinstance(p, P.Var):
            parts.append(f"var:{p.name}:{p.t}")
            return
        if isinstance(p, P.Lit):
            parts.append(f"lit:{p.value}:{show_data(p.d)}")
            return
        if isinstance(p, P.Map):
            parts.append(f"map:{p.level}:{p.space}")
            d = P.exp_data(p.e)
            elem = d.elem if isinstance(d, Arr) else d
            go(p.f(P.Var(f"_b{depth}", P.ExpT(elem))), depth + 1)
            go(p.e, depth)
            return
        if isinstance(p, P.Reduce):
            parts.append(f"reduce:{p.level}")
            d = P.exp_data(p.e)
            elem = d.elem if isinstance(d, Arr) else d
            x = P.Var(f"_b{depth}", P.ExpT(elem))
            a = P.Var(f"_a{depth}", P.ExpT(P.exp_data(p.init)))
            go(p.f(x, a), depth + 2)
            go(p.init, depth)
            go(p.e, depth)
            return
        if isinstance(p, (P.UnOp, P.BinOp, P.FullReduce)):
            parts.append(f"{name}:{p.op}")
        elif isinstance(p, (P.Split, P.AsVector)):
            parts.append(f"{name}:{getattr(p, 'n', None) or getattr(p, 'w', '')}")
        else:
            parts.append(name)
        for fname in ("e", "a", "b", "i"):
            sub = getattr(p, fname, None)
            if isinstance(sub, P.Phrase):
                go(sub, depth)

    go(expr, 0)
    sig = ";".join(parts)
    return hashlib.sha1(sig.encode()).hexdigest()[:12]


# ---------------------------------------------------------------------------
# compat: the seed's dot-only parameter grid (repro_torch.core.dpia.strategies)
# ---------------------------------------------------------------------------

def dot_param_grid(n: int, blocks: Iterable[int] = (256, 1024, 2048),
                   lanes: Iterable[int] = (128,)) -> List[dict]:
    """The seed's ``enumerate_dot_strategies`` output format, preserved."""
    out = []
    for b in blocks:
        if n % b:
            continue
        out.append({"block": b, "vector": None})
        for w in lanes:
            if b % w == 0:
                out.append({"block": b, "vector": w})
    return out
