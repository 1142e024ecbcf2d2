"""Stage III (CUDA backend): grid-level imperative DPIA -> generated CUDA C++.

K4 of the port.  Replaces the Pallas TPU generator
``repro.core.dpia.stage3_pallas.compile_expr_pallas`` (``_run_kernel_stage``,
``_exec_kernel``, ``exec_host``) and goes back to the paper's own target:
where the paper's Fig. 6 translation emitted OpenCL, this emits CUDA C++ for
``sm_90a``, one source per program, built by ``kernels._build`` and bound
with ctypes.

The command it takes is prepared exactly as the Pallas path prepares it:
Stage I -> II, the SCIR race check, then ``hoist(spaces=(HBM,))`` (paper
section 6.4).  The host part of that command is walked in order:

  * a top-level grid-level (``grid``/``par``) ``parfor`` nest, peeled as
    ``_collect_grid`` peels it, becomes ONE ``__global__`` kernel whose CUDA
    grid is exactly the nest's extents: one CUDA block per grid index
    (strategy preservation, made checkable through :attr:`Plan.stages`);
  * the commands between two grid stages that hold no grid ``parfor`` (the
    ``SEQ`` combine of ``strategy_asum`` / ``strategy_dot``) become one
    kernel of ONE block, run on the card in the order the strategy says;
  * a top-level ``new`` is a host allocation (``torch.zeros`` on the
    device): the hoisted HBM temporaries.  With the launches, it is the only
    host work.

Inside a kernel (simple and right, not fast):

  * every statement is executed by the whole block; an assignment of an
    array value is a thread-strided loop over its elements followed by
    ``__syncthreads()`` (the whole-block "lanes" reading of the VPU ops);
  * acceptor paths and views (split/join/zip/transpose/asVector/asScalar,
    idx) become index arithmetic on the element's multi-index (Fig. 6b);
    pairs are struct-of-arrays, one pointer per leaf;
  * ``fullReduce`` is a block tree reduction (warp shuffles, then shared
    memory) into a shared scalar; ``dotBlock`` is computed into a block-local
    buffer first: a block reduction for a dot, one warp per row for a
    matrix-vector product, one thread per output for a matrix product, all
    accumulating in fp32 over k;
  * ``new`` (any space) inside a kernel and those temporaries get block-local
    buffers: shared memory while the block's total fits the 227 KB budget
    (dynamic shared memory, opted in above 48 KB), else a per-block slice of
    a global scratch the host wrapper allocates.  ``new`` zero-initialises,
    as in the reference semantics;
  * ``for`` is a C loop; an inner ``parfor`` runs sequentially in-kernel, as
    the Pallas generator does;
  * an assignment whose value reads its own destination at another element
    than the one it writes is staged through a temporary.

Only ``float32`` data is emitted; other dtypes and ``MESH`` levels raise
``NotImplementedError``.  Scalars such as ``alpha`` are passed as 1-element
device tensors, as the Pallas path reshapes them to ``(1,)``.

Dispatch follows the tensors: on CUDA tensors the compiled program launches
its kernels (building the source on first use) or raises; on CPU tensors it
runs its hoisted command through :mod:`.stage3_torch`, the plain version,
and counts no launch.  Code generation is pure Python and runs anywhere.
Registered as backend ``"cuda"`` (alias ``"dpia-cuda"``).

What bounds the generated kernels on the card: the strategies are the
reference's, shaped for the TPU, so most stages are bound by too few blocks
or by a large accumulator kept in global scratch rather than by bytes or
FLOPs (PERF.md has the numbers).
"""
from __future__ import annotations

import ctypes
import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from . import phrases as P
from . import stage2
from .types import (AccT, Arr, DataType, ExpT, Idx, Num, Pair, VarT, Vec,
                    scalar_of, shape_of)

THREADS = 256                       # threads per block, every stage
SMEM_BUDGET = 232448                # bytes of shared memory a block may use
SMEM_STATIC_LIMIT = 48 * 1024       # above this, opt in to dynamic smem
FST, SND = "f", "s"

launches = 0                        # kernel launches, all generated programs

_MESH_MSG = ("MESH levels are not emitted by the CUDA generator; mesh "
             "strategies come with the port's mesh slice (ROADMAP.md, queue "
             "1: mesh and sharded serving)")


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@dataclass
class Stage:
    """One generated kernel and how it is launched."""
    index: int
    kind: str                         # "grid" (a parfor nest) | "single"
    grid: Tuple[int, ...]             # CUDA grid extents (x, y, z order)
    threads: int
    smem_bytes: int                   # dynamic shared memory per block
    scratch_bytes_per_block: int      # global scratch per block

    @property
    def kernel(self) -> str:
        return f"dpia_stage{self.index}"

    @property
    def blocks(self) -> int:
        return math.prod(self.grid)

    @property
    def scratch_bytes(self) -> int:
        return self.scratch_bytes_per_block * self.blocks


@dataclass
class _Buf:
    """A buffer the kernels see: one C pointer and shape per pair leaf."""
    name: str
    d: DataType
    leaves: Dict[Tuple[str, ...], Tuple[str, Tuple[int, ...]]]


@dataclass
class Plan:
    """What a program compiles to: its stages, source and host buffers."""
    name: str
    stages: List[Stage]
    source: str
    args: List[Tuple[str, DataType]]
    out: Tuple[str, DataType]
    host: List[Tuple[str, DataType]]  # hoisted HBM temporaries, in order
    scratch_bytes: int = 0            # the one scratch all stages share
    params: List[str] = field(default_factory=list)

    @property
    def grids(self) -> List[Tuple[int, ...]]:
        return [s.grid for s in self.stages]


def leaves(d: DataType, comps: Tuple[str, ...] = ()
           ) -> List[Tuple[Tuple[str, ...], Tuple[int, ...]]]:
    """(pair path, shape) of every leaf of a buffer of type ``d``."""
    if isinstance(d, (Num, Idx)):
        return [(comps, ())]
    if isinstance(d, Vec):
        return [(comps, (d.n,))]
    if isinstance(d, Arr):
        return [(c, (d.n,) + s) for c, s in leaves(d.elem, comps)]
    if isinstance(d, Pair):
        return leaves(d.fst, comps + (FST,)) + leaves(d.snd, comps + (SND,))
    raise TypeError(d)


# ---------------------------------------------------------------------------
# phrase walks: levels, dtypes, grid detection
# ---------------------------------------------------------------------------

def _children(q: P.Phrase):
    """Sub-phrases of ``q``, binders instantiated with fresh variables."""
    for attr in ("e", "a", "b", "i", "v", "c1", "c2", "init", "acc", "exp"):
        c = getattr(q, attr, None)
        if isinstance(c, P.Phrase):
            yield c
    if isinstance(q, P.New):
        yield q.f(P.Var(P.fresh("v"), VarT(q.d)))
    elif isinstance(q, P.For):
        yield q.f(P.Var(P.fresh("i"), ExpT(Idx(q.n))))
    elif isinstance(q, P.ParFor):
        yield q.f(P.Var(P.fresh("i"), ExpT(Idx(q.n))),
                  P.Var(P.fresh("o"), AccT(q.d)))
    elif isinstance(q, (P.MapI, P.ReduceI)):
        yield stage2.expand(q)
    elif isinstance(q, P.Map):
        d = P.exp_data(q.e)
        yield q.f(P.Var(P.fresh("x"), ExpT(d.elem)))
    elif isinstance(q, P.Reduce):
        d = P.exp_data(q.e)
        yield q.f(P.Var(P.fresh("x"), ExpT(d.elem)),
                  P.Var(P.fresh("acc"), P.type_of(q.init)))


def _walk(p: P.Phrase):
    stack = [p]
    while stack:
        q = stack.pop()
        yield q
        stack.extend(_children(q))


def _check_f32(d: DataType, what: str) -> None:
    if isinstance(d, Num) and d.dtype != "float32" or \
            isinstance(d, Vec) and d.dtype != "float32":
        raise NotImplementedError(
            f"the CUDA generator emits float32 only; {what} has "
            f"{d.dtype}")
    if isinstance(d, Idx):
        return
    if isinstance(d, Arr):
        _check_f32(d.elem, what)
    elif isinstance(d, Pair):
        _check_f32(d.fst, what)
        _check_f32(d.snd, what)


def check_supported(cmd: P.Phrase, arg_vars, out: P.Var) -> None:
    """Raise NotImplementedError for what the generator does not emit:
    MESH levels and data other than float32."""
    for v in arg_vars:
        if isinstance(scalar_of(v.t.d), Idx):
            raise NotImplementedError(
                f"the CUDA generator emits float32 only; argument "
                f"{v.name!r} holds indices")
        _check_f32(v.t.d, f"argument {v.name!r}")
    _check_f32(out.t.d, "the output")
    for q in _walk(cmd):
        if isinstance(q, (P.ParFor, P.MapI)) and q.level.kind == "mesh":
            raise NotImplementedError(_MESH_MSG)
        if isinstance(q, P.New):
            _check_f32(q.d, "a new")
        elif isinstance(q, P.Lit):
            _check_f32(q.d, "a literal")
        elif isinstance(q, P.DotBlock) and q.acc_dtype != "float32":
            raise NotImplementedError(
                f"the CUDA generator emits float32 only; dotBlock "
                f"accumulates in {q.acc_dtype}")


def _is_grid(p: P.Phrase) -> bool:
    return isinstance(p, P.ParFor) and p.level.kind in ("grid", "par")


def _has_grid(p: P.Phrase) -> bool:
    return any(_is_grid(q) or isinstance(q, P.MapI)
               and q.level.kind in ("grid", "par") for q in _walk(p))


def collect_grid(pf: P.ParFor):
    """Peel nested grid parfors, as the Pallas generator's ``_collect_grid``:
    returns (extents, index Vars, body with each acceptor parameter bound to
    its slice of the parfor's acceptor)."""
    dims: List[int] = []
    ivars: List[P.Var] = []
    node: P.Phrase = pf
    while _is_grid(node):
        i = P.Var(P.fresh("g"), ExpT(Idx(node.n)))
        dims.append(node.n)
        ivars.append(i)
        node = node.f(i, P.IdxAcc(node.a, i))
    return dims, ivars, node


# ---------------------------------------------------------------------------
# C code emission for one kernel body
# ---------------------------------------------------------------------------

def _flit(v: float) -> str:
    if math.isnan(v):
        return "NAN"
    if math.isinf(v):
        return "INFINITY" if v > 0 else "(-INFINITY)"
    return f"{float(v).hex()}f" if v != 0 else "0.0f"


_UNOPS = {"neg": "(-({}))", "exp": "expf({})", "log": "logf({})",
          "abs": "fabsf({})", "rsqrt": "rsqrtf({})", "tanh": "tanhf({})",
          "sigmoid": "dpia_sigmoid({})"}
_BINOPS = {"add": "({} + {})", "sub": "({} - {})", "mul": "({} * {})",
           "div": "({} / {})", "max": "fmaxf({}, {})", "min": "fminf({}, {})"}


def _offset(idx: Sequence[str], shape: Tuple[int, ...]) -> str:
    """Row-major offset of a multi-index into a dense leaf of ``shape``."""
    if len(idx) != len(shape):
        raise AssertionError(f"index {list(idx)} for shape {shape}")
    off = ""
    for k, (i, n) in enumerate(zip(idx, shape)):
        off = f"({i})" if k == 0 else f"({off}) * {n} + ({i})"
    return off or "0"


class _Arena:
    """Stack allocator (in floats) that remembers its high-water mark."""

    def __init__(self):
        self.top = 0
        self.high = 0

    def alloc(self, n: int) -> int:
        off = self.top
        self.top += n
        self.high = max(self.high, self.top)
        return off


class _KernelGen:
    """Emits the body of one ``__global__`` kernel."""

    def __init__(self, buffers: Dict[str, _Buf]):
        self.buffers = dict(buffers)
        self.lines: List[str] = []
        self.depth = 1
        self.ivars: Dict[str, str] = {}
        self.smem = _Arena()
        self.scratch = _Arena()
        self.n = 0
        self.temps: Dict[P.Phrase, Tuple[str, Tuple[int, ...]]] = {}
        self.loads: List[Tuple[str, Tuple[str, ...], str]] = []

    # -- helpers ------------------------------------------------------------

    def emit(self, line: str) -> None:
        self.lines.append("  " * self.depth + line)

    def name(self, prefix: str) -> str:
        self.n += 1
        return f"{prefix}{self.n}"

    def local(self, nfloats: int, force_global: bool = False) -> str:
        """A block-local buffer of ``nfloats``: shared memory while the
        block's total fits the budget, else the block's global scratch."""
        # the budget less the static reduction buffer ``red``
        if not force_global and (self.smem.top + nfloats) * 4 \
                <= SMEM_BUDGET - 4 * (THREADS // 32):
            return f"(smem + {self.smem.alloc(nfloats)})"
        return f"(scratch_b + {self.scratch.alloc(nfloats)})"

    def mark(self):
        return self.smem.top, self.scratch.top

    def release(self, mark) -> None:
        self.smem.top, self.scratch.top = mark

    def decompose(self, t: str, shape: Tuple[int, ...]) -> List[str]:
        """Emit the multi-index of flat position ``t`` in ``shape``."""
        idx = []
        stride = math.prod(shape)
        for n in shape:
            stride //= n
            j = self.name("j")
            self.emit(f"const int {j} = ({t} / {stride}) % {n};"
                      if stride > 1 else f"const int {j} = {t} % {n};")
            idx.append(j)
        return idx

    def strided(self, n: int) -> str:
        t = self.name("t")
        self.emit(f"for (int {t} = threadIdx.x; {t} < {n}; "
                  f"{t} += {THREADS}) {{")
        self.depth += 1
        return t

    def close(self) -> None:
        self.depth -= 1
        self.emit("}")

    # -- indices --------------------------------------------------------------

    def index(self, i: P.Phrase) -> str:
        if isinstance(i, P.Var):
            if i.name in self.ivars:
                return self.ivars[i.name]
            raise NotImplementedError(f"index {i.name!r} is not a loop index")
        if isinstance(i, P.Lit):
            return str(int(i.value))
        if isinstance(i, P.BinOp) and i.op in ("add", "sub", "mul", "div"):
            sym = {"add": "+", "sub": "-", "mul": "*", "div": "/"}[i.op]
            return f"({self.index(i.a)} {sym} {self.index(i.b)})"
        raise NotImplementedError(
            f"index expression {type(i).__name__} is not emitted")

    # -- r-values: one element of an expression (Fig. 6c) ----------------------

    def load(self, name: str, idx: List[str], comps: Tuple[str, ...]) -> str:
        buf = self.buffers[name]
        if comps not in buf.leaves:
            raise TypeError(f"read of {name!r} at pair path {comps} is not a "
                            f"leaf")
        ptr, shape = buf.leaves[comps]
        off = _offset(idx, shape)
        self.loads.append((name, comps, off))
        return f"{ptr}[{off}]"

    def elem(self, e: P.Phrase, idx: List[str],  # noqa: C901
             comps: Tuple[str, ...] = ()) -> str:
        """C expression of the element of ``e`` at ``idx`` (pair path
        ``comps``)."""
        if e in self.temps:
            ptr, shape = self.temps[e]
            return f"{ptr}[{_offset(idx, shape)}]"
        if isinstance(e, P.Var):
            if isinstance(e.t.d, Idx):
                return f"((float){self.index(e)})"
            return self.load(e.name, idx, comps)
        if isinstance(e, P.ExpPart):
            if isinstance(e.v, P.VView):
                return self.elem(e.v.exp, idx, comps)
            return self.load(e.v.name, idx, comps)
        if isinstance(e, P.Lit):
            return _flit(e.value)
        if isinstance(e, P.UnOp):
            return _UNOPS[e.op].format(self.elem(e.e, idx, comps))
        if isinstance(e, P.BinOp):
            ops = []
            for x in (e.a, e.b):
                scalar = isinstance(P.exp_data(x), (Num, Idx))
                ops.append(self.elem(x, [] if scalar else idx, comps))
            return _BINOPS[e.op].format(*ops)
        if isinstance(e, P.IdxE):
            return self.elem(e.e, [self.index(e.i)] + idx, comps)
        if isinstance(e, P.Split):
            i, j, *rest = idx
            return self.elem(e.e, [f"({i}) * {e.n} + ({j})"] + rest, comps)
        if isinstance(e, P.Join):
            m = P.exp_data(e.e).elem.n
            j, *rest = idx
            return self.elem(e.e, [f"({j}) / {m}", f"({j}) % {m}"] + rest,
                             comps)
        if isinstance(e, P.Transpose):
            i, j, *rest = idx
            return self.elem(e.e, [j, i] + rest, comps)
        if isinstance(e, P.AsVector):
            i, j, *rest = idx
            return self.elem(e.e, [f"({i}) * {e.w} + ({j})"] + rest, comps)
        if isinstance(e, P.AsScalar):
            w = P.exp_data(e.e).elem.n
            j, *rest = idx
            return self.elem(e.e, [f"({j}) / {w}", f"({j}) % {w}"] + rest,
                             comps)
        if isinstance(e, (P.Zip, P.PairE)):
            if not comps:
                raise TypeError("a pair value used as a number")
            return self.elem(e.a if comps[0] == FST else e.b, idx, comps[1:])
        if isinstance(e, P.Fst):
            return self.elem(e.e, idx, (FST,) + comps)
        if isinstance(e, P.Snd):
            return self.elem(e.e, idx, (SND,) + comps)
        if isinstance(e, P.ToMem):
            return self.elem(e.e, idx, comps)
        raise NotImplementedError(
            f"expression {type(e).__name__} is not emitted in a kernel")

    # -- l-values: the destination element (Fig. 6b) --------------------------

    def dest(self, a: P.Phrase, idx: List[str],  # noqa: C901
             comps: Tuple[str, ...]) -> Tuple[str, Tuple[str, ...], str]:
        """(root name, pair path, offset) an acceptor writes at ``idx``."""
        if isinstance(a, P.Var):
            return self._root(a.name, idx, comps)
        if isinstance(a, P.AccPart):
            if isinstance(a.v, P.VView):
                return self.dest(a.v.acc, idx, comps)
            return self._root(a.v.name, idx, comps)
        if isinstance(a, P.IdxAcc):
            return self.dest(a.a, [self.index(a.i)] + idx, comps)
        if isinstance(a, P.SplitAcc):          # self (m*n).d, inner m.n.d
            j, *rest = idx
            return self.dest(a.a, [f"({j}) / {a.n}", f"({j}) % {a.n}"] + rest,
                             comps)
        if isinstance(a, P.JoinAcc):           # self k.m.d, inner (k*m).d
            i, j, *rest = idx
            return self.dest(a.a, [f"({i}) * {a.m} + ({j})"] + rest, comps)
        if isinstance(a, P.TransposeAcc):
            i, j, *rest = idx
            return self.dest(a.a, [j, i] + rest, comps)
        if isinstance(a, (P.PairAcc1, P.ZipAcc1)):
            return self.dest(a.a, idx, (FST,) + comps)
        if isinstance(a, (P.PairAcc2, P.ZipAcc2)):
            return self.dest(a.a, idx, (SND,) + comps)
        if isinstance(a, P.AsScalarAcc):       # self (m*w).num, inner m.<w>
            w = P.acc_data(a.a).elem.n
            j, *rest = idx
            return self.dest(a.a, [f"({j}) / {w}", f"({j}) % {w}"] + rest,
                             comps)
        if isinstance(a, P.AsVectorAcc):       # self m.<w>, inner (m*w).num
            i, j, *rest = idx
            return self.dest(a.a, [f"({i}) * {a.w} + ({j})"] + rest, comps)
        raise NotImplementedError(
            f"acceptor {type(a).__name__} is not emitted in a kernel")

    def _root(self, name, idx, comps):
        buf = self.buffers[name]
        if comps not in buf.leaves:
            raise TypeError(f"write to {name!r} at pair path {comps} is not a "
                            f"leaf")
        return name, comps, _offset(idx, buf.leaves[comps][1])

    # -- values that need the whole block first: fullReduce, dotBlock ---------

    def materialise(self, e: P.Phrase) -> None:
        """Compute every fullReduce / dotBlock under ``e`` (innermost first)
        into block-local temporaries that :meth:`elem` then reads."""
        if e in self.temps or isinstance(e, (P.Var, P.Lit)):
            return
        for attr in ("e", "a", "b"):
            c = getattr(e, attr, None)
            if isinstance(c, P.Phrase):
                self.materialise(c)
        if isinstance(e, P.FullReduce):
            self._full_reduce(e)
        elif isinstance(e, P.DotBlock):
            self._dot_block(e)

    def _block_reduce(self, op: str, n: int, term) -> str:
        """Emit a block reduction of ``term(t)`` over ``n`` elements into a
        shared scalar; returns the scalar's pointer."""
        r = self.name("r")
        init = "0.0f" if op == "add" else "(-INFINITY)"
        self.emit(f"float {r} = {init};")
        t = self.strided(n)
        v = term(t)
        self.emit(f"{r} = {r} + {v};" if op == "add"
                  else f"{r} = fmaxf({r}, {v});")
        self.close()
        fn = "dpia_block_sum" if op == "add" else "dpia_block_max"
        self.emit(f"{r} = {fn}({r}, red);")
        ptr = self.local(1)
        self.emit(f"if (threadIdx.x == 0) {ptr}[0] = {r};")
        self.emit("__syncthreads();")
        return ptr

    def _full_reduce(self, e: P.FullReduce) -> None:
        shape = shape_of(P.exp_data(e.e))
        self.emit("{")
        self.depth += 1
        ptr = self._block_reduce(
            e.op, math.prod(shape),
            lambda t: self.elem(e.e, self.decompose(t, shape)))
        self.close()
        self.temps[e] = (ptr, ())

    def _dot_block(self, e: P.DotBlock) -> None:
        sa, sb = shape_of(P.exp_data(e.a)), shape_of(P.exp_data(e.b))
        self.emit("{")
        self.depth += 1
        kk = self.name("k")
        if len(sa) == 1:                                  # (k,).(k,) -> num
            ptr = self._block_reduce(
                "add", sa[0],
                lambda t: f"{self.elem(e.a, [t])} * {self.elem(e.b, [t])}")
            self.close()
            self.temps[e] = (ptr, ())
            return
        n, k = sa
        if len(sb) == 1:                 # (n,k).(k,) -> (n,): a warp per row
            out = self.local(n)
            row, s = self.name("row"), self.name("s")
            self.emit(f"for (int {row} = threadIdx.x / 32; {row} < {n}; "
                      f"{row} += {THREADS // 32}) {{")
            self.depth += 1
            self.emit(f"float {s} = 0.0f;")
            self.emit(f"for (int {kk} = threadIdx.x % 32; {kk} < {k}; "
                      f"{kk} += 32)")
            self.emit(f"  {s} += {self.elem(e.a, [row, kk])} * "
                      f"{self.elem(e.b, [kk])};")
            self.emit(f"{s} = dpia_warp_sum({s});")
            self.emit(f"if (threadIdx.x % 32 == 0) {out}[{row}] = {s};")
            self.close()
            shape = (n,)
        else:                        # (n,k).(k,m) -> (n,m): a thread per output
            m = sb[1]
            out = self.local(n * m)
            t = self.strided(n * m)
            i, j = self.decompose(t, (n, m))
            s = self.name("s")
            self.emit(f"float {s} = 0.0f;")
            self.emit(f"for (int {kk} = 0; {kk} < {k}; ++{kk})")
            self.emit(f"  {s} += {self.elem(e.a, [i, kk])} * "
                      f"{self.elem(e.b, [kk, j])};")
            self.emit(f"{out}[{t}] = {s};")
            self.close()
            shape = (n, m)
        self.emit("__syncthreads();")
        self.close()
        self.temps[e] = (out, shape)

    # -- commands -------------------------------------------------------------

    def comm(self, p: P.Phrase) -> None:  # noqa: C901
        if isinstance(p, P.Skip):
            return
        if isinstance(p, P.SeqC):
            self.comm(p.c1)
            self.comm(p.c2)
        elif isinstance(p, P.Assign):
            self.assign(p.a, p.e)
        elif isinstance(p, P.New):
            self.new(p)
        elif isinstance(p, P.For):
            i = P.Var(P.fresh("i"), ExpT(Idx(p.n)))
            self.loop(p.n, i, p.f(i), unroll=p.unroll)
        elif isinstance(p, P.ParFor):
            # a parfor below the grid runs sequentially in the block (the
            # strategy put it below the grid level on purpose)
            i = P.Var(P.fresh("i"), ExpT(Idx(p.n)))
            self.loop(p.n, i, p.f(i, P.IdxAcc(p.a, i)))
        elif isinstance(p, (P.MapI, P.ReduceI)):
            self.comm(stage2.expand(p))
        else:
            raise TypeError(f"not a command: {type(p).__name__}")

    def loop(self, n: int, i: P.Var, body: P.Phrase, unroll=False) -> None:
        c = self.name("i")
        self.ivars[i.name] = c
        if unroll:
            self.emit("#pragma unroll")
        self.emit(f"for (int {c} = 0; {c} < {n}; ++{c}) {{")
        self.depth += 1
        self.comm(body)
        self.close()

    def new(self, p: P.New) -> None:
        v = P.Var(P.fresh("kbuf"), VarT(p.d))
        mark = self.mark()
        lv = {}
        for comps, shape in leaves(p.d):
            size = math.prod(shape)
            ptr = self.local(size, force_global=p.space == P.HBM)
            lv[comps] = (ptr, shape)
            t = self.strided(size)
            self.emit(f"{ptr}[{t}] = 0.0f;")
            self.close()
        self.emit("__syncthreads();")
        self.buffers[v.name] = _Buf(v.name, p.d, lv)
        self.comm(p.f(v))
        del self.buffers[v.name]
        self.release(mark)

    def _reads_other_elements(self, a, e, shape, comps) -> bool:
        """Does the value read its destination at another element than the
        one it writes (then the write must wait for every read)?"""
        lines, self.lines, self.loads = self.lines, [], []
        idx = self.decompose("t", shape)
        root, rc, off = self.dest(a, idx, comps)
        self.elem(e, idx, comps)
        self.lines = lines
        return any(name == root and c == rc and o != off
                   for name, c, o in self.loads)

    def assign(self, a: P.Phrase, e: P.Phrase) -> None:
        mark = self.mark()
        self.temps = {}
        self.materialise(e)
        for comps, shape in leaves(P.acc_data(a)):
            n = math.prod(shape)
            staged = self._reads_other_elements(a, e, shape, comps)
            if staged:
                tmp = self.local(n)
                t = self.strided(n)
                self.emit(f"{tmp}[{t}] = "
                          f"{self.elem(e, self.decompose(t, shape), comps)};")
                self.close()
                self.emit("__syncthreads();")
            t = self.strided(n)
            idx = self.decompose(t, shape)
            root, rc, off = self.dest(a, idx, comps)
            value = f"{tmp}[{t}]" if staged else self.elem(e, idx, comps)
            self.emit(f"{self.buffers[root].leaves[rc][0]}[{off}] = {value};")
            self.close()
            self.emit("__syncthreads();")
        self.temps = {}
        self.release(mark)


# ---------------------------------------------------------------------------
# the whole program: host walk, stages, source
# ---------------------------------------------------------------------------

_PRELUDE = r"""// Generated by repro_torch.core.dpia.stage3_cuda from a lowered DPIA
// strategy: one kernel per top-level grid parfor nest (its CUDA grid is the
// nest's extents), one single-block kernel per run of sequential commands.
#include <cuda_runtime.h>
#include <math.h>

#define DPIA_THREADS %(threads)d

__device__ __forceinline__ float dpia_sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}
__device__ __forceinline__ float dpia_warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float dpia_warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
// Block reductions: the result is valid in thread 0.
__device__ float dpia_block_sum(float v, float* red) {
  v = dpia_warp_sum(v);
  __syncthreads();                       // red is free from its last use
  if (threadIdx.x %% 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = threadIdx.x < DPIA_THREADS / 32 ? red[threadIdx.x] : 0.0f;
  return threadIdx.x < 32 ? dpia_warp_sum(v) : v;
}
__device__ float dpia_block_max(float v, float* red) {
  v = dpia_warp_max(v);
  __syncthreads();
  if (threadIdx.x %% 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = threadIdx.x < DPIA_THREADS / 32 ? red[threadIdx.x] : -INFINITY;
  return threadIdx.x < 32 ? dpia_warp_max(v) : v;
}
"""


def _c_name(name: str, k: int) -> str:
    return f"{re.sub(r'[^A-Za-z0-9_]', '_', name)}_{k}"


class _ProgramGen:
    def __init__(self, name: str, arg_vars, out: P.Var):
        self.name = name
        self.buffers: Dict[str, _Buf] = {}
        self.params: List[Tuple[str, str]] = []      # (C decl, C name)
        self.args = [(v.name, v.t.d) for v in arg_vars]
        self.host: List[Tuple[str, DataType]] = []
        for k, v in enumerate(arg_vars):
            self._buffer(v.name, v.t.d, f"a{k}", const=True)
        self._buffer(out.name, out.t.d, "o", const=False)
        self.out = (out.name, out.t.d)
        self.stages: List[Stage] = []
        self.bodies: List[Tuple[str, int]] = []
        self.segment: List[P.Phrase] = []

    def _buffer(self, name, d, prefix, const):
        lv = {}
        for j, (comps, shape) in enumerate(leaves(d)):
            c = f"{prefix}_{j}"
            self.params.append(
                (f"const float* __restrict__ {c}" if const else f"float* {c}",
                 c))
            lv[comps] = (c, shape)
        self.buffers[name] = _Buf(name, d, lv)

    def walk(self, p: P.Phrase) -> None:
        if not _has_grid(p):
            self.segment.append(p)
        elif _is_grid(p):
            self.flush()
            dims, ivars, body = collect_grid(p)
            if len(dims) > 3 or any(d > 65535 for d in dims[1:]) \
                    or dims[0] >= 2 ** 31:
                raise NotImplementedError(
                    f"grid {dims}: CUDA grids have at most 3 dimensions, "
                    f"y and z below 65536")
            self.stage("grid", tuple(dims), ivars, [body])
        elif isinstance(p, P.SeqC):
            self.walk(p.c1)
            self.walk(p.c2)
        elif isinstance(p, P.New):
            v = P.Var(P.fresh("hbuf"), VarT(p.d))
            self._buffer(v.name, p.d, f"h{len(self.host)}", const=False)
            self.host.append((v.name, p.d))
            self.walk(p.f(v))
        elif isinstance(p, (P.MapI, P.ReduceI)):
            self.walk(stage2.expand(p))
        else:   # e.g. a for around grid parfors: one block, in order
            self.segment.append(p)

    def flush(self) -> None:
        if self.segment:
            self.stage("single", (1,), [], self.segment)
            self.segment = []

    def stage(self, kind, grid, ivars, cmds) -> None:
        k = len(self.stages)
        gen = _KernelGen(self.buffers)
        for axis, iv in enumerate(ivars):
            gen.ivars[iv.name] = f"g{axis}"
            gen.emit(f"const int g{axis} = blockIdx.{'xyz'[axis]};")
        gen.emit("const long blk = blockIdx.x + (long)gridDim.x * "
                 "(blockIdx.y + (long)gridDim.y * blockIdx.z);")
        gen.emit(f"float* scratch_b = scratch + blk * kScratch{k};")
        gen.emit("(void)scratch_b;")
        for c in cmds:
            gen.comm(c)
        st = Stage(k, kind, grid, THREADS, gen.smem.high * 4,
                   gen.scratch.high * 4)
        self.stages.append(st)
        self.bodies.append(("\n".join(gen.lines), gen.scratch.high))

    def render(self, st: Stage, body: str, scratch_floats: int) -> str:
        """The kernel and its C launcher, with the program's final
        parameter list (every stage takes every buffer)."""
        k, smem = st.index, st.smem_bytes
        params = ", ".join([d for d, _ in self.params] + ["float* scratch"])
        gx, gy, gz = (list(st.grid) + [1, 1])[:3]
        void_params = ", ".join(
            [f"void* p{j}" for j in range(len(self.params))]
            + ["void* scratch", "void* stream"])
        casts = ", ".join(
            [f"(const float*)p{j}" if d.startswith("const") else
             f"(float*)p{j}" for j, (d, _) in enumerate(self.params)]
            + ["(float*)scratch"])
        return f"""
// stage {k}: {st.kind}, grid ({gx}, {gy}, {gz}) x {THREADS} threads, \
{smem} B shared, {st.scratch_bytes_per_block} B scratch per block
constexpr long kScratch{k} = {scratch_floats};
__global__ void __launch_bounds__(DPIA_THREADS)
{st.kernel}({params}) {{
  extern __shared__ float smem[];
  __shared__ float red[DPIA_THREADS / 32];
{body}
}}

extern "C" int launch_stage{k}({void_params}) {{
  const size_t smem = {smem};
  if (smem > {SMEM_STATIC_LIMIT}) {{
    cudaError_t e = cudaFuncSetAttribute(
        {st.kernel}, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }}
  {st.kernel}<<<dim3({gx}, {gy}, {gz}), DPIA_THREADS, smem,
      (cudaStream_t)stream>>>({casts});
  return (int)cudaGetLastError();
}}
"""

    def plan(self) -> Plan:
        self.flush()
        source = (_PRELUDE % {"threads": THREADS}) + "".join(
            self.render(st, body, sf)
            for st, (body, sf) in zip(self.stages, self.bodies))
        scratch = max([s.scratch_bytes for s in self.stages] + [0])
        return Plan(self.name, self.stages, source, self.args, self.out,
                    self.host, scratch, [c for _, c in self.params])


def plan_command(cmd: P.Phrase, arg_vars, out: P.Var,
                 name: str = "program") -> Plan:
    """Generate the CUDA plan of a hoisted imperative command."""
    check_supported(cmd, arg_vars, out)
    gen = _ProgramGen(name, arg_vars, out)
    gen.walk(cmd)
    return gen.plan()


# ---------------------------------------------------------------------------
# the compiled program
# ---------------------------------------------------------------------------

class GeneratedProgram:
    """A DPIA program compiled to generated CUDA kernels.

    ``plan`` holds the stages (grid extents, shared memory, scratch) and
    ``source`` the CUDA C++ text; ``launches`` counts this program's kernel
    launches.  Calling it with CUDA tensors builds the source on first use
    (``kernels._build``) and launches every stage in order on the current
    stream; with CPU tensors it runs the hoisted command through
    :mod:`.stage3_torch` (the plain version) and launches nothing."""

    def __init__(self, cmd: P.Phrase, arg_vars, out: P.Var, name: str):
        self.cmd = cmd
        self.arg_vars = list(arg_vars)
        self.out = out
        self.name = re.sub(r"[^A-Za-z0-9_.-]", "_", name)
        self.plan = plan_command(cmd, arg_vars, out, self.name)
        self.source = self.plan.source
        self.launches = 0
        self._fns = None

    @property
    def stages(self) -> List[Stage]:
        return self.plan.stages

    def build(self) -> None:
        """Compile and load the source now (it is cached under build/dpia)."""
        if self._fns is None:
            from ...kernels import _build
            n = len(self.plan.params) + 2
            lib = _build.load_generated(self.name, self.source)
            fns = []
            for st in self.stages:
                fn = getattr(lib, f"launch_stage{st.index}")
                fn.argtypes = [ctypes.c_void_p] * n
                fn.restype = ctypes.c_int
                fns.append(fn)
            self._fns = fns

    def ptxas(self) -> Dict[int, dict]:
        """Registers, spills and static shared memory per stage, from the
        build's ptxas log (built first if needed)."""
        from ...kernels import _build
        return _build.ptxas_report(
            _build.generated_target(self.name, self.source).with_suffix(
                ".log").read_text(), r"dpia_stage(\d+)")

    def __call__(self, *args):
        import torch
        from .stage3_torch import run_command
        tensors = [a for a in _flat(args) if isinstance(a, torch.Tensor)]
        devices = {t.device.type for t in tensors}
        if devices <= {"cpu"}:
            return run_command(self.cmd, self.out.t.d,
                               [v.name for v in self.arg_vars],
                               self.out.name, args)
        if devices != {"cuda"}:
            raise ValueError(f"{self.name}: no kernel for devices "
                             f"{sorted(devices)}")
        return self._launch(args, tensors[0].device)

    def _launch(self, args, device):
        global launches
        import torch

        from ...kernels import _build
        if len(args) != len(self.arg_vars):
            raise TypeError(f"{self.name}: {len(self.arg_vars)} arguments, "
                            f"got {len(args)}")
        ptrs: List[int] = []
        keep = []                    # converted arguments live to the launch
        for v, a in zip(self.arg_vars, args):
            parts = _flat((a,))
            lv = leaves(v.t.d)
            if len(parts) != len(lv):
                raise ValueError(f"{self.name}: argument {v.name!r} has "
                                 f"{len(lv)} leaves, got {len(parts)}")
            for x, (_, shape) in zip(parts, lv):
                if not isinstance(x, torch.Tensor):
                    x = torch.tensor(x, dtype=torch.float32, device=device)
                if x.device != device or x.dtype != torch.float32:
                    raise ValueError(
                        f"{self.name}: argument {v.name!r} is {x.dtype} on "
                        f"{x.device}; the kernels take float32 on {device}")
                if tuple(x.shape) != shape and not (shape == () and
                                                    x.numel() == 1):
                    raise ValueError(f"{self.name}: argument {v.name!r} has "
                                     f"shape {tuple(x.shape)}, want {shape}")
                if not x.is_contiguous():
                    raise ValueError(f"{self.name}: argument {v.name!r} is "
                                     f"not contiguous")
                keep.append(x)
                ptrs.append(x.data_ptr())
        out_leaves = [torch.zeros(shape, dtype=torch.float32, device=device)
                      for _, shape in leaves(self.out.t.d)]
        host = [torch.zeros(shape, dtype=torch.float32, device=device)
                for _, d in self.plan.host for _, shape in leaves(d)]
        scratch = torch.empty(max(1, self.plan.scratch_bytes // 4),
                              dtype=torch.float32, device=device)
        ptrs += [t.data_ptr() for t in out_leaves + host]
        ptrs.append(scratch.data_ptr())
        self.build()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            for st, fn in zip(self.stages, self._fns):
                _build.check(fn(*ptrs, stream),
                             f"{self.name} stage {st.index}")
                self.launches += 1
                launches += 1
        return _unflatten(self.out.t.d, iter(out_leaves))

    def __repr__(self):
        return (f"<GeneratedProgram {self.name!r}: "
                f"{len(self.stages)} stage(s), grids {self.plan.grids}>")


def _flat(args) -> list:
    out = []
    for a in args:
        if isinstance(a, tuple):
            out.extend(_flat(a))
        else:
            out.append(a)
    return out


def _unflatten(d: DataType, it):
    while isinstance(d, Arr):
        d = d.elem
    if isinstance(d, Pair):
        return (_unflatten(d.fst, it), _unflatten(d.snd, it))
    return next(it)


def compile_expr_cuda(expr: P.Phrase, arg_vars, *, check: bool = True,
                      lowered=None, name: Optional[str] = None
                      ) -> GeneratedProgram:
    """Functional expression (or ``lowered`` command) -> generated CUDA
    program.  The command is prepared as ``compile_expr_pallas`` prepares
    it, SCIR check before hoisting; codegen happens here, the build on the
    first CUDA call."""
    from .hoist import hoist
    from .stage3_torch import translate
    cmd, out = translate(expr, check=check, lowered=lowered)
    return GeneratedProgram(hoist(cmd, spaces=(P.HBM,)), arg_vars, out,
                            name or "program")


def build_all(programs: Sequence[GeneratedProgram]) -> float:
    """Build the sources of many programs in one parallel batch (one
    ``nvcc`` each, all started together); returns the seconds it took."""
    from ...kernels import _build
    return _build.build_generated([(p.name, p.source) for p in programs])


# self-register as a Stage III target (see repro_torch.compiler.backends)
from ...compiler.backends import Backend as _Backend  # noqa: E402
from ...compiler.backends import register_backend as _register  # noqa: E402

_register(_Backend(
    name="cuda", compile=compile_expr_cuda,
    accepts=("check", "lowered", "name"),
    description="grid-level imperative DPIA -> generated CUDA C++ kernels "
                "(one CUDA grid per grid parfor; sm_90a)"),
    aliases=("dpia-cuda",), overwrite=True)
