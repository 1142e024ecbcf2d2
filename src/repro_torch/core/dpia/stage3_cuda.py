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

Inside a kernel (PERF.md has what each stage costs on the card):

  * a statement whose destination has one element runs on thread 0 alone
    (:func:`_thread0`); a run of such statements, loops included, is one
    ``if (threadIdx.x == 0) { ... }`` region with no barrier inside.  A
    one-element ``new`` that only thread 0 touches is a register (``float
    v = 0.0f;``).  A global operand that such a loop reads and does not
    write is first copied into shared memory by the whole block, so
    ``strategy_asum``'s SEQ combine is one thread's fold over partials in
    shared memory, in the strategy's order;
  * every other statement is executed by the whole block: an assignment of
    an array value is a thread-strided loop over its elements, each thread
    loading a round of its elements before it stores any
    (:meth:`_KernelGen.batched`);
  * ``__syncthreads()`` goes only where an access conflicts with one that
    other threads made since the last barrier: a read of what they wrote,
    or a write of what they read or wrote (:meth:`_KernelGen.access`;
    storage is told apart by kernel parameter, shared memory and scratch);
    a loop whose body ends in such a conflict with its own beginning ends
    each iteration in a barrier;
  * acceptor paths and views (split/join/zip/transpose/asVector/asScalar,
    idx) become index arithmetic on the element's multi-index (Fig. 6b);
    pairs are struct-of-arrays, one pointer per leaf;
  * ``fullReduce`` is a block tree reduction (warp shuffles, then shared
    memory) whose result stays in thread 0's register when a thread-0
    statement consumes it, else goes through shared memory and a barrier;
    ``dotBlock`` is computed into a block-local buffer first: a block
    reduction for a dot, one warp per row for a matrix-vector product, and
    for a matrix product a register-tiled product through shared memory
    (:meth:`_KernelGen._matmul`: the operand tiles copied with coalesced
    loads, 8 x 8 outputs per thread, each output's k loop one ``fmaf`` a
    step from 0.0f, in order), all accumulating in fp32 over k;
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
``NotImplementedError`` (a mesh term goes to the ``shardmap`` backend,
``core.dpia.stage3_shardmap``, whose ``inner="cuda"`` compiles each
shard's body here).  Scalars such as ``alpha`` are passed as 1-element
device tensors, as the Pallas path reshapes them to ``(1,)``.

Dispatch follows the tensors: on CUDA tensors the compiled program launches
its kernels (building the source on first use) or raises; on CPU tensors it
runs its hoisted command through :mod:`.stage3_torch`, the plain version,
and counts no launch.  Code generation is pure Python and runs anywhere.
Registered as backend ``"cuda"`` (alias ``"dpia-cuda"``).

What bounds the generated kernels on the card: the strategies are the
reference's, shaped for the TPU, so most stages are bound by too few blocks
(the matmul strategy's 8, gemv's 8-16) or by a large accumulator kept in
global scratch rather than by bytes or FLOPs; the generator keeps every
grid and every order of arithmetic the strategy states.
"""
from __future__ import annotations

import ctypes
import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ...analysis import hlo_counter
from . import phrases as P
from . import stage2
from .types import (AccT, Arr, DataType, ExpT, Idx, Num, Pair, VarT, Vec,
                    scalar_of, shape_of)

THREADS = 256                       # threads per block, every stage
SMEM_BUDGET = 232448                # bytes of shared memory a block may use
SMEM_STATIC_LIMIT = 48 * 1024       # above this, opt in to dynamic smem
AHEAD = 16                          # loads a thread of a block-wide loop
                                    # issues ahead of its stores
STAGE_FLOATS = 16384                # largest global operand of a thread-0
                                    # loop that the block stages in smem
TILE = 64                           # dotBlock rows (columns) per register-
                                    # tile group: 16 threads x one float4
FST, SND = "f", "s"

launches = 0                        # kernel launches, all generated programs

_MESH_MSG = ("MESH levels are not emitted by the CUDA generator: compile a "
             "mesh term with Program(...).compile(\"shardmap\", mesh=..., "
             "inner=\"cuda\"), which runs each shard's body through this "
             "generator")


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
    reg: bool = False                 # one register per leaf (thread 0's)


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


def _align(n: int) -> int:
    """``n`` floats rounded up to 16 bytes (a float4)."""
    return -(-n // 4) * 4


class _Arena:
    """Stack allocator (in floats, each block 16-byte aligned) that
    remembers its high-water mark."""

    def __init__(self):
        self.top = 0
        self.high = 0

    def alloc(self, n: int) -> int:
        off = _align(self.top)
        self.top = off + n
        self.high = max(self.high, self.top)
        return off


def _commands(p: P.Phrase):
    """Every assignment and ``new`` of command ``p``, binders instantiated
    as :class:`_KernelGen` instantiates them (a parfor's body writes through
    its own acceptor)."""
    if isinstance(p, (P.Assign, P.New)):
        yield p
    if isinstance(p, P.SeqC):
        yield from _commands(p.c1)
        yield from _commands(p.c2)
    elif isinstance(p, P.New):
        yield from _commands(p.f(P.Var(P.fresh("v"), VarT(p.d))))
    elif isinstance(p, P.For):
        yield from _commands(p.f(P.Var(P.fresh("i"), ExpT(Idx(p.n)))))
    elif isinstance(p, P.ParFor):
        i = P.Var(P.fresh("i"), ExpT(Idx(p.n)))
        yield from _commands(p.f(i, P.IdxAcc(p.a, i)))
    elif isinstance(p, (P.MapI, P.ReduceI)):
        yield from _commands(stage2.expand(p))


def _one_element(d: DataType) -> bool:
    return all(math.prod(s) == 1 for _, s in leaves(d))


def _thread0(a: P.Assign) -> bool:
    """Does thread 0 run the assignment alone: it writes one element and
    its value needs no block-wide work (fullReduce, dotBlock)?"""
    return _one_element(P.acc_data(a.a)) and not any(
        isinstance(q, (P.FullReduce, P.DotBlock)) for q in _walk(a.e))


def _has_loop(p: P.Phrase) -> bool:
    return any(isinstance(q, (P.For, P.ParFor, P.MapI, P.ReduceI))
               for q in _walk(p))


def _mentions(p: P.Phrase, name: str) -> bool:
    return any(isinstance(q, P.Var) and q.name == name for q in _walk(p))


def _storage(ptr: str) -> str:
    """What a barrier must order accesses to: a kernel parameter by name,
    block-local buffers as all of shared memory or all of scratch (the
    arena reuses their space)."""
    if ptr.startswith("(smem"):
        return "smem"
    if ptr.startswith("(scratch_b"):
        return "scratch"
    return ptr


def _conflict(x, y) -> bool:
    """Do two accesses ``(storage, "r" | "w", "t0" | "all")`` need a
    barrier between them: one writes what the other touches, and they are
    not both thread 0's?"""
    return x[0] == y[0] and "w" in (x[1], y[1]) and not x[2] == y[2] == "t0"


class _KernelGen:
    """Emits the body of one ``__global__`` kernel.

    Block-wide statements are thread-strided loops; thread-0 statements run
    inside ``if (threadIdx.x == 0)`` regions (``in_region``; ``single``
    while a whole thread-0 command is emitted).  ``pending`` holds the
    accesses made since the last barrier and :meth:`access` emits one only
    where a new access conflicts with them; ``frames`` holds, for each open
    block-wide loop, the accesses its body makes before its first barrier,
    which the end of the body must not conflict with."""

    def __init__(self, buffers: Dict[str, _Buf]):
        self.buffers = dict(buffers)
        self.lines: List[str] = []
        self.depth = 1
        self.ivars: Dict[str, str] = {}
        self.smem = _Arena()
        self.scratch = _Arena()
        self.n = 0
        self.temps: Dict[P.Phrase, Tuple[str, Tuple[int, ...], bool]] = {}
        self.loads: List[Tuple[str, Tuple[str, ...], str]] = []
        self.single = False
        self.in_region = False
        self.pending: set = set()
        self.frames: List[list] = []
        self.capture = None         # (loads, round index) in batched()

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
        if not force_global and (_align(self.smem.top) + nfloats) * 4 \
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

    def close(self) -> None:
        self.depth -= 1
        self.emit("}")

    def batched(self, n: int, index, stmt, guard=None) -> None:
        """Emit a thread-strided loop over ``n`` elements whose loads run
        ahead of its arithmetic and stores.

        ``index(t)`` emits the index declarations of element ``t`` and
        returns what ``stmt(idx)`` takes; ``stmt`` emits the statement.
        Each round of elements first loads, into registers, every memory
        read ``stmt`` makes (zero where the C condition ``guard(idx)``
        fails), then runs ``stmt`` on each element in order.  The caller
        vouches that ``stmt`` writes none of those elements before a later
        element of the round reads it.  A round holds at most AHEAD loaded
        values a thread: a store through a pointer that may alias the next
        element's loads (scratch, the output) keeps the compiler from
        moving them above it."""
        t0, u, t = self.name("t"), self.name("u"), self.name("t")
        outer, depth = self.lines, self.depth
        self.lines, self.depth = [], depth + 3
        idx = index(t)
        idx_lines, self.lines = self.lines, []
        self.capture = ({}, u)
        stmt(idx)
        loads, self.capture = self.capture[0], None
        stmt_lines, self.lines, self.depth = self.lines, outer, depth
        rnd = max(1, min(-(-n // THREADS), AHEAD // max(1, len(loads))))
        self.emit(f"for (int {t0} = threadIdx.x; {t0} < {n}; "
                  f"{t0} += {THREADS * rnd}) {{")
        self.depth += 1
        if loads:
            arrays = ", ".join(f"{a}[{rnd}]" for a in loads.values())
            self.emit(f"float {arrays};")
        cond = f"if ({t} < {n}) {{" if n % (THREADS * rnd) else "{"
        for part in ("loads", "stmt") if loads else ("stmt",):
            self.emit("#pragma unroll")
            self.emit(f"for (int {u} = 0; {u} < {rnd}; ++{u}) {{")
            self.depth += 1
            self.emit(f"const int {t} = {t0} + {u} * {THREADS};")
            self.emit(cond)
            self.depth += 1
            self.lines += idx_lines
            if part == "stmt":
                self.lines += stmt_lines
            else:
                g = guard and guard(idx)
                for expr, a in loads.items():
                    self.emit(f"{a}[{u}] = " + (f"({g}) ? {expr} : 0.0f;"
                                                 if g else f"{expr};"))
            self.close()
            self.close()
        self.close()

    # -- barriers and thread-0 regions ----------------------------------------

    def region(self) -> None:
        """Open a thread-0 region unless one is open."""
        if not self.in_region:
            self.emit("if (threadIdx.x == 0) {")
            self.depth += 1
            self.in_region = True

    def end_region(self) -> None:
        if self.in_region:
            self.in_region = False
            self.close()

    def barrier(self) -> None:
        self.end_region()
        self.emit("__syncthreads();")
        self.synced()

    def synced(self) -> None:
        """Every thread passed a barrier (also those inside the block
        reductions): what was accessed before is ordered."""
        self.pending = set()
        for frame in self.frames:
            frame[1] = True

    def access(self, reads, writes, who: str) -> None:
        """Record reads and writes of storage by ``who`` ("t0" or "all"),
        after a barrier if one conflicts with what is pending."""
        new = {(k, "r", who) for k in reads} | {(k, "w", who) for k in writes}
        if any(_conflict(x, y) for x in new for y in self.pending):
            self.barrier()
        self.pending |= new
        for frame in self.frames:
            if not frame[1]:
                frame[0] |= new

    def keys(self, *phrases: P.Phrase) -> set:
        """Storage of the buffers that ``phrases`` name (registers are
        thread 0's own and never conflict)."""
        out = set()
        for p in phrases:
            for q in _walk(p):
                buf = self.buffers.get(q.name) if isinstance(q, P.Var) \
                    else None
                if buf is not None and not buf.reg:
                    out |= {_storage(ptr) for ptr, _ in buf.leaves.values()}
        return out

    def temp_keys(self) -> set:
        return {_storage(ptr) for ptr, _, reg in self.temps.values()
                if not reg}

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

    def at(self, name: str, comps: Tuple[str, ...], off: str) -> str:
        """The C l-value of a buffer leaf at flat offset ``off``."""
        buf = self.buffers[name]
        ptr = buf.leaves[comps][0]
        return ptr if buf.reg else f"{ptr}[{off}]"

    def load(self, name: str, idx: List[str], comps: Tuple[str, ...]) -> str:
        buf = self.buffers[name]
        if comps not in buf.leaves:
            raise TypeError(f"read of {name!r} at pair path {comps} is not a "
                            f"leaf")
        off = _offset(idx, buf.leaves[comps][1])
        self.loads.append((name, comps, off))
        expr = self.at(name, comps, off)
        return expr if buf.reg else self.fetch(expr)

    def fetch(self, expr: str) -> str:
        """A memory read ``expr``, or its register where :meth:`batched`
        loads it ahead."""
        if self.capture is None:
            return expr
        loads, u = self.capture
        return f"{loads.setdefault(expr, self.name('p'))}[{u}]"

    def elem(self, e: P.Phrase, idx: List[str],  # noqa: C901
             comps: Tuple[str, ...] = ()) -> str:
        """C expression of the element of ``e`` at ``idx`` (pair path
        ``comps``)."""
        if e in self.temps:
            ptr, shape, reg = self.temps[e]
            return ptr if reg else self.fetch(f"{ptr}[{_offset(idx, shape)}]")
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

    def materialise(self, e: P.Phrase, to_reg: bool = False) -> None:
        """Compute every fullReduce / dotBlock under ``e`` (innermost first)
        into block-local temporaries that :meth:`elem` then reads.  With
        ``to_reg`` (only thread 0 reads ``e``) a scalar result stays in
        thread 0's register."""
        if e in self.temps or isinstance(e, (P.Var, P.Lit)):
            return
        inner = to_reg and not isinstance(e, (P.FullReduce, P.DotBlock))
        for attr in ("e", "a", "b"):
            c = getattr(e, attr, None)
            if isinstance(c, P.Phrase):
                self.materialise(c, inner)
        if isinstance(e, P.FullReduce):
            shape = shape_of(P.exp_data(e.e))
            self.temps[e] = self._block_reduce(
                e.op, math.prod(shape), lambda t: self.decompose(t, shape),
                lambda idx: self.elem(e.e, idx), (e.e,), to_reg)
        elif isinstance(e, P.DotBlock):
            self._dot_block(e, to_reg)

    def _block_reduce(self, op: str, n: int, index, term, operands,
                      to_reg: bool):
        """Emit a block reduction of ``term(index(t))`` over ``n`` elements
        (``index`` and ``term`` as :meth:`batched` takes them); returns the
        temporary: thread 0's register with ``to_reg``, else a shared scalar
        that every thread may read."""
        self.end_region()
        self.access(self.keys(*operands) | self.temp_keys(), (), "all")
        r = self.name("r")
        init = "0.0f" if op == "add" else "(-INFINITY)"
        self.emit(f"float {r} = {init};")
        self.batched(n, index, lambda idx: self.emit(
            f"{r} = {r} + {term(idx)};" if op == "add"
            else f"{r} = fmaxf({r}, {term(idx)});"))
        fn = "dpia_block_sum" if op == "add" else "dpia_block_max"
        self.emit(f"{r} = {fn}({r}, red);")
        self.synced()               # the reduction's barriers order the reads
        if to_reg:
            return r, (), True
        ptr = self.local(1)
        self.emit(f"if (threadIdx.x == 0) {ptr}[0] = {r};")
        self.barrier()
        return ptr, (), False

    def _dot_block(self, e: P.DotBlock, to_reg: bool) -> None:
        sa, sb = shape_of(P.exp_data(e.a)), shape_of(P.exp_data(e.b))
        if len(sa) == 1:                                  # (k,).(k,) -> num
            self.temps[e] = self._block_reduce(
                "add", sa[0], lambda t: [t],
                lambda i: f"{self.elem(e.a, i)} * {self.elem(e.b, i)}",
                (e.a, e.b), to_reg)
            return
        n, k = sa
        if len(sb) == 2:
            self._matmul(e, n, k, sb[1])
            return
        # (n,k).(k,) -> (n,): a warp per row
        out = self.local(n)
        self.end_region()
        self.access(self.keys(e.a, e.b) | self.temp_keys(),
                    {_storage(out)}, "all")
        kk, row, s = self.name("k"), self.name("row"), self.name("s")
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
        self.barrier()
        self.temps[e] = (out, (n,), False)

    def _tiles(self, n: int, k: int, m: int) -> Tuple[int, int, int]:
        """(row groups, column groups, k chunk) of a matrix-product
        dotBlock's shared-memory tiles: the largest that fit beside what is
        allocated, A's whole k first, then narrower B panels, then shorter
        k chunks (at least one k step, which may spill to scratch)."""
        free = (SMEM_BUDGET - 4 * (THREADS // 32)) // 4 - _align(self.smem.top)
        hm, hn = (2 if n > TILE else 1), (2 if m > TILE else 1)
        per_k = 0
        for gm, gn in dict.fromkeys([(hm, hn), (hm, 1), (1, 1)]):
            per_k = gm * TILE + 4 + gn * TILE     # A row padded by 4 floats
            if k * per_k <= free:
                return gm, gn, k
        return 1, 1, max(1, min(k, free // per_k))

    def _matmul(self, e: P.DotBlock, n: int, k: int, m: int) -> None:
        """(n,k).(k,m) -> (n,m), register-tiled through shared memory.

        A is copied (transposed, rows padded by 4 floats) as PM x KC tiles
        and B as KC x PN panels, each element through :meth:`elem` in
        coalesced order, zero beyond the edges.  Thread (ty, tx) of a
        16 x 16 grid keeps the outputs at rows h * 64 + 4 ty + (0..3) and
        columns h * 64 + 4 tx + (0..3) in registers (8 x 8 at the full
        tile) and reads its operands as float4s; each output's k loop runs
        from 0.0f in order, one ``fmaf`` a step, as ``s += a * b`` does
        under nvcc's default ``--fmad=true``.  The outputs are stored,
        masked, into the block-local temporary."""
        out = self.local(n * m)
        mark = self.mark()
        hm, hn, kc = self._tiles(n, k, m)
        pm, pn, lda = hm * TILE, hn * TILE, hm * TILE + 4
        a_s, b_s = self.local(kc * lda), self.local(kc * pn)
        self.end_region()
        self.access(self.keys(e.a, e.b) | self.temp_keys(),
                    {_storage(p) for p in (out, a_s, b_s)}, "all")
        ty, tx, rp, cp = (self.name(x) for x in ("ty", "tx", "rp", "cp"))
        k0 = self.name("kc") if kc < k else "0"
        self.emit(f"const int {ty} = threadIdx.x / 16, "
                  f"{tx} = threadIdx.x % 16;")
        if n > pm:
            self.emit(f"for (int {rp} = 0; {rp} < {n}; {rp} += {pm}) {{")
            self.depth += 1
        else:
            self.emit(f"const int {rp} = 0;")

        def copy(x, rows, cols, i, j, limits, at):
            """Copy element [i(r), j(c)] of operand ``x`` for a rows x cols
            tile into ``at(r, c)``, c fastest (coalesced for a row-major
            operand), zero where i or j reaches its limit (None: never)."""
            def index(t):
                r, c = self.name("r"), self.name("c")
                self.emit(f"const int {r} = {t} / {cols}, {c} = {t} % {cols};")
                return r, c

            def guard(rc):
                return " && ".join(f"{v} < {lim}" for v, lim in zip(
                    (i(rc[0]), j(rc[1])), limits) if lim) or None
            self.batched(rows * cols, index, lambda rc: self.emit(
                f"{at(*rc)} = {self.elem(x, [i(rc[0]), j(rc[1])])};"), guard)

        def copy_a():                       # a_s[k][row], rows padded
            copy(e.a, pm, kc, lambda r: f"{rp} + {r}", lambda c: f"{k0} + {c}",
                 (n % pm and n, k % kc and k),
                 lambda r, c: f"{a_s}[{c} * {lda} + {r}]")

        def copy_b():                       # b_s[k][column]
            copy(e.b, kc, pn, lambda r: f"{k0} + {r}", lambda c: f"{cp} + {c}",
                 (k % kc and k, m % pn and m),
                 lambda r, c: f"{b_s}[{r} * {pn} + {c}]")

        if kc == k:
            if n > pm:
                self.barrier()              # the last row panel's reads
            copy_a()
        self.emit(f"for (int {cp} = 0; {cp} < {m}; {cp} += {pn}) {{")
        self.depth += 1
        acc, av, bv = self.name("acc"), self.name("a"), self.name("b")
        rows, cols = 4 * hm, 4 * hn
        self.emit(f"float {acc}[{rows}][{cols}];")
        self.emit("#pragma unroll")
        self.emit(f"for (int i = 0; i < {rows}; ++i)")
        self.emit("#pragma unroll")
        self.emit(f"  for (int j = 0; j < {cols}; ++j) {acc}[i][j] = 0.0f;")
        if kc < k:
            self.emit(f"for (int {k0} = 0; {k0} < {k}; {k0} += {kc}) {{")
            self.depth += 1
        self.barrier()                      # the last panel's reads
        if kc < k:
            copy_a()
        copy_b()
        self.barrier()
        kn = str(kc) if k % kc == 0 else f"min({kc}, {k} - {k0})"
        kk = self.name("kk")
        self.emit("#pragma unroll 4")
        self.emit(f"for (int {kk} = 0; {kk} < {kn}; ++{kk}) {{")
        self.depth += 1
        self.emit(f"float {av}[{rows}], {bv}[{cols}];")
        for v, ptr, ld, t, groups in ((av, a_s, lda, ty, hm),
                                      (bv, b_s, pn, tx, hn)):
            for h in range(groups):
                f4 = self.name("f")
                self.emit(f"const float4 {f4} = *reinterpret_cast<const "
                          f"float4*>({ptr} + {kk} * {ld} + {h * TILE} + "
                          f"4 * {t});")
                self.emit(f"{v}[{4 * h}] = {f4}.x; {v}[{4 * h + 1}] = "
                          f"{f4}.y; {v}[{4 * h + 2}] = {f4}.z; "
                          f"{v}[{4 * h + 3}] = {f4}.w;")
        self.emit("#pragma unroll")
        self.emit(f"for (int i = 0; i < {rows}; ++i)")
        self.emit("#pragma unroll")
        self.emit(f"  for (int j = 0; j < {cols}; ++j)")
        self.emit(f"    {acc}[i][j] = fmaf({av}[i], {bv}[j], {acc}[i][j]);")
        self.close()                        # kk
        if kc < k:
            self.close()                    # k chunks
        self.emit("#pragma unroll")
        self.emit(f"for (int i = 0; i < {rows}; ++i)")
        self.emit("#pragma unroll")
        self.emit(f"  for (int j = 0; j < {cols}; ++j) {{")
        self.emit(f"    const int r = {rp} + (i / 4) * {TILE} + 4 * {ty} "
                  f"+ i % 4, c = {cp} + (j / 4) * {TILE} + 4 * {tx} + j % 4;")
        self.emit(f"    if (r < {n} && c < {m}) {out}[r * {m} + c] = "
                  f"{acc}[i][j];")
        self.emit("  }")
        self.close()                        # column panels
        if n > pm:
            self.close()                    # row panels
        self.barrier()
        self.release(mark)
        self.temps[e] = (out, (n, m), False)

    # -- commands -------------------------------------------------------------

    def comm(self, p: P.Phrase) -> None:
        if isinstance(p, P.Skip):
            return
        if isinstance(p, P.SeqC):
            self.comm(p.c1)
            self.comm(p.c2)
        elif isinstance(p, (P.MapI, P.ReduceI)):
            self.comm(stage2.expand(p))
        elif not self.single and all(
                _thread0(c) for c in _commands(p) if isinstance(c, P.Assign)):
            self.thread0(p)
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
        else:
            raise TypeError(f"not a command: {type(p).__name__}")

    def thread0(self, p: P.Phrase) -> None:
        """Emit a command that only thread 0 runs into a thread-0 region,
        after a barrier if what it touches conflicts with what is pending.

        If it loops, each global operand it reads and does not write (up to
        STAGE_FLOATS) is first copied into shared memory by the whole block,
        coalesced and a round of loads ahead: thread 0's loads then wait on
        shared memory, not on L2 (ptxas keeps only a few of a lone thread's
        global loads in flight, however far the source unrolls them)."""
        assigns = [c for c in _commands(p) if isinstance(c, P.Assign)]
        written = {q.name for c in assigns for q in _walk(c.a)
                   if isinstance(q, P.Var)}
        read = {q.name for c in assigns for q in _walk(c.e)
                if isinstance(q, P.Var) and q.name in self.buffers}
        mark, saved = self.mark(), {}
        for name in sorted(read - written) if _has_loop(p) else ():
            buf = self.buffers[name]
            size = sum(math.prod(s) for _, s in buf.leaves.values())
            if buf.reg or size > STAGE_FLOATS or any(
                    _storage(ptr) != ptr for ptr, _ in buf.leaves.values()):
                continue
            lv = {}
            for comps, (ptr, shape) in buf.leaves.items():
                copy = self.local(math.prod(shape))
                if _storage(copy) != "smem":
                    break
                self.end_region()
                self.access({ptr}, {"smem"}, "all")
                self.batched(math.prod(shape), lambda t: t,
                             lambda t, c=copy, g=ptr: self.emit(
                                 f"{c}[{t}] = {self.fetch(f'{g}[{t}]')};"))
                lv[comps] = (copy, shape)
            else:
                saved[name] = buf
                self.buffers[name] = _Buf(name, buf.d, lv)
        reads, writes = set(), set()
        for c in _commands(p):
            if isinstance(c, P.Assign):
                reads |= self.keys(c.e)
                writes |= self.keys(c.a)
            elif not self._register(c):
                writes |= {"smem", "scratch"}
        self.access(reads, writes, "t0")
        self.region()
        self.single = True
        self.comm(p)
        self.single = False
        self.buffers.update(saved)
        self.release(mark)

    def _register(self, p: P.New, body: Optional[P.Phrase] = None,
                  name: str = "") -> bool:
        """Is ``new`` one register per leaf: one element, not in HBM, and
        touched by thread-0 assignments only (all of them are when it is
        emitted on thread 0, or its ``body`` is not given)?"""
        if p.space == P.HBM or not _one_element(p.d):
            return False
        return self.single or body is None or all(
            _thread0(c) for c in _commands(body)
            if isinstance(c, P.Assign) and _mentions(c, name))

    def loop(self, n: int, i: P.Var, body: P.Phrase, unroll=False) -> None:
        c = self.name("i")
        self.ivars[i.name] = c
        if self.single:
            if unroll:
                self.emit("#pragma unroll")
            self.emit(f"for (int {c} = 0; {c} < {n}; ++{c}) {{")
            self.depth += 1
            self.comm(body)
            self.close()
            return
        self.end_region()
        if unroll:
            self.emit("#pragma unroll")
        self.emit(f"for (int {c} = 0; {c} < {n}; ++{c}) {{")
        self.depth += 1
        frame = [set(), False]
        self.frames.append(frame)
        self.comm(body)
        self.end_region()
        self.frames.pop()
        # the next iteration's first accesses against this one's last
        if any(_conflict(x, y) for x in frame[0] for y in self.pending):
            self.barrier()
        self.close()

    def new(self, p: P.New) -> None:
        v = P.Var(P.fresh("kbuf"), VarT(p.d))
        body = p.f(v)
        mark = self.mark()
        lv = {}
        reg = self._register(p, body, v.name)
        if reg:
            if not self.single:
                self.end_region()
            for comps, shape in leaves(p.d):
                r = self.name("v")
                self.emit(f"float {r} = 0.0f;")
                lv[comps] = (r, shape)
        else:
            for comps, shape in leaves(p.d):
                lv[comps] = (self.local(math.prod(shape),
                                        force_global=p.space == P.HBM), shape)
            where = {_storage(ptr) for ptr, _ in lv.values()}
            if self.single:
                for ptr, shape in lv.values():
                    self.emit(f"for (int t = 0; t < {math.prod(shape)}; ++t) "
                              f"{ptr}[t] = 0.0f;")
            elif _one_element(p.d):
                self.access((), where, "t0")
                self.region()
                for ptr, _ in lv.values():
                    self.emit(f"{ptr}[0] = 0.0f;")
            else:
                self.end_region()
                self.access((), where, "all")
                for ptr, shape in lv.values():
                    self.batched(math.prod(shape), lambda t: t,
                                 lambda t, ptr=ptr: self.emit(
                                     f"{ptr}[{t}] = 0.0f;"))
        self.buffers[v.name] = _Buf(v.name, p.d, lv, reg)
        self.comm(body)
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
        one = _one_element(P.acc_data(a))
        self.materialise(e, to_reg=one)
        reads, writes = self.keys(e) | self.temp_keys(), self.keys(a)
        if one:                             # thread 0 alone
            if not self.single:
                self.access(reads, writes, "t0")
                self.region()
            for comps, shape in leaves(P.acc_data(a)):
                idx = ["0"] * len(shape)
                root, rc, off = self.dest(a, idx, comps)
                self.emit(f"{self.at(root, rc, off)} = "
                          f"{self.elem(e, idx, comps)};")
        else:
            self.end_region()
            for comps, shape in leaves(P.acc_data(a)):
                n = math.prod(shape)
                tmp = None
                if self._reads_other_elements(a, e, shape, comps):
                    tmp = self.local(n)
                    self.access(reads, {_storage(tmp)}, "all")
                    self.batched(
                        n, lambda t, s=shape: self.decompose(t, s),
                        lambda idx, s=shape, c=comps, tmp=tmp: self.emit(
                            f"{tmp}[{_offset(idx, s)}] = "
                            f"{self.elem(e, idx, c)};"))
                # with tmp, the write conflicts with the reads of the
                # destination above: access puts a barrier between them
                self.access({_storage(tmp)} if tmp else reads, writes, "all")

                def store(idx, comps=comps, tmp=tmp):
                    root, rc, off = self.dest(a, idx, comps)
                    value = (f"{tmp}[{_offset(idx, shape)}]" if tmp
                             else self.elem(e, idx, comps))
                    self.emit(f"{self.at(root, rc, off)} = {value};")
                # each element reads the destination at most where it
                # writes it, so a round's loads may all come first
                self.batched(n, lambda t, s=shape: self.decompose(t, s), store)
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
        gen.end_region()
        scratch = _align(gen.scratch.high)    # each block's slice 16-aligned
        st = Stage(k, kind, grid, THREADS, gen.smem.high * 4, scratch * 4)
        self.stages.append(st)
        self.bodies.append(("\n".join(gen.lines), scratch))

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
        return {int(i): r for (i,), r in _build.ptxas_report(
            _build.generated_target(self.name, self.source).with_suffix(
                ".log").read_text(), r"dpia_stage(\d+)").items()}

    def __call__(self, *args):
        import torch
        from .stage3_torch import run_command
        tensors = [a for a in _flat(args) if isinstance(a, torch.Tensor)]
        devices = {t.device.type for t in tensors}
        if devices <= {"cpu"}:
            return run_command(self.cmd, self.out.t.d,
                               [v.name for v in self.arg_vars],
                               self.out.name, args)
        launchers, out = self.bind(*args)
        for launch in launchers:
            launch()
        return out

    def bind(self, *args):
        """The launches of one call on CUDA tensors ``args``: returns
        ``(launchers, out)``, one zero-argument callable per stage, bound to
        outputs, hoisted temporaries and scratch allocated here, and the
        output they fill when called in order.  Each launches its stage on
        the current stream, counts it and raises if the launch fails; a
        stage may be called alone (chip_smoke times each stage so)."""
        import torch

        from ...kernels import _build
        if len(args) != len(self.arg_vars):
            raise TypeError(f"{self.name}: {len(self.arg_vars)} arguments, "
                            f"got {len(args)}")
        tensors = [a for a in _flat(args) if isinstance(a, torch.Tensor)]
        devices = {t.device.type for t in tensors}
        if devices != {"cuda"}:
            raise ValueError(f"{self.name}: no kernel for devices "
                             f"{sorted(devices)}")
        device = tensors[0].device
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
        keep += out_leaves + host + [scratch]
        ptrs += [t.data_ptr() for t in out_leaves + host]
        ptrs.append(scratch.data_ptr())
        self.build()

        def launcher(st, fn):
            def launch():
                global launches
                with torch.cuda.device(device):
                    stream = torch.cuda.current_stream(device).cuda_stream
                    _build.check(fn(*ptrs, stream),
                                 f"{self.name} stage {st.index}")
                # a generated program declares no work to an op count:
                # a launch inside one raises
                hlo_counter.launched(f"dpia_cuda:{self.name}")
                self.launches += 1
                launches += 1
            launch.buffers = keep     # what ``ptrs`` point into lives on
            return launch
        return ([launcher(st, fn) for st, fn in zip(self.stages, self._fns)],
                _unflatten(self.out.t.d, iter(out_leaves)))

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
