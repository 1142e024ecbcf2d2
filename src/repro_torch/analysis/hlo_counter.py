"""Scan-aware op counter: the port's counterpart of
``repro.analysis.hlo_counter``.

The reference parses the HLO text of a compiled XLA program and counts,
with each ``while`` body scaled by its trip count, dot FLOPs, elementwise
FLOPs, HBM traffic under a write-once model and collective bytes.  The
port has no XLA and no HLO: what runs is the stream of ATen ops that one
eager call dispatches, plus the hand-written kernels (K1, K2, K3) that its
wrappers launch through ctypes.  This module counts that stream, in the
reference's :class:`Totals`:

  * :class:`Counter` is a ``TorchDispatchMode``: it sees every ATen op of
    the call, forward and backward (the autograd engine carries the mode
    to its threads), on any device (``meta`` included: nothing runs);
  * dot FLOPs: ``torch.utils.flop_counter``'s formulas for ``mm``,
    ``bmm``, ``addmm`` and ``baddbmm`` (2 M N K, the reference's 2 x
    prod(result) x prod(contracting dims)), ``mv`` and ``dot`` alike;
  * the reference's traffic model: a dot charges its operands' and its
    result's bytes (to ``bytes`` and to the fused floor ``bytes_min``); an
    elementwise op its result's bytes only (``bytes``: each materialised
    tensor written once, its reads charged where a dot or another op
    consumes it), and 1 FLOP an element where the reference's
    ``_FLOP_ELEMWISE`` counts one (``_FLOP_OPS``; silu and softplus, one
    ATen op for two of XLA's, 2); a reduction its input's elements as
    FLOPs and its operands' and result's bytes; any other op (gathers,
    scatters, index ops, cumsum) its operands' and result's bytes, to
    both; views, ``copy_`` / ``clone`` plumbing, allocations and
    host transfers (a ``_to_copy`` across devices, a scalar read) are
    free;
  * a hand-written kernel declares its work (:func:`kernel`, called by the
    wrappers in ``repro_torch.kernels`` with the formulas of
    ``chip_smoke.py``'s bounds): its FLOPs and bytes are added (to both
    byte counts: a kernel is fused), and the ops dispatched inside the
    declaration (the plain version on a ``cpu`` or ``meta`` tensor, the
    output allocations before a launch on the card) are not counted, so
    one call counts the same on ``cpu``, ``meta`` and ``cuda``.  A launch
    with no declaration (:func:`launched`: a K4 program, a CUDA graph's
    replay) raises: it never reads as zero;
  * trip counts: the port's loops over identical layers and time steps
    are Python loops.  The models run them through :func:`layers` and
    :func:`scan`, which outside a count are those loops.  Under a
    counter with ``scale=True`` they run the first body alone, inside one
    ``autograd.Function`` (:class:`_Scaled`) whose forward and backward
    count at the trip count's weight, nested regions multiplying (a time
    step inside a layer: layers x steps); what the full loop would add on
    top (autograd's sums of the gradients of a tensor that every body
    reads) is added as counted adds.  ``scale=False`` counts every
    iteration;
  * collectives: through the port's own groups (``sharding.collectives``
    ``_Group._count`` calls :func:`collective`): each collective's result
    bytes, under the reference's kind names (``all-reduce``,
    ``all-gather``, ``reduce-scatter``, ``all-to-all``).

:func:`analyze_text` (the reference's name, a function of a callable and
its arguments here) returns the call's :class:`Totals`.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["Totals", "Counter", "analyze_text", "count", "kernel",
           "launched", "collective", "layers", "scan", "scaling", "plain",
           "causal_pairs", "UndeclaredKernel"]


@dataclass
class Totals:
    flops: float = 0.0
    bytes: float = 0.0       # write-once ceiling (every tensor materialised)
    bytes_min: float = 0.0   # perfectly-fused floor (dot / kernel / op traffic)
    coll_bytes: float = 0.0
    coll_count: float = 0.0
    coll_by_kind: Dict[str, float] = field(default_factory=dict)


class UndeclaredKernel(RuntimeError):
    """A hand-written kernel launched inside a count with no declared
    work."""


# ATen op names (the overload packet's, an in-place op's trailing "_"
# dropped) by class
_DOTS = {"mm", "bmm", "addmm", "baddbmm", "mv", "addmv", "dot"}
_FLOP_OPS = {
    "add": 1, "sub": 1, "rsub": 1, "mul": 1, "div": 1, "maximum": 1,
    "minimum": 1, "neg": 1, "abs": 1, "exp": 1, "log": 1, "rsqrt": 1,
    "sqrt": 1, "tanh": 1, "sigmoid": 1, "pow": 1, "eq": 1, "ne": 1,
    "lt": 1, "le": 1, "gt": 1, "ge": 1, "where": 1, "clamp": 1,
    "clamp_min": 1, "clamp_max": 1, "remainder": 1, "fmod": 1, "expm1": 1,
    "cos": 1, "sin": 1, "relu": 1, "masked_fill": 1, "reciprocal": 1,
    "log1p": 1, "square": 1, "lerp": 1, "addcmul": 1, "addcdiv": 1,
    "sign": 1, "floor": 1, "ceil": 1, "round": 1, "silu": 2, "softplus": 2,
    "sigmoid_backward": 1, "tanh_backward": 1, "threshold_backward": 1,
    "silu_backward": 2, "softplus_backward": 2, "logical_and": 1,
    "logical_or": 1, "logical_not": 1, "bitwise_and": 1, "bitwise_or": 1,
    "bitwise_not": 1, "isfinite": 1, "isnan": 1, "isinf": 1,
    "max": 1, "min": 1}
# result bytes, no FLOP (the reference's convert / concatenate / pad / ...)
_MOVES = {"_to_copy", "cat", "stack", "constant_pad_nd", "flip", "roll",
          "repeat", "expand_copy", "_unsafe_index", "tril", "triu"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "norm",
               "linalg_vector_norm", "var", "std", "argmax", "argmin",
               "logsumexp", "all", "any", "var_mean", "std_mean"}
# softmax-like: a reduction and its elementwise work in one ATen op
_SOFTMAX = {"_softmax": 5, "_log_softmax": 5, "_softmax_backward_data": 4,
            "_log_softmax_backward_data": 4}
_FREE = {"view", "_unsafe_view", "reshape", "expand", "permute",
         "transpose", "t", "slice", "select", "squeeze", "unsqueeze",
         "as_strided", "alias", "detach", "split", "split_with_sizes",
         "unbind", "chunk", "narrow", "diagonal", "unfold", "_reshape_alias",
         "lift_fresh", "lift", "clone", "copy", "copy_", "empty",
         "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "zeros", "zeros_like", "ones", "ones_like", "full", "full_like",
         "new_zeros", "new_ones", "new_full", "scalar_tensor", "arange",
         "fill", "zero", "_local_scalar_dense", "is_nonzero", "_assert_async",
         "set", "resize", "detach_", "view_as", "expand_as", "movedim",
         "unflatten", "flatten", "contiguous", "_to_dense", "item",
         "_has_compatible_shallow_copy_type", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset", "is_same_size", "split_copy",
         "unbind_copy", "select_copy", "slice_copy", "view_copy",
         "_assert_tensor_metadata", "record_stream", "equal"}

# the reference's collective kind names
_KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
          "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all"}

# the running counters, innermost last (a plain list, not thread-local:
# autograd runs a CUDA backward on a thread of its own)
_STACK: List["Counter"] = []


def _current() -> Optional["Counter"]:
    return _STACK[-1] if _STACK else None


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _name(func) -> str:
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.startswith("_") \
        else name


def _dot_flops(name: str, args, out) -> float:
    from torch.utils.flop_counter import flop_registry
    packet = getattr(torch.ops.aten, name)
    if name in ("mm", "bmm"):
        # the out_dtype overloads (a bf16 product kept in fp32) carry the
        # dtype third, which the registry's formulas do not take
        args = args[:2]
    if packet in flop_registry:
        return float(flop_registry[packet](*args, out_val=out))
    if name in ("mv", "addmv"):
        a = args[-2]
        return 2.0 * a.shape[0] * a.shape[1]
    return 2.0 * args[0].numel()             # dot


class Counter(TorchDispatchMode):
    """Counts the op stream of the code run under it (module docstring):
    ``totals`` (a :class:`Totals`), ``kernels`` (declared kernel calls by
    name), ``coll_calls`` (collectives by kind; both weighted),
    ``dot_flops`` (the FLOPs of the dispatched dot ops alone, weighted;
    a kernel's declared work is not among them), ``coll_by_tag`` (the
    bytes of the collectives issued inside each :func:`tagged` region,
    weighted) and ``ops`` (the ATen ops counted, unweighted).  With
    ``scale`` the regions of :func:`layers` and :func:`scan` run one body
    at their trip count's weight; without, every iteration runs and
    counts."""

    def __init__(self, scale: bool = True):
        super().__init__()
        self.scale = scale
        self.totals = Totals()
        self.kernels: Dict[str, float] = {}
        self.coll_calls: Dict[str, float] = {}
        self.dot_flops = 0.0
        self.coll_by_tag: Dict[str, float] = {}
        self._tags: List[str] = []
        self.ops = 0
        self._weight = [1.0]
        self._declared = 0

    # -- weights --------------------------------------------------------------
    @property
    def weight(self) -> float:
        return self._weight[-1]

    @contextlib.contextmanager
    def weighted(self, w: float):
        self._weight.append(self.weight * w)
        try:
            yield
        finally:
            self._weight.pop()

    # -- the mode -------------------------------------------------------------
    def __enter__(self):
        _STACK.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _STACK.remove(self)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _name(func)
        host = self._host_read(name, args, kwargs)
        if host is not None:
            return host
        out = func(*args, **kwargs)
        # c10d's own ops: the groups count each collective (collective())
        if not self._declared and func.namespace != "c10d":
            self._count(name, args, kwargs, out)
        return out

    @staticmethod
    def _host_read(name, args, kwargs):
        """A read of a ``meta`` tensor's values onto the host (``.item()``,
        ``.tolist()``): ones of the right shape (finite, true), so a step's
        host sync runs through on ``meta``."""
        src = args[0] if args else None
        if not (isinstance(src, torch.Tensor) and src.is_meta):
            return None
        if name == "_local_scalar_dense":
            return src.new_ones((), device="cpu").item()
        if name == "_to_copy":
            dev = kwargs.get("device")
            if dev is not None and torch.device(dev).type != "meta":
                return torch.ones(src.shape, dtype=kwargs.get(
                    "dtype") or src.dtype, device=dev)
        return None

    def _count(self, name, args, kwargs, out) -> None:
        t, w = self.totals, self.weight
        if w == 0 or name in _FREE:
            return
        if name == "_to_copy":
            src = args[0]
            dev = kwargs.get("device")
            if dev is not None and torch.device(dev) != src.device:
                return                       # a host transfer
        self.ops += 1
        outs = _tensors(out)
        out_b = sum(_nbytes(o) for o in outs)
        ins = _tensors((args, kwargs))
        in_b = sum(_nbytes(i) for i in ins)
        if name in _DOTS:
            flops = w * _dot_flops(name, args, outs[0])
            t.flops += flops
            self.dot_flops += flops
            t.bytes += w * (in_b + out_b)
            t.bytes_min += w * (in_b + out_b)
            return
        binary = sum(isinstance(a, torch.Tensor) for a in args) >= 2
        if name in _REDUCTIONS and not (name in ("max", "min") and binary):
            t.flops += w * sum(i.numel() for i in ins[:1])
            t.bytes += w * (in_b + out_b)
            t.bytes_min += w * (in_b + out_b)
            return
        if name in _SOFTMAX:
            t.flops += w * _SOFTMAX[name] * ins[0].numel()
            t.bytes += w * (in_b + out_b)
            t.bytes_min += w * (in_b + out_b)
            return
        if name in _FLOP_OPS:
            t.flops += w * _FLOP_OPS[name] * sum(o.numel() for o in outs)
            t.bytes += w * out_b
            return
        if name in _MOVES:
            t.bytes += w * out_b
            return
        t.bytes += w * (in_b + out_b)
        t.bytes_min += w * (in_b + out_b)

    # -- declarations ---------------------------------------------------------
    def declare(self, name: str, flops: float, nbytes: float) -> None:
        w = self.weight
        self.kernels[name] = self.kernels.get(name, 0.0) + w
        self.totals.flops += w * flops
        self.totals.bytes += w * nbytes
        self.totals.bytes_min += w * nbytes

    def add_collective(self, kind: str, nbytes: int) -> None:
        w = self.weight
        if w == 0:
            return
        kind = _KINDS.get(kind, kind)
        t = self.totals
        t.coll_bytes += w * nbytes
        t.coll_count += w
        t.coll_by_kind[kind] = t.coll_by_kind.get(kind, 0.0) + w * nbytes
        self.coll_calls[kind] = self.coll_calls.get(kind, 0.0) + w
        for tag in set(self._tags):
            self.coll_by_tag[tag] = self.coll_by_tag.get(tag, 0.0) + w * nbytes


# ---------------------------------------------------------------------------
# hooks the port's kernels, groups and models call
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def kernel(name: str, *, flops: float, nbytes: float):
    """A hand-written kernel's call (or its plain version standing in on a
    ``cpu`` / ``meta`` tensor): inside a count, ``flops`` and ``nbytes``
    are added and the ops dispatched within are not counted; outside one,
    nothing."""
    c = _current()
    if c is None:
        yield
        return
    c.declare(name, flops, nbytes)
    c._declared += 1
    try:
        yield
    finally:
        c._declared -= 1


def launched(name: str) -> None:
    """A wrapper's note that it launched (or replayed) kernel ``name``:
    inside a count and outside a :func:`kernel` declaration it raises
    :class:`UndeclaredKernel` (the counter cannot see its work)."""
    c = _current()
    if c is not None and not c._declared:
        raise UndeclaredKernel(
            f"kernel {name!r} launched inside an op count with no declared "
            f"work: its FLOPs and bytes are invisible to the counter")


def collective(kind: str, nbytes: int) -> None:
    """A collective of ``kind`` (the port's name) whose result holds
    ``nbytes`` bytes, issued by a ``sharding.collectives`` group."""
    c = _current()
    if c is not None and not c._declared:
        c.add_collective(kind, nbytes)


@contextlib.contextmanager
def tagged(tag: str):
    """Inside a count, the collectives issued in the region are also added
    to the count's ``coll_by_tag[tag]``: what a record breaks out of its
    collective bytes (a serving step's state moves, its head's gather)."""
    c = _current()
    if c is None:
        yield
        return
    c._tags.append(tag)
    try:
        yield
    finally:
        c._tags.pop()


def plain(t: torch.Tensor) -> bool:
    """Whether a kernel wrapper computes its plain version for ``t``: a CPU
    tensor, or a ``meta`` tensor inside a count (shapes alone, nothing
    runs: the dry run's step).  Any other tensor launches or raises."""
    return t.device.type == "cpu" or (t.is_meta and _current() is not None)


def scaling() -> bool:
    """Whether a count that scales regions by their trip counts runs."""
    c = _current()
    return c is not None and c.scale


class _Scaled(torch.autograd.Function):
    """One body of a region run at its trip count's weight: the forward
    runs ``body`` on private detached inputs (its own graph), the backward
    differentiates that graph, both under ``weight``."""

    @staticmethod
    def forward(ctx, counter, weight, body, *flat):
        inputs = [t.detach().requires_grad_(t.requires_grad)
                  if isinstance(t, torch.Tensor) else t for t in flat]
        # the private graph keeps its own saved tensors: an enclosing
        # remat's hooks would recompute its whole region again for this
        # graph's backward (a graph task of its own); its recompute runs
        # this forward again, as the loop's would
        with torch.enable_grad(), counter.weighted(weight), \
                torch.autograd.graph.saved_tensors_hooks(_keep, _keep):
            outs = body(inputs)
        ctx.counter, ctx.weight = counter, weight
        ctx.inputs, ctx.outs = inputs, outs
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        need = [t for t in ctx.inputs
                if isinstance(t, torch.Tensor) and t.requires_grad]
        pairs = [(o, g) for o, g in zip(ctx.outs, grads)
                 if o.requires_grad and g is not None]
        got = [None] * len(need)
        if need and pairs:
            with ctx.counter.weighted(ctx.weight):
                got = list(torch.autograd.grad(
                    [o for o, _ in pairs], need, [g for _, g in pairs],
                    allow_unused=True))
        it = iter(got)
        return (None, None, None,
                *(next(it) if isinstance(t, torch.Tensor) and t.requires_grad
                  else None for t in ctx.inputs))


def _keep(t):
    return t


def _accumulated(counter, consts, repeats: int) -> None:
    """What autograd adds when ``repeats`` bodies read each of ``consts``:
    ``repeats - 1`` sums of its gradient (an add a time, result bytes)."""
    w = counter.weight
    for c in consts:
        if c.requires_grad and repeats > 1:
            counter.totals.flops += w * (repeats - 1) * c.numel()
            counter.totals.bytes += w * (repeats - 1) * _nbytes(c)


def _run_scaled(counter, n, body, args, consts):
    """``body(*args, *consts)`` once at weight ``n``; the tensors of
    ``args`` and ``consts`` (trees) are its inputs, its tensor outputs
    (a tree) come back through :class:`_Scaled`."""
    flat, spec = pytree.tree_flatten((args, consts))
    shape = {}

    def run(inputs):
        a, c = pytree.tree_unflatten(inputs, spec)
        out = body(*a, *c)
        leaves, shape["spec"] = pytree.tree_flatten(out)
        shape["tensor"] = [isinstance(x, torch.Tensor) for x in leaves]
        shape["other"] = [x for x in leaves if not isinstance(x, torch.Tensor)]
        return tuple(x for x in leaves if isinstance(x, torch.Tensor))
    outs = _Scaled.apply(counter, float(n), run, *flat)
    ts, others = iter(outs), iter(shape["other"])
    leaves = [next(ts) if is_t else next(others) for is_t in shape["tensor"]]
    if torch.is_grad_enabled():
        # the sums of a shared tensor's gradient over the n bodies: counted
        # when its gradient comes, as the backward's part
        grads_of = [c for c in _tensors(consts) if c.requires_grad]
        if grads_of and n > 1:
            hold = [x for x in outs if x.requires_grad]
            if hold:
                hold[0].register_hook(lambda g: (_accumulated(
                    counter, grads_of, n), g)[1])
    return pytree.tree_unflatten(leaves, shape["spec"])


def layers(body: Callable, items: Sequence, carry, *consts):
    """``carry`` through ``carry = body(item, carry, *consts)`` for each of
    ``items`` in order: a model's identical layers (or hybrid groups),
    ``consts`` what every body reads (the hybrid's shared block).  Under
    a scaled count, the first item's body alone, counted ``len(items)``
    times forward and backward."""
    c = _current()
    if c is None or not c.scale or len(items) < 2:
        for item in items:
            carry = body(item, carry, *consts)
        return carry
    return _run_scaled(c, len(items), lambda item, cr, *k: body(item, cr, *k),
                       (items[0], carry), consts)


def scan(step: Callable, carry, xs: Sequence, *consts):
    """``(carry, ys)``: ``carry, y = step(carry, x_t, *consts)`` for each
    ``x_t`` of ``xs`` (a list of per-step inputs, each a tuple), ``ys`` the
    list of the ``y``s: a recurrence over time.  Under a scaled count the
    first and the last step run as they are (the first reads a carry that
    needs no gradient, the last's carry gets none) and step 1 alone stands
    for the ``len(xs) - 2`` between them; ``ys`` holds detached copies of
    its ``y`` for the steps not run."""
    c = _current()
    n = len(xs)
    if c is None or not c.scale or n < 4:
        ys = []
        for x in xs:
            carry, y = step(carry, x, *consts)
            ys.append(y)
        return carry, ys
    carry, first = step(carry, xs[0], *consts)
    carry, y = _run_scaled(c, n - 2, step, (carry, xs[1]), consts)
    carry, last = step(carry, xs[-1], *consts)
    return carry, [first, y] + [y.detach()] * (n - 3) + [last]


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def count(fn: Callable, *args, scale: bool = True, **kwargs):
    """``(fn(*args, **kwargs), Counter)``: the call run under a
    :class:`Counter`."""
    counter = Counter(scale=scale)
    with counter:
        out = fn(*args, **kwargs)
    return out, counter


def analyze_text(fn: Callable, *args, scale: bool = True,
                 **kwargs) -> Totals:
    """The :class:`Totals` of one call ``fn(*args, **kwargs)`` (the
    reference's ``analyze_text`` reads a compiled HLO module's text; the
    port counts the call's op stream: module docstring)."""
    return count(fn, *args, scale=scale, **kwargs)[1].totals


def causal_pairs(sq: int, sk: int, q_offset: int = 0,
                 causal: bool = True) -> int:
    """The (query, key) pairs attention computes: every pair, or with
    ``causal`` those with key position <= query position + ``q_offset``
    (``sum(min(q_offset + r + 1, sk) for r in range(sq))``)."""
    if not causal:
        return sq * sk
    full = max(0, min(sq, sk - q_offset))     # rows below the last key
    pairs = full * (q_offset + 1) + full * (full - 1) // 2
    return pairs + (sq - full) * sk

