"""Stage III (torch backend): purely imperative DPIA -> torch tensor code.

The port's counterpart of ``repro.core.dpia.stage3_jnp``, the analogue of the
paper's Fig. 6 translation: commands become store transformers (the store is
a dict of buffers), acceptors resolve to (root, index-path) l-values exactly
as in Fig. 6b, and expressions are evaluated by the functional interpreter
(Fig. 6c).  ``for``/``parfor`` are python loops in index order (the
reference execution order; the CUDA generator gives ``parfor`` its parallel
reading).

Unlike the reference, which rebuilds immutable arrays, writes go into the
store's tensors in place (``copy_`` into an indexed view): one buffer per
``new`` instead of one per write.  Every value is computed in full before it
is written, so an in-place write never reads what it overwrites.

This is the port's reference Stage III and the plain version of the
generated CUDA kernels (:mod:`.stage3_cuda`), registered as backend
``"torch"`` (alias ``"dpia-torch"``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from . import phrases as P
from . import stage2
from .interp import device_of, interp
from .types import AccT, Arr, ExpT, Idx, VarT, Vec, map_leaves, zero_value

Store = Dict[str, object]

FST, SND = "fst", "snd"


# ---------------------------------------------------------------------------
# l-value writes: set_path + acceptor resolution (Fig. 6b)
# ---------------------------------------------------------------------------

def _copy_into(target: torch.Tensor, value) -> None:
    if not isinstance(value, torch.Tensor):
        value = torch.as_tensor(value)
    if value.numel() == target.numel():
        value = value.reshape(target.shape)
    if value.device == target.device and \
            value.untyped_storage().data_ptr() == \
            target.untyped_storage().data_ptr():
        value = value.clone()        # a view of the buffer being written
    target.copy_(value)


def set_path(buf, path: Sequence, value) -> None:
    """Write ``value`` into ``buf`` at ``path``, in place.

    Path components: integer indices, ('ds', start, size) slices along the
    next axis, and 'fst'/'snd' pair projections (which may sit anywhere in
    the path: pairs are struct-of-arrays)."""
    if isinstance(buf, tuple):
        for k, comp in enumerate(path):
            if comp in (FST, SND):
                rest = list(path[:k]) + list(path[k + 1:])
                set_path(buf[0 if comp == FST else 1], rest, value)
                return
        # whole-pair write: value must be a matching tuple
        for bi, vi in zip(buf, value):
            set_path(bi, path, vi)
        return
    idx = []
    for comp in path:
        if comp in (FST, SND):
            raise TypeError("pair projection applied to a non-pair buffer")
        if isinstance(comp, tuple) and comp[0] == "ds":
            idx.append(slice(comp[1], comp[1] + comp[2]))
        else:
            idx.append(int(comp))
    _copy_into(buf[tuple(idx)] if idx else buf, value)


def _reshape_leading(value, old, new):
    """Re-view the leading axes of every leaf of ``value``."""
    return map_leaves(
        lambda l: l.reshape(tuple(new) + tuple(l.shape[len(old):])), value)


def fold_acc(a: P.Phrase, idxs: List, value, eval_i, leaf):  # noqa: C901
    """Resolve an acceptor phrase down to its root, threading the index path
    (Fig. 6b discipline).  ``eval_i`` evaluates index expressions; ``leaf`` is
    called as ``leaf(root_phrase, idxs, value)`` at a Var / AccPart root."""
    if isinstance(a, P.Var):
        assert isinstance(a.t, AccT), f"write through non-acceptor {a.t}"
        return leaf(a, idxs, value)
    if isinstance(a, P.AccPart):
        v = a.v
        if isinstance(v, P.VView):
            return fold_acc(v.acc, idxs, value, eval_i, leaf)
        assert isinstance(v, P.Var) and isinstance(v.t, VarT)
        return leaf(a, idxs, value)
    if isinstance(a, P.IdxAcc):
        return fold_acc(a.a, [eval_i(a.i)] + idxs, value, eval_i, leaf)
    if isinstance(a, P.SplitAcc):
        # self: acc[(m*n).d]; inner: acc[m.n.d]
        n = a.n
        if idxs:
            i, rest = idxs[0], idxs[1:]
            if isinstance(i, tuple) and i[0] == "ds":
                _, s0, sz = i
                if s0 % n == 0 and sz % n == 0 and not rest:
                    return fold_acc(
                        a.a, [("ds", s0 // n, sz // n)],
                        _reshape_leading(value, (sz,), (sz // n, n)),
                        eval_i, leaf)
                raise TypeError(
                    "splitAcc: unaligned slice writes across chunks")
            return fold_acc(a.a, [i // n, i % n] + rest, value, eval_i, leaf)
        inner_d = P.acc_data(a.a)
        assert isinstance(inner_d, Arr)
        m = inner_d.n
        return fold_acc(a.a, [], _reshape_leading(value, (m * n,), (m, n)),
                        eval_i, leaf)
    if isinstance(a, P.JoinAcc):
        # self: acc[k.m.d]; inner: acc[(k*m).d]
        m = a.m
        if len(idxs) >= 2:
            i, j, rest = idxs[0], idxs[1], idxs[2:]
            if isinstance(i, tuple) or isinstance(j, tuple):
                raise TypeError("joinAcc: mixed slice/index writes unsupported")
            return fold_acc(a.a, [i * m + j] + rest, value, eval_i, leaf)
        if len(idxs) == 1:
            i = idxs[0]
            if isinstance(i, tuple) and i[0] == "ds":
                _, s0, sz = i
                return fold_acc(
                    a.a, [("ds", s0 * m, sz * m)],
                    _reshape_leading(value, (sz, m), (sz * m,)),
                    eval_i, leaf)
            return fold_acc(a.a, [("ds", i * m, m)], value, eval_i, leaf)
        d = P.acc_data(a)
        assert isinstance(d, Arr)
        return fold_acc(a.a, [], _reshape_leading(value, (d.n, m), (d.n * m,)),
                        eval_i, leaf)
    if isinstance(a, P.TransposeAcc):
        # self: acc[n.m.d]; inner: acc[m.n.d] — swap leading index pair.
        if len(idxs) >= 2:
            i, j, rest = idxs[0], idxs[1], idxs[2:]
            return fold_acc(a.a, [j, i] + rest, value, eval_i, leaf)
        if len(idxs) == 1:
            raise TypeError("transposeAcc: single-index (column) writes "
                            "unsupported; write whole or per-element")
        value_t = map_leaves(lambda l: l.transpose(0, 1), value)
        return fold_acc(a.a, [], value_t, eval_i, leaf)
    if isinstance(a, (P.PairAcc1, P.ZipAcc1)):
        return fold_acc(a.a, [FST] + idxs, value, eval_i, leaf)
    if isinstance(a, (P.PairAcc2, P.ZipAcc2)):
        return fold_acc(a.a, [SND] + idxs, value, eval_i, leaf)
    if isinstance(a, P.AsScalarAcc):
        # self: acc[(m*w).num]; inner: acc[m.num<w>]
        inner_d = P.acc_data(a.a)
        assert isinstance(inner_d, Arr) and isinstance(inner_d.elem, Vec)
        m, w = inner_d.n, inner_d.elem.n
        if idxs:
            i, rest = idxs[0], idxs[1:]
            if isinstance(i, tuple) and i[0] == "ds":
                _, s0, sz = i
                if s0 % w == 0 and sz % w == 0 and not rest:
                    return fold_acc(
                        a.a, [("ds", s0 // w, sz // w)],
                        _reshape_leading(value, (sz,), (sz // w, w)),
                        eval_i, leaf)
                raise TypeError("asScalarAcc: unaligned slice write")
            return fold_acc(a.a, [i // w, i % w] + rest, value, eval_i, leaf)
        return fold_acc(a.a, [], _reshape_leading(value, (m * w,), (m, w)),
                        eval_i, leaf)
    if isinstance(a, P.AsVectorAcc):
        # self: acc[m.num<w>]; inner: acc[(m*w).num]
        w = a.w
        if len(idxs) >= 2:
            i, j, rest = idxs[0], idxs[1], idxs[2:]
            if isinstance(i, tuple) or isinstance(j, tuple):
                raise TypeError("asVectorAcc: mixed slice/index unsupported")
            return fold_acc(a.a, [i * w + j] + rest, value, eval_i, leaf)
        if len(idxs) == 1:
            i = idxs[0]
            if isinstance(i, tuple) and i[0] == "ds":
                _, s0, sz = i
                return fold_acc(
                    a.a, [("ds", s0 * w, sz * w)],
                    _reshape_leading(value, (sz, w), (sz * w,)),
                    eval_i, leaf)
            return fold_acc(a.a, [("ds", i * w, w)], value, eval_i, leaf)
        d = P.acc_data(a)
        assert isinstance(d, Arr)
        return fold_acc(a.a, [], _reshape_leading(value, (d.n, w), (d.n * w,)),
                        eval_i, leaf)
    raise TypeError(f"fold_acc: unhandled acceptor {type(a).__name__}")


def _index(v) -> int:
    return int(v) if isinstance(v, torch.Tensor) else v


def write_acc(a: P.Phrase, idxs: List, value, env, store: Store) -> Store:
    """Resolve an acceptor phrase and write ``value`` into the store."""
    def leaf(root, path, val):
        name = root.name if isinstance(root, P.Var) else root.v.name
        set_path(store[name], path, val)
        return store

    return fold_acc(a, idxs, value,
                    lambda i: _index(interp(i, env, store)), leaf)


# ---------------------------------------------------------------------------
# Command execution (store-passing, in place)
# ---------------------------------------------------------------------------

def exec_comm(p: P.Phrase, env: Dict, store: Store) -> Store:  # noqa: C901
    if isinstance(p, P.Skip):
        return store
    if isinstance(p, P.SeqC):
        return exec_comm(p.c2, env, exec_comm(p.c1, env, store))
    if isinstance(p, P.Assign):
        value = interp(p.e, env, store)
        return write_acc(p.a, [], value, env, store)
    if isinstance(p, P.New):
        v = P.Var(P.fresh("buf"), VarT(p.d))
        store[v.name] = zero_value(p.d, device_of(store))
        exec_comm(p.f(v), env, store)
        del store[v.name]
        return store
    if isinstance(p, P.For):
        return _run_loop(p.n, lambda i: p.f(i), env, store)
    if isinstance(p, P.ParFor):
        # Reference (sequential) execution order; race freedom was checked
        # upstream, so every order agrees.
        return _run_loop(p.n, lambda i: p.f(i, P.IdxAcc(p.a, i)), env, store)
    if isinstance(p, (P.MapI, P.ReduceI)):
        return exec_comm(stage2.expand(p), env, store)
    raise TypeError(f"exec_comm: not a command: {type(p).__name__}")


def _run_loop(n: int, mk_body, env: Dict, store: Store) -> Store:
    i_probe = P.Var(P.fresh("i"), ExpT(Idx(n)))
    body = mk_body(i_probe)
    for k in range(n):
        exec_comm(body, {**env, i_probe.name: k}, store)
    return store


# ---------------------------------------------------------------------------
# Whole-pipeline entry points
# ---------------------------------------------------------------------------

def run_command(cmd: P.Phrase, d, names: Sequence[str], out_name: str,
                args) -> object:
    """Run an imperative command with ``args`` bound to ``names`` and return
    the final value of the output buffer (of data type ``d``)."""
    env = dict(zip(names, args))
    store: Store = {out_name: zero_value(d, device_of(env))}
    exec_comm(cmd, env, store)
    return store[out_name]


def translate(expr: P.Phrase, *, check: bool = True, lowered=None):
    """(command, out Var) of Stages I-II, race-checked when ``check``."""
    from . import check as chk
    from . import stage1

    if lowered is not None:
        cmd, out = lowered
    else:
        out = P.Var("out#", AccT(P.exp_data(expr)))
        cmd = stage2.expand(stage1.translate(expr, out))
    if check:
        P.type_of(cmd)
        chk.check_race_free(cmd)
    return cmd, out


def compile_expr(expr: P.Phrase, arg_vars, *, check: bool = True,
                 lowered=None):
    """Functional expression -> python callable via Stages I-III (torch).

    ``lowered`` optionally supplies an already-translated ``(command,
    out_var)`` pair (the staged ``repro_torch.compiler`` path) so Stage I/II
    is not redone here."""
    cmd, out = translate(expr, check=check, lowered=lowered)
    names = [v.name for v in arg_vars]
    d = out.t.d

    def fn(*args):
        return run_command(cmd, d, names, out.name, args)

    return fn


# self-register as a Stage III target (see repro_torch.compiler.backends)
from ...compiler.backends import Backend as _Backend  # noqa: E402
from ...compiler.backends import register_backend as _register  # noqa: E402

_register(_Backend(
    name="torch", compile=compile_expr, accepts=("check", "lowered"),
    description="imperative DPIA -> torch tensor code (python loops in the "
                "reference order; the plain version of the generated "
                "kernels)"),
    aliases=("dpia-torch",), overwrite=True)
