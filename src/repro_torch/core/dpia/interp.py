"""Functional reference semantics of DPIA expressions (paper section 5.2), in
torch.

``interp(E, env)`` is the denotation [[E]] used as the oracle for translation
correctness (Theorem 5.1 as an executable property).  Values are torch
tensors or tuples of them:

  * ``Arr(n, d)``   -> leading axis of size n on every leaf
  * ``Pair(a, b)``  -> python 2-tuple (struct-of-arrays)
  * ``Vec(w, dt)``  -> trailing lane axis of size w
  * ``Num/Idx``     -> 0-d tensors (loop indices may be python ints)

The port's copy of ``repro.core.dpia.interp``.  Where the reference gives
``map`` its parallel reading with ``jax.vmap``, this one writes the batch
dimension out: the body is evaluated per element and the results stacked.
``reduce`` (``lax.scan`` there) is a python loop.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from . import phrases as P
from .types import Arr, ExpT, dtype_of, map_leaves, shape_of, torch_dtype

Env = Dict[str, object]

_UNOPS: Dict[str, Callable] = {
    "neg": torch.neg,
    "exp": torch.exp,
    "log": torch.log,
    "abs": torch.abs,
    "rsqrt": torch.rsqrt,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}

_BINOPS: Dict[str, Callable] = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "max": torch.maximum,
    "min": torch.minimum,
}


def _leaves(v):
    if isinstance(v, tuple):
        for part in v:
            yield from _leaves(part)
    else:
        yield v


def device_of(env: Env) -> torch.device:
    """The device of the first tensor among ``env``'s values (CPU if none)."""
    for v in env.values():
        for leaf in _leaves(v):
            if isinstance(leaf, torch.Tensor):
                return leaf.device
    return torch.device("cpu")


def _tensor(v, device):
    return v if isinstance(v, torch.Tensor) else torch.tensor(v, device=device)


def interp(p: P.Phrase, env: Env, store: Optional[Env] = None,
           device=None):  # noqa: C901
    """Denotation of a functional expression phrase.

    ``store`` optionally resolves ``ExpPart`` reads of imperative variables —
    used when the same evaluator serves as the expression (r-value) evaluator
    of the imperative backend (paper Fig. 6c).  ``device`` places literals;
    it defaults to the device of the environment's tensors."""
    if device is None:
        device = device_of(env) if env else (
            device_of(store) if store else torch.device("cpu"))
    rec = lambda q: interp(q, env, store, device)  # noqa: E731

    if isinstance(p, P.Var):
        try:
            return env[p.name]
        except KeyError:
            raise NameError(f"unbound DPIA variable {p.name!r}") from None
    if isinstance(p, P.ExpPart):
        v = p.v
        if isinstance(v, P.VView):
            return rec(v.exp)
        assert isinstance(v, P.Var), "ExpPart of non-variable"
        src = store if store is not None and v.name in store else env
        return src[v.name]
    if isinstance(p, P.Lit):
        return torch.full(shape_of(p.d), p.value,
                          dtype=torch_dtype(dtype_of(p.d)), device=device)
    if isinstance(p, P.UnOp):
        return _UNOPS[p.op](_tensor(rec(p.e), device))
    if isinstance(p, P.BinOp):
        return _BINOPS[p.op](_tensor(rec(p.a), device),
                             _tensor(rec(p.b), device))
    if isinstance(p, P.Map):
        xs = rec(p.e)
        d = P.exp_data(p.e)
        assert isinstance(d, Arr)
        x = P.Var(P.fresh("x"), ExpT(d.elem))
        body = p.f(x)
        outs = [interp(body, {**env, x.name: map_leaves(lambda l: l[k], xs)},
                       store, device) for k in range(d.n)]
        return map_leaves(lambda *ls: torch.stack(ls), *outs)
    if isinstance(p, P.Reduce):
        xs = rec(p.e)
        acc_v = rec(p.init)
        d = P.exp_data(p.e)
        assert isinstance(d, Arr)
        x = P.Var(P.fresh("x"), ExpT(d.elem))
        acc = P.Var(P.fresh("acc"), P.type_of(p.init))
        body = p.f(x, acc)
        for k in range(d.n):
            acc_v = interp(body, {**env, x.name: map_leaves(lambda l: l[k], xs),
                                  acc.name: acc_v}, store, device)
        return acc_v
    if isinstance(p, P.Zip):
        return (rec(p.a), rec(p.b))
    if isinstance(p, P.Split):
        return map_leaves(
            lambda l: l.reshape((l.shape[0] // p.n, p.n) + tuple(l.shape[1:])),
            rec(p.e))
    if isinstance(p, P.Join):
        return map_leaves(
            lambda l: l.reshape((l.shape[0] * l.shape[1],)
                                + tuple(l.shape[2:])), rec(p.e))
    if isinstance(p, P.PairE):
        return (rec(p.a), rec(p.b))
    if isinstance(p, P.Fst):
        return rec(p.e)[0]
    if isinstance(p, P.Snd):
        return rec(p.e)[1]
    if isinstance(p, P.IdxE):
        v = rec(p.e)
        i = rec(p.i)
        i = int(i) if isinstance(i, torch.Tensor) else i
        return map_leaves(lambda l: l[i], v)
    if isinstance(p, P.AsVector):
        v = rec(p.e)
        return v.reshape((v.shape[0] // p.w, p.w))
    if isinstance(p, P.AsScalar):
        v = rec(p.e)
        return v.reshape((v.shape[0] * v.shape[1],))
    if isinstance(p, P.Transpose):
        return map_leaves(lambda l: l.transpose(0, 1), rec(p.e))
    if isinstance(p, P.DotBlock):
        a, b = rec(p.a), rec(p.b)
        return torch.matmul(a.float(), b.float()).to(torch_dtype(p.acc_dtype))
    if isinstance(p, P.FullReduce):
        v = rec(p.e)
        return v.sum() if p.op == "add" else v.amax()
    if isinstance(p, P.ToMem):
        return rec(p.e)
    raise TypeError(f"interp: not a functional expression: {type(p).__name__}")

