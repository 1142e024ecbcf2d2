"""DPIA types: data types and phrase types (paper Fig. 1).

Data types classify *data* (what lives in buffers); phrase types classify
*program parts* (expressions, acceptors, commands, functions) — the defining
split of Idealised Algol.

The port's copy of ``repro.core.dpia.types``, with the same adaptations:
  * ``Num`` carries a dtype (the paper has a single ``num``).
  * ``Vec`` is the paper's OpenCL vector type ``num<n>`` (section 6.2); the
    reference uses it for lane-aligned blocks (width 128 rather than 4).
  * Sizes are concrete Python ints, so the paper's symbolic nat-indexed
    types specialise to concrete indices at compile time; the type-equality
    rule (Fig. 1c) becomes integer equality.
Buffers are torch tensors: ``zero_value`` makes them on a given device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple, Union

import numpy as np


# ---------------------------------------------------------------------------
# Data types  (Fig. 1e)
# ---------------------------------------------------------------------------

class DataType:
    """Base class of DPIA data types."""

    def __repr__(self) -> str:  # pragma: no cover - trivial
        return show_data(self)


@dataclass(frozen=True)
class Num(DataType):
    """Scalar numeric data; ``dtype`` is a numpy-style dtype name."""
    dtype: str = "float32"


@dataclass(frozen=True)
class Idx(DataType):
    """Array index bounded by ``n`` (the paper's ``idx(n)``)."""
    n: int


@dataclass(frozen=True)
class Arr(DataType):
    """Homogeneous array ``n.elem`` of size ``n``."""
    n: int
    elem: DataType


@dataclass(frozen=True)
class Pair(DataType):
    """Heterogeneous pair ``fst x snd`` (struct-of-arrays in buffers)."""
    fst: DataType
    snd: DataType


@dataclass(frozen=True)
class Vec(DataType):
    """Vector type ``num<n>`` (paper section 6.2): a lane-aligned block."""
    n: int
    dtype: str = "float32"


def arr(*dims: int, elem: DataType = None, dtype: str = "float32") -> DataType:
    """``arr(4, 8)`` == ``Arr(4, Arr(8, Num()))``."""
    e = elem if elem is not None else Num(dtype)
    for d in reversed(dims):
        e = Arr(d, e)
    return e


def show_data(d: DataType) -> str:
    if isinstance(d, Num):
        return f"num[{d.dtype}]" if d.dtype != "float32" else "num"
    if isinstance(d, Idx):
        return f"idx({d.n})"
    if isinstance(d, Arr):
        return f"{d.n}.{show_data(d.elem)}"
    if isinstance(d, Pair):
        return f"({show_data(d.fst)} x {show_data(d.snd)})"
    if isinstance(d, Vec):
        return f"num<{d.n}>[{d.dtype}]"
    raise TypeError(f"not a data type: {d!r}")


def data_eq(a: DataType, b: DataType) -> bool:
    """Type equality (Fig. 1c); sizes are concrete so this is structural."""
    return a == b


def shape_of(d: DataType) -> Tuple[int, ...]:
    """Leading array shape of a data type, stopping at Pair boundaries."""
    if isinstance(d, Arr):
        return (d.n,) + shape_of(d.elem)
    if isinstance(d, Vec):
        return (d.n,)
    return ()


def scalar_of(d: DataType) -> DataType:
    """The non-array core reached by stripping Arr/Vec nesting."""
    if isinstance(d, Arr):
        return scalar_of(d.elem)
    if isinstance(d, Vec):
        return Num(d.dtype)
    return d


def dtype_of(d: DataType) -> str:
    """dtype of a (possibly nested-array) numeric data type."""
    core = scalar_of(d)
    if isinstance(core, Num):
        return core.dtype
    if isinstance(core, Idx):
        return "int32"
    raise TypeError(f"no single dtype for {show_data(d)}")


def is_numeric(d: DataType) -> bool:
    return isinstance(scalar_of(d), (Num, Idx))


def size_in_elems(d: DataType) -> int:
    if isinstance(d, (Num, Idx)):
        return 1
    if isinstance(d, Vec):
        return d.n
    if isinstance(d, Arr):
        return d.n * size_in_elems(d.elem)
    if isinstance(d, Pair):
        return size_in_elems(d.fst) + size_in_elems(d.snd)
    raise TypeError(d)


def torch_dtype(name: str):
    """The torch dtype of a DPIA dtype name (``"float32"`` -> torch.float32)."""
    import torch
    return getattr(torch, name)


def zero_value(d: DataType, device=None):
    """Zero-initialised buffer for a data type (paper: ``new`` zero-init).

    Buffers are torch tensors or tuples of them: Arr adds a leading axis,
    Pair becomes a python tuple (struct-of-arrays), Vec adds a trailing lane
    axis."""
    import torch

    if isinstance(d, Num):
        return torch.zeros((), dtype=torch_dtype(d.dtype), device=device)
    if isinstance(d, Idx):
        return torch.zeros((), dtype=torch.int32, device=device)
    if isinstance(d, Vec):
        return torch.zeros((d.n,), dtype=torch_dtype(d.dtype), device=device)
    if isinstance(d, Arr):
        return map_leaves(
            lambda leaf: leaf.expand((d.n,) + tuple(leaf.shape)).clone(),
            zero_value(d.elem, device))
    if isinstance(d, Pair):
        return (zero_value(d.fst, device), zero_value(d.snd, device))
    raise TypeError(d)


def map_leaves(fn, *trees):
    """Apply ``fn`` leafwise over buffers that share one tuple structure."""
    if isinstance(trees[0], tuple):
        return tuple(map_leaves(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def value_matches(d: DataType, v) -> bool:
    """Does a buffer pytree ``v`` inhabit data type ``d``?"""
    if isinstance(d, (Num, Idx)):
        return hasattr(v, "shape") and v.shape == ()
    if isinstance(d, Vec):
        return hasattr(v, "shape") and v.shape == (d.n,)
    if isinstance(d, Arr):
        if isinstance(v, tuple):
            return all(
                value_matches(Arr(d.n, sub), piece)
                for sub, piece in zip(_pair_parts(d.elem), v)
            )
        return hasattr(v, "shape") and len(v.shape) >= 1 and v.shape[0] == d.n
    if isinstance(d, Pair):
        return isinstance(v, tuple) and len(v) == 2
    return False


def _pair_parts(d: DataType):
    if isinstance(d, Pair):
        return (d.fst, d.snd)
    return (d,)


# ---------------------------------------------------------------------------
# Phrase types  (Fig. 1f) and passivity (Fig. 2)
# ---------------------------------------------------------------------------

class PhraseType:
    def __repr__(self) -> str:  # pragma: no cover - trivial
        return show_phrase_type(self)


@dataclass(frozen=True)
class ExpT(PhraseType):
    """Expression phrases: read the store, produce data of type ``d``."""
    d: DataType


@dataclass(frozen=True)
class AccT(PhraseType):
    """Acceptor phrases: writable l-values for data of type ``d``."""
    d: DataType


@dataclass(frozen=True)
class CommT(PhraseType):
    """Command phrases: modify the store."""


@dataclass(frozen=True)
class VarT(PhraseType):
    """``var[d] = acc[d] x exp[d]`` — the phrase pair introduced by ``new``."""
    d: DataType


@dataclass(frozen=True)
class FnT(PhraseType):
    """Phrase functions; ``passive=True`` is the paper's ``->p`` arrow."""
    arg: PhraseType
    ret: PhraseType
    passive: bool = False


def show_phrase_type(t: PhraseType) -> str:
    if isinstance(t, ExpT):
        return f"exp[{show_data(t.d)}]"
    if isinstance(t, AccT):
        return f"acc[{show_data(t.d)}]"
    if isinstance(t, CommT):
        return "comm"
    if isinstance(t, VarT):
        return f"var[{show_data(t.d)}]"
    if isinstance(t, FnT):
        arrow = "->p" if t.passive else "->"
        return f"({show_phrase_type(t.arg)} {arrow} {show_phrase_type(t.ret)})"
    raise TypeError(f"not a phrase type: {t!r}")


def is_passive(t: PhraseType) -> bool:
    """Fig. 2: exp types are passive; functions are passive if their return
    type is; ``->p`` functions are passive outright; acc/comm/var are active.
    """
    if isinstance(t, ExpT):
        return True
    if isinstance(t, (AccT, CommT, VarT)):
        return False
    if isinstance(t, FnT):
        return t.passive or is_passive(t.ret)
    raise TypeError(t)


def promote_dtype(a: str, b: str) -> str:
    return str(np.promote_types(a, b))
