"""JSON round-tripping for DPIA phrases — the AOT persistence format.

The port's copy of ``repro.compiler.serialize``: the same document layout
and ``FORMAT_VERSION``, so a program exported by either package loads in
the other.

``Program.export()`` persists *lowered* imperative commands (the Stage I->II
output) so a later process can jump straight to Stage III without redoing
translation, expansion, or the SCIR check.  The on-disk form is plain JSON:
human-inspectable, diff-able, and versioned.

HOAS binders (the callable fields of ``Map``/``Reduce``/``New``/``For``/
``ParFor``/``MapI``/``ReduceI``) are handled the same way the pretty printer
and the checker handle them: at *save* time each binder is instantiated with
fresh, typed ``Var``s and its body is serialised with those names free; at
*load* time the binder becomes a substitution closure — applying it
deserialises the body with the actual arguments bound in the environment, so
beta reduction stays ordinary function application, exactly as in the live
AST.

Serialisation is total over the phrase grammar of ``phrases.py``; an unknown
node (e.g. from a future grammar extension) raises ``SerializeError`` rather
than silently writing a partial document.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

from ..core.dpia import phrases as P
from ..core.dpia.types import (
    AccT, Arr, CommT, DataType, ExpT, Idx, Num, Pair, PhraseType, Vec, VarT,
)

__all__ = [
    "SerializeError", "FORMAT_VERSION",
    "data_to_doc", "data_from_doc", "ptype_to_doc", "ptype_from_doc",
    "phrase_to_doc", "phrase_from_doc", "var_to_doc", "var_from_doc",
]

FORMAT_VERSION = 1


class SerializeError(ValueError):
    pass


# ---------------------------------------------------------------------------
# data types
# ---------------------------------------------------------------------------

def data_to_doc(d: DataType) -> dict:
    if isinstance(d, Num):
        return {"t": "num", "dtype": d.dtype}
    if isinstance(d, Idx):
        return {"t": "idx", "n": d.n}
    if isinstance(d, Arr):
        return {"t": "arr", "n": d.n, "elem": data_to_doc(d.elem)}
    if isinstance(d, Pair):
        return {"t": "pair", "fst": data_to_doc(d.fst),
                "snd": data_to_doc(d.snd)}
    if isinstance(d, Vec):
        return {"t": "vec", "n": d.n, "dtype": d.dtype}
    raise SerializeError(f"not a serialisable data type: {d!r}")


def data_from_doc(doc: dict) -> DataType:
    t = doc["t"]
    if t == "num":
        return Num(doc["dtype"])
    if t == "idx":
        return Idx(int(doc["n"]))
    if t == "arr":
        return Arr(int(doc["n"]), data_from_doc(doc["elem"]))
    if t == "pair":
        return Pair(data_from_doc(doc["fst"]), data_from_doc(doc["snd"]))
    if t == "vec":
        return Vec(int(doc["n"]), doc["dtype"])
    raise SerializeError(f"unknown data-type tag {t!r}")


def ptype_to_doc(t: PhraseType) -> dict:
    if isinstance(t, ExpT):
        return {"p": "exp", "d": data_to_doc(t.d)}
    if isinstance(t, AccT):
        return {"p": "acc", "d": data_to_doc(t.d)}
    if isinstance(t, VarT):
        return {"p": "var", "d": data_to_doc(t.d)}
    if isinstance(t, CommT):
        return {"p": "comm"}
    raise SerializeError(f"not a serialisable phrase type: {t!r}")


def ptype_from_doc(doc: dict) -> PhraseType:
    p = doc["p"]
    if p == "exp":
        return ExpT(data_from_doc(doc["d"]))
    if p == "acc":
        return AccT(data_from_doc(doc["d"]))
    if p == "var":
        return VarT(data_from_doc(doc["d"]))
    if p == "comm":
        return CommT()
    raise SerializeError(f"unknown phrase-type tag {p!r}")


def var_to_doc(v: P.Var) -> dict:
    return {"name": v.name, "t": ptype_to_doc(v.t)}


def var_from_doc(doc: dict) -> P.Var:
    return P.Var(doc["name"], ptype_from_doc(doc["t"]))


# ---------------------------------------------------------------------------
# strategy levels
# ---------------------------------------------------------------------------

def _par_to_doc(level: P.Par) -> dict:
    return {"kind": level.kind, "axis": level.axis}


def _par_from_doc(doc: dict) -> P.Par:
    return P.Par(doc["kind"], doc["axis"])


# ---------------------------------------------------------------------------
# phrases
# ---------------------------------------------------------------------------

def _elem_of(e: P.Phrase) -> DataType:
    d = P.exp_data(e)
    if not isinstance(d, Arr):
        raise SerializeError(f"binder input is not an array: {d!r}")
    return d.elem


def _fn_to_doc(f: Callable, binder_types: Sequence[PhraseType]) -> dict:
    vs = [P.Var(P.fresh("s"), t) for t in binder_types]
    return {"params": [var_to_doc(v) for v in vs],
            "body": phrase_to_doc(f(*vs))}


def _fn_from_doc(doc: dict, env: Dict[str, P.Phrase]) -> Callable:
    names = [p["name"] for p in doc["params"]]
    body = doc["body"]
    outer = dict(env)

    def f(*args: P.Phrase) -> P.Phrase:
        inner = dict(outer)
        inner.update(zip(names, args))
        return phrase_from_doc(body, inner)

    return f


def phrase_to_doc(p: P.Phrase) -> dict:  # noqa: C901 - structural dispatch
    if isinstance(p, P.Var):
        return {"n": "Var", "name": p.name, "t": ptype_to_doc(p.t)}
    if isinstance(p, P.Lit):
        return {"n": "Lit", "value": p.value, "d": data_to_doc(p.d)}
    if isinstance(p, P.UnOp):
        return {"n": "UnOp", "op": p.op, "e": phrase_to_doc(p.e)}
    if isinstance(p, P.BinOp):
        return {"n": "BinOp", "op": p.op, "a": phrase_to_doc(p.a),
                "b": phrase_to_doc(p.b)}
    if isinstance(p, P.Map):
        return {"n": "Map", "level": _par_to_doc(p.level), "space": p.space,
                "e": phrase_to_doc(p.e),
                "f": _fn_to_doc(p.f, [ExpT(_elem_of(p.e))])}
    if isinstance(p, P.Reduce):
        return {"n": "Reduce", "level": _par_to_doc(p.level),
                "init": phrase_to_doc(p.init), "e": phrase_to_doc(p.e),
                "f": _fn_to_doc(p.f, [ExpT(_elem_of(p.e)),
                                      ExpT(P.exp_data(p.init))])}
    if isinstance(p, P.Zip):
        return {"n": "Zip", "a": phrase_to_doc(p.a), "b": phrase_to_doc(p.b)}
    if isinstance(p, P.Split):
        return {"n": "Split", "size": p.n, "e": phrase_to_doc(p.e)}
    if isinstance(p, P.Join):
        return {"n": "Join", "e": phrase_to_doc(p.e)}
    if isinstance(p, P.PairE):
        return {"n": "PairE", "a": phrase_to_doc(p.a), "b": phrase_to_doc(p.b)}
    if isinstance(p, P.Fst):
        return {"n": "Fst", "e": phrase_to_doc(p.e)}
    if isinstance(p, P.Snd):
        return {"n": "Snd", "e": phrase_to_doc(p.e)}
    if isinstance(p, P.IdxE):
        return {"n": "IdxE", "e": phrase_to_doc(p.e), "i": phrase_to_doc(p.i)}
    if isinstance(p, P.AsVector):
        return {"n": "AsVector", "w": p.w, "e": phrase_to_doc(p.e)}
    if isinstance(p, P.AsScalar):
        return {"n": "AsScalar", "e": phrase_to_doc(p.e)}
    if isinstance(p, P.Transpose):
        return {"n": "Transpose", "e": phrase_to_doc(p.e)}
    if isinstance(p, P.DotBlock):
        return {"n": "DotBlock", "a": phrase_to_doc(p.a),
                "b": phrase_to_doc(p.b), "acc_dtype": p.acc_dtype}
    if isinstance(p, P.FullReduce):
        return {"n": "FullReduce", "op": p.op, "e": phrase_to_doc(p.e)}
    if isinstance(p, P.ToMem):
        return {"n": "ToMem", "space": p.space, "e": phrase_to_doc(p.e)}
    if isinstance(p, P.Skip):
        return {"n": "Skip"}
    if isinstance(p, P.SeqC):
        return {"n": "SeqC", "c1": phrase_to_doc(p.c1),
                "c2": phrase_to_doc(p.c2)}
    if isinstance(p, P.Assign):
        return {"n": "Assign", "a": phrase_to_doc(p.a),
                "e": phrase_to_doc(p.e)}
    if isinstance(p, P.New):
        return {"n": "New", "d": data_to_doc(p.d), "space": p.space,
                "f": _fn_to_doc(p.f, [VarT(p.d)])}
    if isinstance(p, P.For):
        return {"n": "For", "size": p.n, "unroll": p.unroll,
                "f": _fn_to_doc(p.f, [ExpT(Idx(p.n))])}
    if isinstance(p, P.ParFor):
        return {"n": "ParFor", "size": p.n, "d": data_to_doc(p.d),
                "level": _par_to_doc(p.level), "a": phrase_to_doc(p.a),
                "f": _fn_to_doc(p.f, [ExpT(Idx(p.n)), AccT(p.d)])}
    if isinstance(p, P.AccPart):
        return {"n": "AccPart", "v": phrase_to_doc(p.v)}
    if isinstance(p, P.ExpPart):
        return {"n": "ExpPart", "v": phrase_to_doc(p.v)}
    if isinstance(p, P.VView):
        return {"n": "VView", "acc": phrase_to_doc(p.acc),
                "exp": phrase_to_doc(p.exp)}
    if isinstance(p, P.IdxAcc):
        return {"n": "IdxAcc", "a": phrase_to_doc(p.a),
                "i": phrase_to_doc(p.i)}
    if isinstance(p, P.SplitAcc):
        return {"n": "SplitAcc", "size": p.n, "a": phrase_to_doc(p.a)}
    if isinstance(p, P.JoinAcc):
        return {"n": "JoinAcc", "m": p.m, "a": phrase_to_doc(p.a)}
    if isinstance(p, P.PairAcc1):
        return {"n": "PairAcc1", "a": phrase_to_doc(p.a)}
    if isinstance(p, P.PairAcc2):
        return {"n": "PairAcc2", "a": phrase_to_doc(p.a)}
    if isinstance(p, P.ZipAcc1):
        return {"n": "ZipAcc1", "a": phrase_to_doc(p.a)}
    if isinstance(p, P.ZipAcc2):
        return {"n": "ZipAcc2", "a": phrase_to_doc(p.a)}
    if isinstance(p, P.TransposeAcc):
        return {"n": "TransposeAcc", "a": phrase_to_doc(p.a)}
    if isinstance(p, P.AsScalarAcc):
        return {"n": "AsScalarAcc", "a": phrase_to_doc(p.a)}
    if isinstance(p, P.AsVectorAcc):
        return {"n": "AsVectorAcc", "w": p.w, "a": phrase_to_doc(p.a)}
    if isinstance(p, P.MapI):
        return {"n": "MapI", "size": p.n, "d1": data_to_doc(p.d1),
                "d2": data_to_doc(p.d2), "level": _par_to_doc(p.level),
                "e": phrase_to_doc(p.e), "a": phrase_to_doc(p.a),
                "f": _fn_to_doc(p.f, [ExpT(p.d1), AccT(p.d2)])}
    if isinstance(p, P.ReduceI):
        return {"n": "ReduceI", "size": p.n, "d1": data_to_doc(p.d1),
                "d2": data_to_doc(p.d2), "init": phrase_to_doc(p.init),
                "e": phrase_to_doc(p.e),
                "f": _fn_to_doc(p.f, [ExpT(p.d1), ExpT(p.d2), AccT(p.d2)]),
                "k": _fn_to_doc(p.k, [ExpT(p.d2)])}
    raise SerializeError(f"not a serialisable phrase: {type(p).__name__}")


def phrase_from_doc(doc: dict, env: Dict[str, P.Phrase] = None  # noqa: C901
                    ) -> P.Phrase:
    env = env if env is not None else {}
    n = doc["n"]
    if n == "Var":
        bound = env.get(doc["name"])
        if bound is not None:
            return bound
        return P.Var(doc["name"], ptype_from_doc(doc["t"]))
    if n == "Lit":
        return P.Lit(doc["value"], data_from_doc(doc["d"]))
    if n == "UnOp":
        return P.UnOp(doc["op"], phrase_from_doc(doc["e"], env))
    if n == "BinOp":
        return P.BinOp(doc["op"], phrase_from_doc(doc["a"], env),
                       phrase_from_doc(doc["b"], env))
    if n == "Map":
        return P.Map(_fn_from_doc(doc["f"], env),
                     phrase_from_doc(doc["e"], env),
                     level=_par_from_doc(doc["level"]), space=doc["space"])
    if n == "Reduce":
        return P.Reduce(_fn_from_doc(doc["f"], env),
                        phrase_from_doc(doc["init"], env),
                        phrase_from_doc(doc["e"], env),
                        level=_par_from_doc(doc["level"]))
    if n == "Zip":
        return P.Zip(phrase_from_doc(doc["a"], env),
                     phrase_from_doc(doc["b"], env))
    if n == "Split":
        return P.Split(int(doc["size"]), phrase_from_doc(doc["e"], env))
    if n == "Join":
        return P.Join(phrase_from_doc(doc["e"], env))
    if n == "PairE":
        return P.PairE(phrase_from_doc(doc["a"], env),
                       phrase_from_doc(doc["b"], env))
    if n == "Fst":
        return P.Fst(phrase_from_doc(doc["e"], env))
    if n == "Snd":
        return P.Snd(phrase_from_doc(doc["e"], env))
    if n == "IdxE":
        return P.IdxE(phrase_from_doc(doc["e"], env),
                      phrase_from_doc(doc["i"], env))
    if n == "AsVector":
        return P.AsVector(int(doc["w"]), phrase_from_doc(doc["e"], env))
    if n == "AsScalar":
        return P.AsScalar(phrase_from_doc(doc["e"], env))
    if n == "Transpose":
        return P.Transpose(phrase_from_doc(doc["e"], env))
    if n == "DotBlock":
        return P.DotBlock(phrase_from_doc(doc["a"], env),
                          phrase_from_doc(doc["b"], env),
                          acc_dtype=doc["acc_dtype"])
    if n == "FullReduce":
        return P.FullReduce(doc["op"], phrase_from_doc(doc["e"], env))
    if n == "ToMem":
        return P.ToMem(doc["space"], phrase_from_doc(doc["e"], env))
    if n == "Skip":
        return P.Skip()
    if n == "SeqC":
        return P.SeqC(phrase_from_doc(doc["c1"], env),
                      phrase_from_doc(doc["c2"], env))
    if n == "Assign":
        return P.Assign(phrase_from_doc(doc["a"], env),
                        phrase_from_doc(doc["e"], env))
    if n == "New":
        return P.New(data_from_doc(doc["d"]), _fn_from_doc(doc["f"], env),
                     space=doc["space"])
    if n == "For":
        return P.For(int(doc["size"]), _fn_from_doc(doc["f"], env),
                     unroll=bool(doc["unroll"]))
    if n == "ParFor":
        return P.ParFor(int(doc["size"]), data_from_doc(doc["d"]),
                        phrase_from_doc(doc["a"], env),
                        _fn_from_doc(doc["f"], env),
                        level=_par_from_doc(doc["level"]))
    if n == "AccPart":
        return P.AccPart(phrase_from_doc(doc["v"], env))
    if n == "ExpPart":
        return P.ExpPart(phrase_from_doc(doc["v"], env))
    if n == "VView":
        return P.VView(phrase_from_doc(doc["acc"], env),
                       phrase_from_doc(doc["exp"], env))
    if n == "IdxAcc":
        return P.IdxAcc(phrase_from_doc(doc["a"], env),
                        phrase_from_doc(doc["i"], env))
    if n == "SplitAcc":
        return P.SplitAcc(int(doc["size"]), phrase_from_doc(doc["a"], env))
    if n == "JoinAcc":
        return P.JoinAcc(int(doc["m"]), phrase_from_doc(doc["a"], env))
    if n == "PairAcc1":
        return P.PairAcc1(phrase_from_doc(doc["a"], env))
    if n == "PairAcc2":
        return P.PairAcc2(phrase_from_doc(doc["a"], env))
    if n == "ZipAcc1":
        return P.ZipAcc1(phrase_from_doc(doc["a"], env))
    if n == "ZipAcc2":
        return P.ZipAcc2(phrase_from_doc(doc["a"], env))
    if n == "TransposeAcc":
        return P.TransposeAcc(phrase_from_doc(doc["a"], env))
    if n == "AsScalarAcc":
        return P.AsScalarAcc(phrase_from_doc(doc["a"], env))
    if n == "AsVectorAcc":
        return P.AsVectorAcc(int(doc["w"]), phrase_from_doc(doc["a"], env))
    if n == "MapI":
        return P.MapI(int(doc["size"]), data_from_doc(doc["d1"]),
                      data_from_doc(doc["d2"]), _fn_from_doc(doc["f"], env),
                      phrase_from_doc(doc["e"], env),
                      phrase_from_doc(doc["a"], env),
                      level=_par_from_doc(doc["level"]))
    if n == "ReduceI":
        return P.ReduceI(int(doc["size"]), data_from_doc(doc["d1"]),
                         data_from_doc(doc["d2"]),
                         _fn_from_doc(doc["f"], env),
                         phrase_from_doc(doc["init"], env),
                         phrase_from_doc(doc["e"], env),
                         _fn_from_doc(doc["k"], env))
    raise SerializeError(f"unknown phrase tag {n!r}")
