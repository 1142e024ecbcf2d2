"""The staged compilation pipeline as a first-class object.

A :class:`Program` wraps a DPIA functional term plus its argument Vars and
exposes the paper's pipeline as explicit stages:

    prog = Program(expr, arg_vars)            # functional term

    fn = prog.check()           # SCIR: well-typed + data-race free
               .lower()         # optional strategy rewrite + Stage I -> II
               .compile("cuda") # Stage III via the backend registry

``lower`` takes no strategy (the term already is the strategy), a
``repro_torch.strategy`` program, a serialised strategy trace, a rewrite
callable (``expr -> expr``), a params dict of the kernel's strategy space
or ``"autotune"``.  ``compile`` resolves its backend through
:mod:`repro_torch.compiler.backends`, by name or, with none given, from
the :class:`~repro_torch.compiler.options.CompileOptions` passed or in
scope.  ``Program.from_imperative`` wraps an already-imperative SCIR
command so it can be race-checked and compiled through the same interface.
Each stage runs in an obs span (``compiler.lower``, ``compiler.check``,
``compiler.compile``).

``to_doc`` / ``from_doc`` / ``export`` / ``load`` persist the *lowered*
program in the reference's document layout (``EXPORT_VERSION``), so a
document is the same whichever package wrote it and a later process jumps
straight to Stage III.

The port's copy of ``repro.compiler.program``.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, Dict, List, Optional, Sequence, Union

from repro_torch import obs

from ..core.dpia import check as check_mod
from ..core.dpia import phrases as P
from ..core.dpia import stage1, stage2
from ..core.dpia.types import AccT
from .backends import Backend, get_backend
from .options import CompileOptions, current_options

__all__ = ["Program", "CompiledKernel", "program"]

EXPORT_VERSION = 1

OUT_NAME = "out#"

Strategy = Union[None, str, Dict[str, object], Callable[[P.Phrase], P.Phrase]]


class CompiledKernel:
    """Callable produced by :meth:`Program.compile`, with its provenance.

    Attributes the backend's callable carries (the CUDA generator's
    ``plan``, ``source`` and ``launches``) are read through."""

    def __init__(self, fn: Callable, program: "Program", backend: str):
        self._fn = fn
        self.program = program
        self.backend = backend

    def __call__(self, *args):
        return self._fn(*args)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._fn, name)

    def __repr__(self):
        return (f"<CompiledKernel {self.program.name!r} "
                f"backend={self.backend!r}>")


class Program:
    """A DPIA term + argument specs, compiled in explicit stages.

    ``kernel``/``shape`` are optional metadata naming one of the op
    layer's kernels at a concrete shape (they ride along into the AOT
    store and provenance)."""

    def __init__(self, expr: Optional[P.Phrase], arg_vars: Sequence[P.Var],
                 *, name: Optional[str] = None, kernel: Optional[str] = None,
                 shape: Optional[Dict[str, object]] = None):
        self.expr = expr
        self.arg_vars: List[P.Var] = list(arg_vars)
        self.kernel = kernel
        self.shape: Dict[str, object] = dict(shape or {})
        self.name = name or kernel or "program"
        self.strategy_trace: Optional[dict] = None  # how the term was derived
        self._cmd: Optional[P.Phrase] = None
        self._out: Optional[P.Var] = None
        self._checked = False

    # ---- constructors ------------------------------------------------------

    @classmethod
    def from_builder(cls, builder: Callable, **meta) -> "Program":
        """From a ``() -> (expr, arg_vars)`` builder (the dpia_blas idiom)."""
        expr, arg_vars = builder()
        return cls(expr, arg_vars, **meta)

    @classmethod
    def from_kernel(cls, kernel: str, *, params: Optional[dict] = None,
                    **shape) -> "Program":
        """A named benchmark kernel at a concrete shape.

        ``params`` picks a point of the kernel's strategy space (the
        ``repro_torch.autotune`` vocabulary); None means the un-tuned
        default.  The derivation rides along as ``strategy_trace``."""
        from repro_torch.autotune import space as space_mod
        if params is None:
            params = space_mod.default_params(kernel, **shape)
        cand = space_mod.candidate_from_params(kernel, dict(params), **shape)
        expr, arg_vars = cand.build()
        prog = cls(expr, arg_vars, kernel=kernel, shape=shape, name=kernel)
        try:
            prog.strategy_trace = cand.trace_doc()
        except Exception:
            prog.strategy_trace = None
        return prog

    @classmethod
    def from_imperative(cls, cmd: P.Phrase, arg_vars: Sequence[P.Var],
                        out: P.Var, *, name: Optional[str] = None
                        ) -> "Program":
        """Wrap an already-imperative SCIR command (out is its acceptor Var).

        The program is born lowered; ``check()`` runs the SCIR discipline on
        the command as given, ``compile()`` hands it straight to Stage III."""
        if not isinstance(out.t, AccT):
            raise TypeError(f"from_imperative: out must be acc-typed, got "
                            f"{out.t}")
        prog = cls(None, arg_vars, name=name or "imperative")
        prog._cmd, prog._out = cmd, out
        return prog

    # ---- stage I-II --------------------------------------------------------

    def _translated(self):
        """(imperative command, out Var) for the current term, cached."""
        if self._cmd is None:
            if self.expr is None:
                raise ValueError("program has neither a functional term nor "
                                 "an imperative command")
            with obs.span("compiler.lower", program=self.name):
                out = P.Var(OUT_NAME, AccT(P.exp_data(self.expr)))
                self._cmd = stage2.expand(stage1.translate(self.expr, out))
                self._out = out
        return self._cmd, self._out

    @property
    def imperative(self) -> P.Phrase:
        """The Stage I->II translation (imperative DPIA) of this program."""
        return self._translated()[0]

    # ---- staged API --------------------------------------------------------

    def check(self) -> "Program":
        """SCIR check: well-typed + data-race free.  Fluent (returns self).

        Raises ``DpiaTypeError`` / ``RaceError`` on violation."""
        cmd, _ = self._translated()
        with obs.span("compiler.check", program=self.name):
            check_mod.check(cmd)
        self._checked = True
        return self

    def lower(self, strategy: Strategy = None, *,
              options: Optional[CompileOptions] = None) -> "Program":
        """Fix the strategy and translate to imperative DPIA (Stage I->II).

        strategy:
          None            the term already *is* the strategy (default);
          Strategy        a ``repro_torch.strategy`` program; applied to
                          the term, failure raises, the trace is recorded
                          on the result's ``strategy_trace``;
          trace doc       a serialised ``StrategyTrace`` (dict with
                          "steps"); deterministic replay of a derivation;
          callable        a rewrite ``expr -> expr`` (semantics-preserving
                          by the caller's obligation; re-check after);
          params dict     a point of this kernel's strategy space
                          (requires kernel/shape metadata);
          "autotune"      resolve params via ``repro_torch.autotune`` (cost
                          model + persistent cache; backend and cache from
                          the options).

        Returns self when the term is unchanged, else a new Program (whose
        ``check()`` state starts fresh: rewrites must be re-checked)."""
        if strategy is None:
            self._translated()
            return self
        if self.expr is None:
            raise ValueError("lower(strategy): an imperative-only Program "
                             "has no functional term to rewrite")
        from repro_torch import strategy as strategy_mod
        if isinstance(strategy, strategy_mod.Strategy):
            res = strategy.apply(self.expr)
            if not res.ok:
                raise ValueError(f"lower(strategy): strategy program failed "
                                 f"on {self.name!r}: {res.reason}")
            return self._derived(res.phrase, res.trace.to_doc())
        if isinstance(strategy, dict) and strategy_mod.is_trace_doc(strategy):
            res = strategy_mod.replay(strategy, self.expr)
            if not res.ok:
                raise ValueError(f"lower(trace): replay failed on "
                                 f"{self.name!r}: {res.reason}")
            return self._derived(res.phrase, res.trace.to_doc())
        if callable(strategy):
            return self._derived(strategy(self.expr), None)
        if strategy == "autotune":
            if self.kernel is None:
                raise ValueError(
                    'lower("autotune") needs kernel/shape metadata: build '
                    'the Program with from_kernel(...) or pass a params '
                    'dict')
            from repro_torch import autotune
            opts = options or current_options()
            params = autotune.get_tuned(
                self.kernel, backend=opts.dpia_backend,
                cache=opts.tuning_cache, **self.shape)
            return self.lower(params)
        if isinstance(strategy, dict):
            if self.kernel is None:
                raise ValueError(
                    "lower(params) needs kernel/shape metadata: build the "
                    "Program with from_kernel(...)")
            prog = Program.from_kernel(self.kernel, params=strategy,
                                       **self.shape)
            prog._translated()
            return prog
        raise TypeError(f"lower: bad strategy {strategy!r}; expected None, a "
                        f"Strategy, a trace doc, a rewrite callable, a "
                        f"params dict, or 'autotune'")

    def _derived(self, expr: P.Phrase, trace: Optional[dict]) -> "Program":
        """A new Program for the rewritten ``expr``, translated."""
        prog = Program(expr, self.arg_vars, name=self.name,
                       kernel=self.kernel, shape=self.shape)
        prog.strategy_trace = trace
        prog._translated()
        return prog

    def compile(self, backend: Union[None, str, Backend] = None, *,
                options: Optional[CompileOptions] = None,
                **backend_kw) -> CompiledKernel:
        """Stage III: emit an executable callable via the backend registry.

        ``backend`` is a registered backend name/alias or Backend instance;
        None takes the one the options imply (``options`` or the scope's:
        ``CompileOptions.dpia_backend``, ``torch`` unless a ``dpia-*``
        backend is set).  Extra keyword arguments go to the backend's code
        generator.  A backend's required keywords must be given, except a
        ``mesh``, which the options or the process mesh context supply
        (``"shardmap"``: ``compile("shardmap", mesh=..., inner="cuda")``
        consumes the functional term, so a mesh term is compiled without
        ``check().lower()``; its per-shard bodies are checked by the inner
        backend)."""
        opts = options or current_options()
        b = get_backend(backend if backend is not None else opts.dpia_backend)
        missing = [r for r in b.requires if r not in backend_kw]
        if "mesh" in missing:
            # a mesh requirement is satisfiable from the options / the
            # process mesh context; an explicit mesh= still wins
            mesh = opts.resolved_mesh()
            if mesh is not None:
                backend_kw["mesh"] = mesh
                missing.remove("mesh")
        if missing:
            raise TypeError(f"backend {b.name!r} requires keyword "
                            f"argument(s) {missing} (e.g. the mesh for "
                            f"shard_map — pass mesh=, set "
                            f"compiler.options(mesh=...), or "
                            f"sharding.ctx.set_mesh)")
        if self.expr is None and "lowered" not in b.accepts:
            raise ValueError(
                f"backend {b.name!r} consumes functional terms only and "
                f"this Program is imperative-only (from_imperative)")
        call_kw = dict(backend_kw)
        if "lowered" in b.accepts and self._cmd is not None:
            call_kw.setdefault("lowered", (self._cmd, self._out))
        if "check" in b.accepts:
            # an already-checked program need not be re-checked in Stage III
            call_kw.setdefault("check", not self._checked)
        if "name" in b.accepts:
            call_kw.setdefault("name", self.name)
        with obs.span("compiler.compile", program=self.name, backend=b.name):
            fn = b.compile(self.expr, self.arg_vars, **call_kw)
        return CompiledKernel(fn, self, b.name)

    # ---- AOT persistence ---------------------------------------------------

    def to_doc(self) -> dict:
        """JSON-able document of this program's *lowered* form (the
        reference's layout, ``EXPORT_VERSION``).

        Triggers Stage I->II if the program has not been lowered yet.  The
        document persists the imperative command (serialised through
        :mod:`repro_torch.compiler.serialize`), the argument/out Vars, and
        the name and kernel/shape metadata: everything a later process
        needs to jump straight to Stage III."""
        from . import serialize
        cmd, out = self._translated()
        return {
            "version": EXPORT_VERSION,
            "name": self.name,
            "kernel": self.kernel,
            "shape": dict(self.shape),
            "args": [serialize.var_to_doc(v) for v in self.arg_vars],
            "out": serialize.var_to_doc(out),
            "checked": bool(self._checked),
            "strategy_trace": self.strategy_trace,
            "cmd": serialize.phrase_to_doc(cmd),
        }

    @classmethod
    def from_doc(cls, doc: dict) -> "Program":
        """Rebuild a lowered Program from :meth:`to_doc` output.

        The result is imperative-only (its functional term is gone: the
        strategy was fixed before export), so ``compile`` hands the
        command to a backend that accepts lowered commands (``torch`` and
        ``cuda`` do).  The persisted ``checked`` bit is trusted: an
        artefact exported after ``check()`` does not re-run the SCIR
        discipline on load."""
        from . import serialize
        if doc.get("version") != EXPORT_VERSION:
            raise ValueError(f"Program.from_doc: unsupported export version "
                             f"{doc.get('version')!r}")
        args = [serialize.var_from_doc(a) for a in doc["args"]]
        prog = cls(None, args, name=doc.get("name"),
                   kernel=doc.get("kernel"), shape=doc.get("shape") or {})
        prog._cmd = serialize.phrase_from_doc(doc["cmd"])
        prog._out = serialize.var_from_doc(doc["out"])
        prog._checked = bool(doc.get("checked"))
        prog.strategy_trace = doc.get("strategy_trace")
        return prog

    def export(self, path: str) -> str:
        """Write the lowered program to ``path`` (atomic tmp+rename)."""
        doc = self.to_doc()
        d = os.path.dirname(path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".program-", suffix=".json")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path

    @classmethod
    def load(cls, path: str) -> "Program":
        """Read a program exported with :meth:`export` (skips Stage I->II)."""
        with open(path) as f:
            return cls.from_doc(json.load(f))

    # ---- sugar -------------------------------------------------------------

    def show(self) -> str:
        """Pretty-printed imperative form (for inspection/teaching)."""
        from ..core.dpia.pretty import show
        return show(self.imperative)

    def __repr__(self):
        stage = ("imperative" if self.expr is None else
                 "lowered" if self._cmd is not None else "functional")
        chk = "+checked" if self._checked else ""
        return (f"<Program {self.name!r} args="
                f"{[v.name for v in self.arg_vars]} {stage}{chk}>")


def program(expr: P.Phrase, arg_vars: Sequence[P.Var], **meta) -> Program:
    """Convenience constructor: ``compiler.program(expr, args)``."""
    return Program(expr, arg_vars, **meta)
