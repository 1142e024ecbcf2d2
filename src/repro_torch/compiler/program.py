"""The staged compilation pipeline as a first-class object.

A :class:`Program` wraps a DPIA functional term plus its argument Vars and
exposes the paper's pipeline as explicit stages:

    prog = Program(expr, arg_vars)            # functional term

    fn = prog.check()           # SCIR: well-typed + data-race free
               .lower()         # optional strategy rewrite + Stage I -> II
               .compile("cuda") # Stage III via the backend registry

``lower`` takes no strategy (the term already is the strategy) or a rewrite
callable (``expr -> expr``).  ``Program.from_imperative`` wraps an
already-imperative SCIR command so it can be race-checked and compiled
through the same interface.

The port's copy of ``repro.compiler.program``, without what waits for later
slices: ``from_kernel`` and the params-dict, trace and ``"autotune"``
strategies (they go through the autotuner), the options scope, AOT
export/load and observability spans.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

from ..core.dpia import check as check_mod
from ..core.dpia import phrases as P
from ..core.dpia import stage1, stage2
from ..core.dpia.types import AccT
from .backends import Backend, get_backend

__all__ = ["Program", "CompiledKernel"]

OUT_NAME = "out#"

Strategy = Union[None, Callable[[P.Phrase], P.Phrase]]


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
    """A DPIA term + argument specs, compiled in explicit stages."""

    def __init__(self, expr: Optional[P.Phrase], arg_vars: Sequence[P.Var],
                 *, name: Optional[str] = None):
        self.expr = expr
        self.arg_vars: List[P.Var] = list(arg_vars)
        self.name = name or "program"
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
        check_mod.check(cmd)
        self._checked = True
        return self

    def lower(self, strategy: Strategy = None) -> "Program":
        """Fix the strategy and translate to imperative DPIA (Stage I->II).

        ``strategy`` is None (the term already *is* the strategy) or a
        rewrite callable ``expr -> expr`` (semantics-preserving by the
        caller's obligation).  Returns self when the term is unchanged, else
        a new Program whose ``check()`` state starts fresh."""
        if strategy is None:
            self._translated()
            return self
        if self.expr is None:
            raise ValueError("lower(strategy): an imperative-only Program "
                             "has no functional term to rewrite")
        if not callable(strategy):
            raise TypeError(f"lower: bad strategy {strategy!r}; expected None "
                            f"or a rewrite callable (params dicts and "
                            f"'autotune' wait for the port's autotuner)")
        prog = Program(strategy(self.expr), self.arg_vars, name=self.name)
        prog._translated()
        return prog

    def compile(self, backend: Union[str, Backend] = "torch",
                **backend_kw) -> CompiledKernel:
        """Stage III: emit an executable callable via the backend registry.

        ``backend`` is a registered backend name/alias or Backend instance.
        Extra keyword arguments go to the backend's code generator."""
        b = get_backend(backend)
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
        fn = b.compile(self.expr, self.arg_vars, **call_kw)
        return CompiledKernel(fn, self, b.name)

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

