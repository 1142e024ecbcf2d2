"""repro_torch.strategy — strategies as composable, minable programs.

The ELEVATE layer over the DPIA rewrites: :mod:`lang` is the combinator
language (primitive rules + seq/try_/alt/repeat, failure as a value,
traces), :mod:`traverse` the HOAS-aware traversals (topdown/bottomup/
one/all_, paths, replay), :mod:`spaces` re-expresses the autotune kernel
spaces as strategy programs and adds the generic space for arbitrary
terms, and :mod:`mine` compresses winning traces into named abstractions
that seed later searches.  See the reference's docs/strategies.md.

The port's copy of ``repro.strategy``.
"""
from . import lang, mine, spaces, traverse
from .lang import (
    RULES, Result, Strategy, StrategyTrace, TraceStep, alt, fail_, id_,
    is_trace_doc, named, repeat, repeat_n, rule, seq, try_,
)
from .mine import Abstraction, abstractions_path, anti_unify, matches, \
    seeded_order
from .spaces import fused_rmsnorm_matmul, generic_space, program_for, \
    spec_builder
from .traverse import all_, at, bottomup, fingerprint, one, replay, topdown

__all__ = [
    "lang", "traverse", "spaces", "mine",
    "Strategy", "StrategyTrace", "TraceStep", "Result", "RULES",
    "rule", "seq", "try_", "alt", "repeat", "repeat_n", "id_", "fail_",
    "named", "is_trace_doc",
    "one", "all_", "topdown", "bottomup", "at", "replay", "fingerprint",
    "spec_builder", "program_for", "generic_space", "fused_rmsnorm_matmul",
    "Abstraction", "anti_unify", "matches", "seeded_order",
    "abstractions_path",
]
