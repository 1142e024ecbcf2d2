"""Compile-and-time refinement of strategy candidates.

The analytic model (cost.py) ranks the whole space for free; this module
takes the top-k and pushes each through the formal pipeline,
``Program.check().lower().compile(backend)``: with ``backend="cuda"`` that
is K4, the generated CUDA kernels (``core/dpia/stage3_cuda.py``), launched
on the card; with ``"torch"`` the torch Stage III, the plain version;
with ``"shardmap"`` the mesh term through ``Program.compile("shardmap",
mesh=...)``, each rank running its shard (K4 on the card).  Inputs are
drawn from ``numpy.random.RandomState(seed)`` as the reference
draws them and moved to the measuring device: the card unless the caller
asks for the CPU, as the tests do.

Timing.  On the card a candidate is timed by CUDA events around replays of
a CUDA graph that holds many back-to-back calls of its launches, after a
warm-up (:func:`time_callable`); the graph's launches are counted once per
replay, as ``serve/graph.py`` counts them.  The reference times with the
host clock around ``block_until_ready``.  On the H100 a K4 call costs
0.04-0.10 ms of host time (allocations and one ctypes launch a stage),
more than the device time of most candidates (0.005-0.056 ms), so a host
clock would rank launch overhead, not strategies.  A sharded program
(``backend="shardmap"``) is timed by CUDA events around eager calls, its
all-reduce included.  On CPU tensors the host
clock is the only clock: the median of ``iters`` calls.

Before timing, every candidate's generated source is built in one parallel
batch (:func:`build_candidates`, ``stage3_cuda.build_all``): cold ``nvcc``
is what makes tuning cost card time.

Failures.  The reference drops any candidate that fails to compile or run.
This module drops only two kinds, each with an ``autotune.candidate_failed``
event and an ``autotune.dropped.<reason>`` counter:

  * ``unsupported``: the Stage III backend refuses the program with
    ``NotImplementedError`` (``stage3_cuda.check_supported``: MESH levels,
    data other than float32; or a form the generator does not emit);
  * ``verify``: with ``verify_against``, the candidate's output misses the
    reference candidate's (``rtol=1e-3``, ``atol=1e-4``: the reference's
    tolerance).

An nvcc error, a CUDA launch error or any other exception propagates: a
tuner must not hide a broken kernel by picking another one.
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.dpia import phrases as P
from repro_torch.core.dpia.types import dtype_of, shape_of, torch_dtype
from repro_torch.device import resolve_device

from .space import Candidate

VERIFY_RTOL, VERIFY_ATOL = 1e-3, 1e-4


def args_for(arg_vars: Sequence[P.Var], seed: int = 0,
             device=None) -> Tuple:
    """Deterministic random inputs matching the argument Vars' data types
    (the reference's draws), as tensors on ``device`` (the card unless
    ``"cpu"`` is asked for)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    out = []
    for v in arg_vars:
        d = v.t.d
        shp = shape_of(d)
        dt = dtype_of(d)
        if dt.startswith("int"):
            a = rng.randint(0, 7, size=shp)
        else:
            a = rng.randn(*shp)
        out.append(torch.as_tensor(np.asarray(a), dtype=torch_dtype(dt),
                                   device=dev))
    return tuple(out)


def compile_candidate(cand: Candidate, backend: str = "torch",
                      device=None, mesh=None):
    """(compiled callable, concrete args) for a candidate, via the staged
    pipeline: the candidate becomes a ``repro_torch.compiler.Program`` and
    runs ``check() -> lower() -> compile(backend)``.  Codegen only: a
    generated source is built at its first CUDA call or by
    :func:`build_candidates`.

    ``backend="shardmap"`` compiles for ``mesh`` (else the options' or
    the process mesh) straight from the functional term (the per-shard
    bodies are checked by the inner backend): K4 shards on the card, the
    torch Stage III's on the CPU.  Every rank draws the same global
    inputs; each runs its own shard."""
    prog = cand.program()
    dev = resolve_device(device)
    if backend == "shardmap":
        kw = {} if mesh is None else {"mesh": mesh}
        fn = prog.compile("shardmap", inner="cuda" if dev.type == "cuda"
                          else "torch", **kw)
    else:
        fn = prog.check().lower().compile(backend)
    return fn, args_for(prog.arg_vars, device=dev)


def build_candidates(fns) -> float:
    """Build the generated CUDA sources of compiled candidates in one
    parallel batch (one ``nvcc`` each, all started together); returns the
    seconds it took (0 when every source was built)."""
    from repro_torch.core.dpia import stage3_cuda
    progs = [getattr(fn, "_fn", fn) for fn in fns]
    # a sharded program's generated part is its per-shard body
    progs = [getattr(p, "shard", p) for p in progs]
    progs = [p for p in progs if isinstance(p, stage3_cuda.GeneratedProgram)]
    return stage3_cuda.build_all(progs) if progs else 0.0


def _graph_ms(prog, launchers, reps: int, trials: int) -> float:
    """Median device ms of one call of generated program ``prog``: CUDA
    events around replays of a graph holding ``reps`` back-to-back calls
    of its ``launchers``.  A launcher counts when it is called, and under
    capture it records without launching: the capture's counts are taken
    back and added once per replay, which is when the kernels launch."""
    from repro_torch.core.dpia import stage3_cuda

    def call():
        for launch in launchers:
            launch()

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            call()
    torch.cuda.current_stream().wait_stream(side)
    before = prog.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            call()
    captured = prog.launches - before
    times = []
    for i in range(trials + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        if i:                               # the first replay warms up
            times.append(start.elapsed_time(end) / reps)
    prog.launches += captured * trials
    stage3_cuda.launches += captured * trials
    del graph
    return statistics.median(times)


def time_callable(fn, args, iters: int = 5, warmup: int = 1) -> float:
    """Microseconds of one call.

    CUDA tensors with a generated program (``fn.bind``): device time from
    CUDA events around CUDA-graph replays (module docstring), ``reps``
    calls a replay so that one replay holds about a millisecond of work,
    median of ``max(iters, 3)`` replays.  Other CUDA callables: CUDA events
    around ``iters`` eager calls.  CPU tensors: the median host time of
    ``iters`` calls after ``warmup`` calls (at least one on the card,
    where the first call may build and load the library)."""
    on_card = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
    if not on_card:
        for _ in range(warmup):
            fn(*args)
        samples = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            samples.append((time.perf_counter() - t0) * 1e6)
        return float(np.median(samples))
    for _ in range(max(1, warmup)):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn(*args)
    end.record()
    end.synchronize()
    one_ms = start.elapsed_time(end)
    if hasattr(fn, "bind"):
        launchers, _ = fn.bind(*args)
        reps = max(1, min(20, int(1.0 / max(one_ms, 1e-3))))
        return _graph_ms(fn._fn, launchers, reps, max(iters, 3)) * 1e3
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def _flat(out) -> List[torch.Tensor]:
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    to_local = getattr(out, "to_local", None)     # a DTensor: this shard
    return [to_local() if to_local is not None else out]


def _matches(got, want) -> bool:
    return all(torch.allclose(g.detach().float().cpu(),
                              w.detach().float().cpu(), rtol=VERIFY_RTOL,
                              atol=VERIFY_ATOL)
               for g, w in zip(_flat(got), _flat(want)))


def _drop(dropped: Optional[dict], cand: Candidate, backend: str,
          reason: str, detail: str) -> None:
    obs.counter(f"autotune.dropped.{reason}").inc()
    obs.event("autotune.candidate_failed", backend=backend,
              params=cand.params_key(), reason=reason, detail=detail)
    if dropped is not None:
        dropped[cand.params_key()] = reason


def measure_candidates(cands: Sequence[Candidate], *, backend: str = "torch",
                       iters: int = 5, seed: int = 0,
                       verify_against: Optional[Candidate] = None,
                       device=None, dropped: Optional[dict] = None,
                       mesh=None) -> Dict[str, float]:
    """Time each candidate; returns ``{params_key: us}``.

    Only the two failures of the module docstring drop a candidate; any
    other exception propagates.  When ``verify_against`` is given, every
    candidate's output is checked against that candidate's output
    (strategy preservation as a runtime assertion).  ``dropped``, when
    given, is filled with ``{params_key: reason}``.  ``mesh`` is the
    ``DeviceMesh`` of ``backend="shardmap"``: each rank times its own
    shard (the caller agrees the ranks' timings)."""
    compiled = []
    for c in cands:
        try:
            fn, args = compile_candidate(c, backend, device=device,
                                         mesh=mesh)
        except NotImplementedError as e:
            _drop(dropped, c, backend, "unsupported", str(e))
            continue
        compiled.append((c, fn, args))
    if any(a.is_cuda for _, _, args in compiled for a in args
           if isinstance(a, torch.Tensor)):
        build_candidates([fn for _, fn, _ in compiled])
    ref_out = None
    if verify_against is not None:
        ref = next(((fn, args) for c, fn, args in compiled
                    if c.params == verify_against.params), None)
        if ref is None:
            try:
                ref = compile_candidate(verify_against, backend,
                                        device=device, mesh=mesh)
            except NotImplementedError as e:
                _drop(dropped, verify_against, backend, "unsupported",
                      str(e))
        if ref is not None:
            ref_out = ref[0](*ref[1])
    out: Dict[str, float] = {}
    for c, fn, args in compiled:
        with obs.span("autotune.measure_candidate", backend=backend,
                      params=c.params_key()):
            if ref_out is not None and not _matches(fn(*args), ref_out):
                _drop(dropped, c, backend, "verify",
                      f"output misses {verify_against.params_key()}'s "
                      f"beyond rtol {VERIFY_RTOL}, atol {VERIFY_ATOL}")
                continue
            # the verifying call was this candidate's warm-up
            out[c.params_key()] = time_callable(
                fn, args, iters=iters, warmup=0 if ref_out is not None else 1)
    return out


def rank_by_cost(cands: Sequence[Candidate], hw=None
                 ) -> List[Tuple[Candidate, float]]:
    """(candidate, predicted seconds) sorted best-first; unbuildable or
    un-costable candidates sort last with +inf.

    ``hw`` is the roofline HwModel; None resolves the per-platform preset
    (``cost.hw_model()``: the port's device)."""
    from . import cost as cost_mod
    if hw is None:
        hw = cost_mod.hw_model()
    scored = []
    for c in cands:
        try:
            expr, _ = c.build()
            s = cost_mod.predicted_seconds(expr, hw)
        except Exception:
            s = float("inf")
        scored.append((c, s))
    scored.sort(key=lambda cs: (cs[1], cs[0].params_key()))
    return scored
