"""Tuner entry points: ``tune``, ``get_tuned``, ``@autotuned``, warm-up.

    from repro_torch import autotune

    res = autotune.tune("dot", n=4096, backend="cuda")  # search + measure
    res = autotune.tune("dot", n=4096, backend="cuda")  # second: cache hit
    res.params                                  # {"block": 4096, "leaf": ...}

    res = autotune.tune(expr, arg_vars=[xs, ys])  # any DPIA expression
    res = autotune.tune(program)                  # a compiler.Program

    @autotune.autotuned("matmul")
    def mm(a, b): ...                              # body is documentation;
    mm(A, B)                                       # calls the tuned pipeline

Search flow: enumerate the strategy space (space.py), rank every candidate
with the analytic cost model (cost.py), then — when ``measure=True`` —
compile and time the analytic top-k plus the un-tuned default (measure.py)
and keep the fastest.  The winner is written to the persistent cache
(cache.py) keyed by (kernel, shape, dtype, backend, mesh), so the same
``tune`` call is afterwards served from cache without re-search.

The port's copy of ``repro.autotune.api``.  Backends are the port's Stage
III names: ``"torch"`` (the counterpart of the reference's ``"jnp"``, and
the default) and ``"cuda"`` (K4: every measured candidate is generated
CUDA, launched and timed on the card).  Measuring runs on the card unless
``device="cpu"`` is passed.  The mesh descriptor is always ``"single"``:
a mesh and ``backend="shardmap"`` raise until the mesh slice (ROADMAP.md
queue 1 item 7).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

from repro_torch import obs
from repro_torch.compiler import Program
from repro_torch.core.dpia import phrases as P

from . import measure as measure_mod
from . import space as space_mod
from .cache import TuningCache, default_cache, make_key

Spec = Union[str, P.Phrase, Program]

_NEEDS_MESH = ("mesh and sharded serving are not ported yet (ROADMAP.md "
               "queue 1 item 7, mesh)")


@dataclass
class TuneResult:
    kernel: str
    key: str
    params: Dict[str, object]
    source: str                      # "cache" | "analytic" | "measured"
    cost_s: Optional[float] = None   # analytic prediction for the winner
    measured_us: Optional[float] = None
    timings: Dict[str, float] = field(default_factory=dict)
    n_candidates: int = 0
    strategy_trace: Optional[dict] = None  # the winner's derivation

    def params_key(self) -> str:
        return space_mod.params_key(self.params)


def _resolve_cache(cache) -> TuningCache:
    if cache is None:
        return default_cache()
    if isinstance(cache, TuningCache):
        return cache
    return TuningCache(str(cache))


def _mesh_descriptor(mesh, backend: str) -> str:
    """The mesh component of a tuning key: ``"single"``, the only mesh the
    port has."""
    if backend == "shardmap":
        raise NotImplementedError(f"backend='shardmap': {_NEEDS_MESH}")
    if mesh is not None and mesh != "single":
        raise NotImplementedError(f"mesh={mesh!r}: {_NEEDS_MESH}")
    return "single"


def _roofline_terms(cand) -> Dict[str, float]:
    """The chosen candidate's CostEstimate as a plain dict (provenance)."""
    from . import cost as cost_mod
    try:
        expr, _ = cand.build()
        est = cost_mod.estimate(expr)
    except Exception:
        return {}
    return {k: float(v) for k, v in vars(est).items() if v}


def _record_decision(kernel: str, key: str, params: Dict[str, object],
                     origin: str, *, backend: str, dtype: str, mesh: str,
                     layout: str, shape: Dict[str, object],
                     cost_s=None, terms=None, measured_us=None,
                     n_candidates: int = 0, note: str = "",
                     strategy_trace: Optional[dict] = None) -> None:
    obs.record("kernel", kernel, key, params, origin,
               shape=dict(shape), dtype=dtype, backend=backend, mesh=mesh,
               layout=layout, cost_s=cost_s, terms=dict(terms or {}),
               measured_us=measured_us, n_candidates=n_candidates, note=note,
               strategy_trace=strategy_trace)


def _trace_doc_of(cand) -> Optional[dict]:
    """A candidate's serialised derivation; never lets trace extraction
    break tuning."""
    try:
        return cand.trace_doc()
    except Exception:
        return None


def _seed_candidates(cache: TuningCache, kernel: str, ranked,
                     limit: int = 2) -> list:
    """Candidates whose derivation matches a mined abstraction stored
    beside the cache — measured first, before the analytic top-k."""
    from repro_torch.strategy import mine as mine_mod
    try:
        abstractions = mine_mod.load_abstractions(
            mine_mod.abstractions_path(cache.path))
    except Exception:
        return []
    if not abstractions:
        return []
    seeds = []
    for cand, _ in ranked:
        doc = _trace_doc_of(cand)
        if doc and any(mine_mod.matches(a, doc) for a in abstractions):
            seeds.append(cand)
            if len(seeds) >= limit:
                break
    if seeds:
        obs.event("autotune.seeded", kernel=kernel, n=len(seeds),
                  abstractions=len(abstractions))
    return seeds


def tune(spec: Spec, *, backend: str = "torch", dtype: str = "float32",
         mesh=None, layout: str = "dense", cache=None, measure: bool = True,
         top_k: int = 4, iters: int = 5, force: bool = False,
         verify: bool = False, arg_vars: Optional[List[P.Var]] = None,
         strategies=None, device=None, dropped: Optional[dict] = None,
         **shape) -> TuneResult:
    """Pick the best strategy for ``spec`` at a concrete shape.

    ``spec`` is a kernel name ("dot", "asum", "scal", "matmul", "rmsnorm",
    "softmax") with its shape kwargs, a DPIA functional expression (then
    ``arg_vars`` must list its argument Vars and the space comes from
    applying the rewrite rules to the expression itself), or a
    ``repro_torch.compiler.Program`` (kernel/shape metadata is used when
    present, else its expression + arg Vars).

    ``backend`` is the Stage III backend the candidates are compiled and
    measured with: ``"torch"`` or ``"cuda"`` (K4).  ``mesh`` is None or
    ``"single"``; the resolved descriptor is part of the cache key, as in
    the reference.

    ``layout`` is the serving KV-layout strategy the caller is tuning under
    (``"dense"`` | ``"paged"``, from ``CompileOptions.kv_layout``): a cache
    key dimension like the mesh descriptor, so decisions made for one
    memory layout never leak into the other.

    ``measure=False`` ranks analytically only (no compilation: cheap
    enough for inline use on a serving path).  ``measure=True`` compiles
    and times the analytic top-k plus the default on ``device`` (the card
    unless ``"cpu"`` is asked for; :mod:`.measure`).  ``verify=True``
    additionally checks every measured candidate's output against the
    default strategy's.  ``dropped``, when given, is filled with the
    measured candidates dropped, ``{params_key: reason}``
    (:func:`.measure.measure_candidates`).

    ``strategies`` (a list of ``repro_torch.strategy.Strategy`` programs)
    replaces the enumerated space with explicit candidates: each program is
    applied to the kernel's naive spec (or to an expression spec), the
    identity always rides along, and the winner's params are
    ``{"strategy": name}``; its derivation replays from the recorded
    ``strategy_trace``.  Every fresh tuning decision (with or without
    explicit strategies) serialises the winner's ``StrategyTrace`` into the
    cache record and the provenance log.
    """
    c = _resolve_cache(cache)
    mesh_desc = _mesh_descriptor(mesh, backend)

    if isinstance(spec, Program):
        if spec.kernel is not None:
            # kernel metadata names the search family; explicit shape kwargs
            # override the program's shape (they must not silently diverge)
            if not shape:
                shape = dict(spec.shape)
            spec = spec.kernel
        else:
            if spec.expr is None:
                raise ValueError("tune: an imperative-only Program has no "
                                 "functional term to enumerate rewrites on")
            if arg_vars is None:
                arg_vars = spec.arg_vars
            spec = spec.expr

    if isinstance(spec, str):
        kernel = spec
    elif isinstance(spec, P.Phrase):
        if arg_vars is None:
            raise ValueError("tune(expr, ...): arg_vars is required for "
                             "expression specs")
        kernel = f"expr:{space_mod.expr_signature(spec)}"
    else:
        raise TypeError(f"tune: spec must be a kernel name, a DPIA "
                        f"expression, or a Program, got "
                        f"{type(spec).__name__}")

    # cache check happens BEFORE any space enumeration: a hit really is free
    key = make_key(kernel, shape, dtype, backend, mesh_desc, layout=layout)
    cached = c.get(key)
    if cached is not None and not force:
        # an analytic-only record is upgraded when measurement is requested
        if not measure or cached.get("source") == "measured":
            _record_decision(
                kernel, key, dict(cached["params"]),
                f"cache({cached.get('source', 'analytic')})",
                backend=backend, dtype=dtype, mesh=mesh_desc, layout=layout,
                shape=dict(cached.get("shape", shape)),
                cost_s=cached.get("cost_s"),
                terms=cached.get("roofline"),
                measured_us=cached.get("measured_us"),
                n_candidates=int(cached.get("n_candidates", 0)),
                strategy_trace=cached.get("strategy_trace"))
            return TuneResult(
                kernel=kernel, key=key, params=dict(cached["params"]),
                source="cache", cost_s=cached.get("cost_s"),
                measured_us=cached.get("measured_us"),
                timings=dict(cached.get("timings", {})),
                n_candidates=int(cached.get("n_candidates", 0)),
                strategy_trace=cached.get("strategy_trace"))

    with obs.span("autotune.enumerate", kernel=kernel, backend=backend,
                  mesh=mesh_desc):
        if strategies is not None:
            if isinstance(spec, str):
                cands = space_mod.strategy_candidates(kernel, strategies,
                                                      **shape)
            else:
                cands = space_mod.strategy_candidates(
                    kernel, strategies, expr=spec, arg_vars=arg_vars)
            default = cands[0] if cands else None  # the identity program
        elif isinstance(spec, str):
            cands = space_mod.enumerate_space(kernel, **shape)
            try:
                default = space_mod.candidate_from_params(
                    kernel, space_mod.default_params(kernel, **shape),
                    **shape)
            except ValueError:
                default = None
        else:
            cands = space_mod.rewrite_candidates(spec, arg_vars)
            default = cands[0]  # the identity rewrite

        if not cands:
            raise ValueError(
                f"tune: empty strategy space for {kernel!r} at shape "
                f"{shape!r} (no block size divides the extents?)")

        ranked = measure_mod.rank_by_cost(cands)
    chosen, chosen_cost = ranked[0]
    timings: Dict[str, float] = {}
    measured_us = None
    source = "analytic"

    if measure:
        pick = _picks(c, kernel, ranked, default, top_k)
        with obs.span("autotune.measure", kernel=kernel, backend=backend,
                      n_candidates=len(pick)):
            timings = measure_mod.measure_candidates(
                pick, backend=backend, iters=iters,
                verify_against=default if verify else None,
                device=device, dropped=dropped)
        if timings:
            by_key = {cand.params_key(): cand for cand in pick}
            best_key = min(timings, key=lambda k2: (timings[k2], k2))
            chosen = by_key[best_key]
            chosen_cost = next((s for cand, s in ranked
                                if cand.params == chosen.params), chosen_cost)
            measured_us = timings[best_key]
            source = "measured"

    terms = _roofline_terms(chosen)
    trace_doc = _trace_doc_of(chosen)
    record = {
        "kernel": kernel, "params": chosen.params_dict, "source": source,
        "cost_s": chosen_cost if chosen_cost != float("inf") else None,
        "measured_us": measured_us, "timings": timings,
        "shape": dict(shape), "backend": backend, "dtype": dtype,
        "mesh": mesh_desc, "n_candidates": len(cands),
        "roofline": terms, "strategy_trace": trace_doc,
    }
    c.put(key, record)
    _record_decision(kernel, key, chosen.params_dict, source,
                     backend=backend, dtype=dtype, mesh=mesh_desc,
                     layout=layout, shape=shape, cost_s=record["cost_s"],
                     terms=terms, measured_us=measured_us,
                     n_candidates=len(cands), strategy_trace=trace_doc)
    return TuneResult(kernel=kernel, key=key, params=chosen.params_dict,
                      source=source, cost_s=record["cost_s"],
                      measured_us=measured_us, timings=timings,
                      n_candidates=len(cands), strategy_trace=trace_doc)


def _picks(cache: TuningCache, kernel: str, ranked, default, top_k: int
           ) -> list:
    """The candidates ``tune(measure=True)`` times: those matching a mined
    abstraction beside the cache first, then the analytic top-k, then the
    default."""
    pick = [cand for cand, _ in ranked[:max(1, top_k)]]
    # mined abstractions (strategy mining over this cache's corpus)
    # seed the measured set: matching derivations race first
    seeds = _seed_candidates(cache, kernel, ranked)
    pick = seeds + [p for p in pick
                    if all(p.params != s.params for s in seeds)]
    if default is not None and all(p.params != default.params
                                   for p in pick):
        pick.append(default)
    return pick


def measure_picks(kernel: str, *, top_k: int = 4, cache=None,
                  **shape) -> list:
    """The candidates ``tune(kernel, measure=True, top_k=top_k, **shape)``
    would compile and time (no cache lookup, nothing compiled): lets a
    caller build several kernels' picks in one ``nvcc`` batch first."""
    cands = space_mod.enumerate_space(kernel, **shape)
    default = space_mod.candidate_from_params(
        kernel, space_mod.default_params(kernel, **shape), **shape)
    return _picks(_resolve_cache(cache), kernel,
                  measure_mod.rank_by_cost(cands), default, top_k)


def get_tuned(kernel: str, *, backend: str = "torch", dtype: str = "float32",
              mesh=None, layout: str = "dense", cache=None,
              **shape) -> Dict[str, object]:
    """Tuned params for a kernel/shape — cache hit or cheap analytic search.

    ``mesh`` / ``layout`` as in :func:`tune`: the mesh descriptor and the
    serving KV layout are both cache-key dimensions.  This is the
    serving-path entry: it never compiles or measures, so a cold call
    costs one pass of the analytic model and a hot call is a dict lookup."""
    res = tune(kernel, backend=backend, dtype=dtype, mesh=mesh,
               layout=layout, cache=cache, measure=False, **shape)
    return res.params


def get_measured(kernel: str, *, backend: str = "torch",
                 dtype: str = "float32", mesh=None, layout: str = "dense",
                 cache=None, **shape) -> Optional[Dict[str, object]]:
    """The params of a measured record for a kernel/shape, or None.

    A cache lookup like :func:`get_tuned` that never falls back to the
    analytic ranking: the op table's ``cuda`` row takes its params only
    from a ``tune(backend="cuda", measure=True)`` run, since the cost model
    has no preset measured on the card.  A hit records its decision in
    provenance as ``cache(measured)``."""
    c = _resolve_cache(cache)
    key = make_key(kernel, shape, dtype, backend,
                   _mesh_descriptor(mesh, backend), layout=layout)
    record = c.get(key)
    if record is None or record.get("source") != "measured":
        return None
    return get_tuned(kernel, backend=backend, dtype=dtype, mesh=mesh,
                     layout=layout, cache=c, **shape)


def pick_kv_layout(cfg, *, slots: int, max_seq: int, block_size: int = 16,
                   expected_seq: Optional[int] = None, platform=None,
                   cache=None, force: bool = False) -> Dict[str, object]:
    """Rank the serving KV layouts (dense vs paged) for a model/engine
    shape with the HBM-bytes roofline and remember the answer.

    Dense wins on raw decode traffic (no gather copy); paged wins the
    moment the dense resident cache blows the platform's HBM budget
    (``cost.HwModel.hbm_capacity``: per-backend presets,
    ``cost.HW_PRESETS``).
    The decision is cached under kernel ``"kv_layout"`` keyed by the engine
    shape + platform, so a serving engine built with ``kv_layout="auto"``
    resolves it with one dict lookup.

    Returns ``{"layout", "dense_bytes", "paged_bytes", "dense_s",
    "paged_s"}``."""
    from . import cost as cost_mod
    from repro_torch.serve import paged as paged_mod
    c = _resolve_cache(cache)
    hw = cost_mod.hw_model(platform)
    plat = platform or cost_mod.default_platform()
    layers = paged_mod._kv_layers(cfg)
    shape = {"slots": slots, "max_seq": max_seq, "block": block_size,
             "expected": int(expected_seq or 0), "layers": layers,
             "kv": cfg.n_kv_heads, "hd": cfg.hd}
    key = make_key("kv_layout", shape, str(cfg.dtype), str(plat), "single")

    def _record_kv(params: Dict[str, object], origin: str) -> None:
        obs.record(
            "kv_layout", "kv_layout", key, {"layout": params["layout"]},
            origin, shape=dict(shape), dtype=str(cfg.dtype),
            backend=str(plat), mesh="single", layout=params["layout"],
            cost_s=params.get(f"{params['layout']}_s"),
            terms={"dense_bytes": float(params.get("dense_bytes", 0)),
                   "paged_bytes": float(params.get("paged_bytes", 0)),
                   "dense_s": float(params.get("dense_s", 0.0)),
                   "paged_s": float(params.get("paged_s", 0.0))},
            n_candidates=2)

    cached = c.get(key)
    if cached is not None and not force:
        _record_kv(dict(cached["params"]), "cache(analytic)")
        return dict(cached["params"])
    if layers == 0:
        # no attention cache at all (ssm): the layouts are the same thing
        record = {"layout": "dense", "dense_bytes": 0, "paged_bytes": 0,
                  "dense_s": 0.0, "paged_s": 0.0}
    else:
        db = paged_mod.dtype_bytes(cfg.dtype)
        kw = dict(slots=slots, max_seq=max_seq, kv_heads=cfg.n_kv_heads,
                  head_dim=cfg.hd, layers=layers, dtype_bytes=db,
                  block_size=block_size, expected_seq=expected_seq)
        dense = cost_mod.kv_layout_cost("dense", **kw)
        paged = cost_mod.kv_layout_cost("paged", **kw)
        ds, ps = dense.seconds(hw), paged.seconds(hw)
        record = {"layout": "dense" if ds <= ps else "paged",
                  "dense_bytes": dense.resident_bytes,
                  "paged_bytes": paged.resident_bytes,
                  "dense_s": ds, "paged_s": ps}
    c.put(key, {"kernel": "kv_layout", "params": record, "source": "analytic",
                "shape": shape, "backend": str(plat),
                "dtype": str(cfg.dtype), "mesh": "single",
                "n_candidates": 2})
    _record_kv(record, "analytic")
    return record


# ---------------------------------------------------------------------------
# decorator + warm-up
# ---------------------------------------------------------------------------

_SHAPE_FROM_ARGS = {
    "dot": lambda a: {"n": int(a[0].shape[0])},
    "asum": lambda a: {"n": int(a[0].shape[0])},
    "scal": lambda a: {"n": int(a[1].shape[0])},
    "matmul": lambda a: {"m": int(a[0].shape[0]), "k": int(a[0].shape[1]),
                         "n": int(a[1].shape[1])},
    "rmsnorm": lambda a: {"rows": int(a[0].shape[0]), "d": int(a[0].shape[1])},
    "softmax": lambda a: {"rows": int(a[0].shape[0]), "d": int(a[0].shape[1])},
}


def autotuned(kernel: str, *, backend: str = "torch", cache=None,
              measure: bool = False, **tune_kw):
    """Decorator: calls to the wrapped function run the tuned strategy for
    the call's shapes, compiled through the formal pipeline and memoised
    per shape.  The wrapped body itself is never executed — it documents
    the mathematical spec (use repro_torch.kernels.ref for oracles)."""
    shape_fn = _SHAPE_FROM_ARGS.get(kernel)
    if shape_fn is None:
        raise ValueError(f"autotuned: unknown kernel {kernel!r}; known: "
                         f"{sorted(_SHAPE_FROM_ARGS)}")

    def deco(fn):
        compiled: Dict[tuple, object] = {}

        @functools.wraps(fn)
        def wrapper(*arrays):
            shape = shape_fn(arrays)
            memo_key = (tuple(sorted(shape.items())), backend)
            if memo_key not in compiled:
                res = tune(kernel, backend=backend, cache=cache,
                           measure=measure, **shape, **tune_kw)
                cand = space_mod.candidate_from_params(
                    kernel, res.params, **shape)
                compiled[memo_key] = (cand.program().check().lower()
                                      .compile(backend))
            return compiled[memo_key](*arrays)

        wrapper.compiled = compiled
        return wrapper
    return deco


def model_kernel_shapes(cfg, *, max_seq: int = 512, batch_sizes=(1, 8)
                        ) -> List[tuple]:
    """The (kernel, shape) list a serving engine's op dispatch keys on for a
    model config: rmsnorm flattens to rows = batch * seq, prefill matmuls
    run at m = batch * seq, decode matmuls at m = batch.  Shared by tuner
    warm-up (:func:`warm_for_model`) and by the engines' executor/AOT
    warm-up (``repro_torch.kernels.ops.warm_kernel``), so the two can never
    drift apart."""
    wants = []
    for b in batch_sizes:
        rows = b * max_seq
        wants += [
            ("rmsnorm", {"rows": rows, "d": cfg.d_model}),
            ("rmsnorm", {"rows": b, "d": cfg.d_model}),        # decode step
            ("matmul", {"m": rows, "k": cfg.d_model, "n": cfg.d_ff}),
            ("matmul", {"m": rows, "k": cfg.d_model, "n": cfg.d_model}),
            ("matmul", {"m": b, "k": cfg.d_model, "n": cfg.d_ff}),
            ("matmul", {"m": b, "k": cfg.d_model, "n": cfg.d_model}),
        ]
    return wants


def warm_for_model(cfg, *, max_seq: int = 512, backend: str = "torch",
                   cache=None, batch_sizes=(1, 8)
                   ) -> Dict[str, Dict[str, object]]:
    """Pre-tune (analytically, cache-backed) the strategy choices a serving
    engine will need for a model config, at the shapes of
    :func:`model_kernel_shapes`.  Returns {cache key: tuned params}; shapes
    with no valid space are skipped."""
    out: Dict[str, Dict[str, object]] = {}
    for kernel, shape in model_kernel_shapes(cfg, max_seq=max_seq,
                                             batch_sizes=batch_sizes):
        try:
            res = tune(kernel, backend=backend, cache=cache, measure=False,
                       **shape)
        except (ValueError, AssertionError):
            continue
        out[res.key] = res.params
    return out
