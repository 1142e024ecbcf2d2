"""The port's kernel API, as the models call it.

Every op takes the arguments of ``repro.kernels.ops``'s function of the same
name, an ``impl=`` naming one row of its table and an ``options=``
(:class:`repro_torch.compiler.CompileOptions`):

  'plain'      — the plain PyTorch version (``ref``); the reference's 'xla'
  'cuda'       — the hand-written CUDA kernel: K1 RMSNorm, K2 matmul,
                 K3 flash attention; the reference's 'pallas'.
                 Only ops that have one list it.
  'dpia-torch' — the op's DPIA strategy (a point of its strategy space,
                 ``repro_torch.autotune``) through
                 ``Program.check().lower().compile("torch")``
  'dpia-cuda'  — the same strategy through the CUDA generator (K4):
                 one generated kernel per grid-level parfor
  'dpia-shardmap' — the op's mesh-level strategy (``repro_torch.mesh``)
                 through ``Program.compile("shardmap")`` on the mesh of
                 ``options(mesh=...)`` or the process mesh context: every
                 rank runs its shard (K4 on a CUDA tensor, the torch Stage
                 III on a CPU one) and a dot / asum issues one all_reduce
                 on the axis group; outputs are DTensors.  gemv has no mesh
                 strategy and takes its single-device DPIA row

A row is chosen per call (``impl=``), per scope (``with
repro_torch.compiler.options(backend=...):``, thread-local) or per explicit
``options=``: the row is ``impl or options.backend or the op's default``.
The default is 'cuda' for ``rmsnorm`` and ``flash_attention`` (the model
path) and 'plain' elsewhere, as the reference defaults to 'xla'.  A
user-registered Stage III backend ``<name>`` is the row ``dpia-<name>``
of every op.  An unknown impl raises ``ValueError`` naming the valid ones.

Dispatch follows the tensor.  On a CPU tensor every row computes through its
plain counterpart (a kernel row: its plain version; a DPIA row: the torch
Stage III).  On a CUDA tensor a kernel row ('cuda', 'dpia-cuda') launches its
kernel or raises; no row substitutes another on failure (the reference's
degradation ladder is not ported).  The 'dpia-shardmap' row keeps only
the reference's two placement decisions: with no mesh in scope, or no
mesh axis dividing the sharded extent, it runs the single-device DPIA row
of the tensor's device ('dpia-cuda' on a CUDA tensor, 'dpia-torch' on a
CPU one), warning once (``kernels.fallbacks``); any other failure raises
(the reference's catch-all fallback is not ported).  Compiled DPIA
programs live in the
process-wide executor cache (``repro_torch.compiler.executor_cache()``)
under ``executors.make_key``, so a program staged once, or loaded from
the AOT store, is found by every later call; each decision is recorded
in provenance (``obs.explain()``).

Strategy parameters of the DPIA rows (block and tile sizes, reduce
leaves) are chosen per shape and backend by ``repro_torch.autotune``
when ``options.autotune`` is on, as it is by default
(``REPRO_AUTOTUNE``): the ``dpia-torch`` row takes ``get_tuned`` (its
cost model, or a measured record in its persistent cache); the
``dpia-cuda`` row takes only a measured record (``get_measured``) and
otherwise runs the default point, because the cost model has no preset
measured on the card and its picks under the placeholder ``gpu`` preset
ran up to 3x slower there than the defaults (PERF.md).
``options(autotune=False)`` (or the deprecated ``set_autotune(False)``)
runs each kernel's default point (``default_params``, the tuner's own).
Executor keys carry the tuned params.  A failed lookup falls back to the default params, warning once
(``kernels.fallbacks``): the parameters change, never the kernel or the
device.  gemv has no strategy space and runs its default.
"""
from __future__ import annotations

import logging
import threading
import warnings
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import compiler, obs

# the tuner's default points and program names: one source of truth
from ..autotune.space import default_params, program_name  # noqa: F401
from ..compiler import CompileOptions, Program, current_options
from ..compiler import executors as _executors
from ..core.dpia import stage3_cuda
from . import dpia_blas, ref
from . import flash_attention as _fa
from . import matmul as _mm
from . import rmsnorm as _rms

log = logging.getLogger("repro_torch.kernels.ops")

# ---------------------------------------------------------------------------
# table-driven dispatch
# ---------------------------------------------------------------------------

_OP_IMPLS: Dict[str, Dict[str, Callable]] = {}
_DEFAULTS = {"rmsnorm": "cuda", "flash_attention": "cuda"}


def _impl_handler(op: str, *impls: str):
    """Register a handler for ``op`` under the given impl names."""
    def deco(fn):
        table = _OP_IMPLS.setdefault(op, {})
        for name in impls:
            table[name] = fn
        return fn
    return deco


def _dispatch(op: str, impl: Optional[str],
              options: Optional[CompileOptions], *args, **kw):
    opts = options if options is not None else current_options()
    name = impl or opts.backend or _DEFAULTS.get(op, "plain")
    table = _OP_IMPLS[op]
    fn = table.get(name)
    if (fn is None and name.startswith("dpia-")
            and name in compiler.ops_impls()):
        # a user-registered Stage III backend: the DPIA handlers derive the
        # backend from the impl name, so the 'dpia-torch' handler serves
        # every 'dpia-<registered>' impl
        fn = table.get("dpia-torch")
    if fn is None:
        raise ValueError(f"{op}: unknown impl {name!r}; valid impls: "
                         f"{sorted(table)}")
    return fn(name, opts, *args, **kw)


def impls(op: str) -> Tuple[str, ...]:
    """The impl names ``op`` takes."""
    return tuple(sorted(_OP_IMPLS[op]))


# ---------------------------------------------------------------------------
# DPIA rows: tuned or default strategies, staged once per executor key
# ---------------------------------------------------------------------------

# gemv has no strategy space in the reference's tuner (autotune/space.py
# ``_SPACES``): it always runs this row block
GEMV_ROW_BLOCK = 128

_tuned_memo: Dict[Tuple, Optional[dict]] = {}
_warned: set = set()
_LOCK = threading.Lock()


def program(kernel: str, params: Optional[Dict[str, object]] = None,
            **shape) -> Program:
    """``kernel``'s strategy at ``shape`` as a Program: the point ``params``
    of its strategy space (the default when None), derived from the naive
    spec by its strategy program (``Program.from_kernel``), so the
    ``strategy_trace`` rides along into the executor and the AOT store."""
    if kernel == "gemv":
        m, n = shape["m"], shape["n"]
        prog = Program.from_builder(
            lambda: dpia_blas.strategy_gemv(m, n, GEMV_ROW_BLOCK),
            kernel=kernel, shape=shape)
    else:
        prog = Program.from_kernel(kernel, params=params, **shape)
    prog.name = program_name(kernel, params, **shape)
    return prog


def compiled(kernel: str, backend: str, *,
             options: Optional[CompileOptions] = None,
             params: Optional[Dict[str, object]] = None, **shape):
    """``program(kernel, params, **shape).check().lower().compile(backend)``,
    memoised in the executor cache under a key that carries ``params``
    (None: the default strategy point): staged at most once per key per
    process, and never when the key was loaded from the AOT store.  Staging
    the default records its decision in provenance (a tuned decision is
    recorded by the tuner)."""
    opts = options if options is not None else current_options()
    key = _executors.make_key(kernel, shape, backend, params=params,
                              mesh=opts.mesh_descriptor(),
                              layout=opts.kv_layout)

    def build():
        fn = program(kernel, params, **shape).check().lower().compile(
            backend, options=opts)
        if params is None:
            obs.record("kernel", kernel, key, _default_of(kernel, shape),
                       "default", shape=dict(shape), backend=backend,
                       mesh=opts.mesh_descriptor(), layout=opts.kv_layout,
                       note=("autotune disabled in options"
                             if not opts.autotune else
                             "no measured record (the cuda row takes no "
                             "analytic pick)"
                             if backend == "cuda" and kernel != "gemv" else
                             "no tuned entry (no strategy space, or the "
                             "lookup failed)"))
        return fn

    return compiler.executor_cache().get_or_compile(key, build)


def _default_of(kernel: str, shape: Dict[str, object]) -> Dict[str, object]:
    if kernel == "gemv":
        return {"row_block": GEMV_ROW_BLOCK}
    return default_params(kernel, **shape)


def _warn_once(key: Tuple, msg: str) -> None:
    """One-shot fallback signal: an obs event and the always-on
    ``kernels.fallbacks`` counter every time, the module logger and a
    ``RuntimeWarning`` once per key."""
    obs.counter("kernels.fallbacks").inc()
    obs.event("kernels.fallback", kind=str(key[0]),
              key="/".join(str(k) for k in key), msg=msg)
    with _LOCK:
        if key in _warned:
            return
        _warned.add(key)
    log.warning("%s", msg)
    warnings.warn(msg, RuntimeWarning, stacklevel=4)


def _cache_token(cache) -> str:
    if cache is None:
        return "<default>"
    path = getattr(cache, "path", None)
    return str(path) if path is not None else str(cache)


def _tuned(kernel: str, backend: str, opts: CompileOptions, *,
           measured_only: Optional[bool] = None, **shape) -> Optional[dict]:
    """Tuned params for the kernel at this shape, or None (use defaults).

    Steady state is one dict lookup (a per-process memo); a cold shape
    costs one analytic ranking pass through the tuner's persistent cache
    (``autotune.get_tuned``, keyed by the backend, the mesh descriptor and
    the KV layout).  The ``cuda`` backend takes only a measured record
    (``autotune.get_measured``; None without one): the cost model has no
    preset measured on the card.  A failing lookup falls back to the
    default params and warns once per kernel / backend: the fallback
    changes parameters, never the kernel or the device.
    ``measured_only`` (default: ``backend == "cuda"``) takes only a
    measured record; the shardmap row sets it when its shards run K4."""
    if not opts.autotune:
        return None
    if measured_only is None:
        measured_only = backend == "cuda"
    memo_key = (kernel, backend, measured_only, opts.mesh_descriptor(),
                opts.kv_layout, _cache_token(opts.tuning_cache),
                tuple(sorted(shape.items())))
    if memo_key in _tuned_memo:
        return _tuned_memo[memo_key]
    from repro_torch import autotune
    try:
        lookup = (autotune.get_measured if measured_only
                  else autotune.get_tuned)
        params = lookup(kernel, backend=backend,
                        mesh=opts.mesh_descriptor(),
                        cache=opts.tuning_cache, layout=opts.kv_layout,
                        **shape)
    except Exception as e:  # the op runs with its defaults; never breaks
        params = None
        _warn_once(("tune", kernel, backend),
                   f"autotune lookup failed for {kernel!r} (backend "
                   f"{backend!r}): {type(e).__name__}: {e}; using the "
                   f"default strategy params")
    _tuned_memo[memo_key] = params
    return params


def _tuned_or_default(kernel: str, backend: str, opts: CompileOptions,
                      **shape):
    """The executor a DPIA row runs: the tuned candidate's when the options
    enable the tuner and the kernel has a strategy space, else the
    default's.  The tuner keys on the shape without ``eps``.  Staging
    tuned params that fail raises, as any staging failure does: no row
    substitutes another program on failure."""
    params = None
    if kernel != "gemv":
        params = _tuned(kernel, backend, opts,
                        **{k: v for k, v in shape.items() if k != "eps"})
    return compiled(kernel, backend, options=opts, params=params, **shape)


# ---------------------------------------------------------------------------
# mesh-level dispatch (the 'dpia-shardmap' row; see repro_torch.mesh)
# ---------------------------------------------------------------------------

MESH_OPS = ("dot", "asum", "scal", "matmul", "rmsnorm", "softmax")


def _shardable(kernel: str, mesh_obj, shape: Dict[str, object]) -> bool:
    """Whether a mesh axis (of size > 1) divides the kernel's sharded
    extent: the reference's placement decision."""
    from repro_torch import mesh as mesh_mod
    return bool(mesh_mod.space._eligible_axes(
        kernel, mesh_mod.axis_sizes(mesh_obj), shape))


def mesh_compiled(kernel: str, opts: CompileOptions, mesh_obj, inner: str,
                  **shape):
    """The executor of ``kernel``'s mesh placement on ``mesh_obj``, shards
    compiled by ``inner`` (``"cuda"``: K4; ``"torch"``).

    Placement params come from the tuner's mesh space, keyed by the mesh
    descriptor (with ``inner="cuda"`` only a measured record, as the
    ``dpia-cuda`` row), else the default placement.  The executor key
    carries the descriptor and ``inner``, so meshes and devices never share
    an executor, and an executor serves only the mesh object it was built
    on (a ``DeviceMesh`` holds its process groups).  Mesh programs skip
    ``check().lower()``: the shardmap backend consumes the functional
    term, the inner backend checks each shard's body."""
    from repro_torch import mesh as mesh_mod
    desc = mesh_mod.descriptor(mesh_obj)
    axes = mesh_mod.parse_descriptor(desc)
    tune_shape = {k: v for k, v in shape.items() if k != "eps"}
    params = _tuned(kernel, "shardmap", opts,
                    measured_only=inner == "cuda", **tune_shape)
    origin = "tuned"
    if params is None or params.get("mesh_axis") is None:
        params = mesh_mod.default_mesh_params(kernel, axes, **tune_shape)
        origin = "default"
    key_params = dict(params, inner=inner,
                      **({"eps": shape["eps"]} if "eps" in shape else {}))
    key = _executors.make_key(kernel, tune_shape, "shardmap",
                              params=key_params, mesh=desc,
                              layout=opts.kv_layout)
    name = mesh_program_name(kernel, params, **tune_shape)

    def build():
        cand = mesh_mod.mesh_candidate_from_params(kernel, params, axes,
                                                   **shape)
        prog = Program.from_builder(cand.build, name=name, kernel=kernel,
                                    shape=tune_shape)
        fn = prog.compile("shardmap", options=opts, mesh=mesh_obj,
                          inner=inner)
        if origin == "default":
            obs.record("mesh", kernel, key, params, "default",
                       shape=dict(tune_shape), backend="shardmap", mesh=desc,
                       layout=opts.kv_layout,
                       note=("autotune disabled in options"
                             if not opts.autotune else
                             "no measured record (K4 shards take no "
                             "analytic pick)" if inner == "cuda" else
                             "no tuned mesh entry"))
        return fn

    cache = compiler.executor_cache()
    fn = cache.get_or_compile(key, build)
    if fn.mesh is not mesh_obj:
        # the key names the mesh's axes and sizes, not its ranks or process
        # groups: another mesh of the same descriptor (other ranks, or
        # groups re-created after a destroy) gets an executor of its own
        fn = build()
        cache.put(key, fn)
    return fn


def mesh_program_name(kernel: str, params: Dict[str, object],
                      **shape) -> str:
    """The name of ``kernel``'s mesh program at the placement ``params``
    (its K4 shards build as ``build/dpia/<name>.shard_<axis><shards>-
    <hash>.so``)."""
    return "mesh_" + program_name(kernel, params, **shape)


def _local_of(x):
    """The tensor a DTensor holds on this rank (a plain tensor as is)."""
    to_local = getattr(x, "to_local", None)
    return to_local() if to_local is not None else x


def _single_row(x) -> str:
    """The single-device DPIA row of ``x``'s device."""
    return "dpia-cuda" if _local_of(x).is_cuda else "dpia-torch"


def _mesh_or_none(kernel: str, opts: CompileOptions, x, shape):
    """The 'dpia-shardmap' executor for ``kernel`` at ``shape``, its shards
    compiled for ``x``'s device, or None on the reference's two placement
    decisions (no mesh in scope; no mesh axis divides the extent), where
    the op runs its single-device row, warning once.  Any other failure
    raises."""
    mesh_obj = opts.resolved_mesh()
    row = _single_row(x)
    if mesh_obj is None:
        _warn_once(("mesh", kernel, "nomesh"),
                   f"{kernel}: impl 'dpia-shardmap' selected but no mesh is "
                   f"in scope (options(mesh=...) / sharding.ctx.set_mesh); "
                   f"using the single-device {row} row")
        return None
    if not _shardable(kernel, mesh_obj, shape):
        _warn_once(("mesh", kernel, "indivisible"),
                   f"{kernel}: no axis of mesh {mesh_obj.mesh_dim_names} "
                   f"{tuple(mesh_obj.shape)} divides its extent at {shape}; "
                   f"using the single-device {row} row")
        return None
    return mesh_compiled(kernel, opts, mesh_obj,
                         "cuda" if row == "dpia-cuda" else "torch", **shape)


def warm_kernel(kernel: str, *, backend: Optional[str] = None,
                options: Optional[CompileOptions] = None, **shape):
    """Stage (and, for ``cuda``, generate the source of) the executor the
    DPIA dispatch path would use for ``kernel`` at ``shape``, tuned params
    included, without running it: the same cache key as the ops' DPIA
    rows, so a warmed executor is a guaranteed hit.  ``backend`` defaults
    to the options' Stage III backend.  Persist the result with
    ``repro_torch.compiler.executor_cache().save_aot(dir)``."""
    opts = options if options is not None else current_options()
    if kernel == "rmsnorm":
        shape["eps"] = float(shape.get("eps", 1e-6))
    b = backend or opts.dpia_backend
    if b == "shardmap":
        # the mesh's device decides the shards' inner backend, as a
        # tensor's device does at a call; an unshardable shape (or no
        # mesh) warms the single-device row the call would take
        mesh_obj = opts.resolved_mesh()
        inner = ("cuda" if mesh_obj is not None
                 and mesh_obj.device_type == "cuda" else "torch")
        if mesh_obj is not None and kernel in MESH_OPS and _shardable(
                kernel, mesh_obj, shape):
            return mesh_compiled(kernel, opts, mesh_obj, inner, **shape)
        b = inner
    return _tuned_or_default(kernel, b, opts, **shape)


def clear_caches() -> None:
    """Drop the staged DPIA programs (the executor cache), the tuned-params
    memo and the one-shot warning state."""
    compiler.executor_cache().clear()
    _tuned_memo.clear()
    _warned.clear()


def set_default_impl(impl: str) -> None:
    """Deprecated: mutate the process-wide default impl.

    Use ``with repro_torch.compiler.options(backend=...):`` (thread-local
    scope) or per-call ``impl=`` / ``options=`` instead."""
    warnings.warn(
        "set_default_impl is deprecated; use "
        "repro_torch.compiler.options(backend=...) or pass impl=/options= "
        "per call", DeprecationWarning, stacklevel=2)
    valid = compiler.ops_impls()
    if impl not in valid:
        raise ValueError(f"unknown impl {impl!r}; valid backends: "
                         f"{list(valid)}")
    compiler.set_default_options(backend=impl)


def set_autotune(enabled: bool, cache=None) -> None:
    """Deprecated: toggle autotuned strategy selection process-wide.

    Use ``with repro_torch.compiler.options(autotune=...,
    tuning_cache=...):`` instead.  Compiled programs and the params memo
    are dropped so the change takes effect."""
    warnings.warn(
        "set_autotune is deprecated; use "
        "repro_torch.compiler.options(autotune=..., tuning_cache=...)",
        DeprecationWarning, stacklevel=2)
    compiler.set_default_options(autotune=bool(enabled), tuning_cache=cache)
    clear_caches()


def _backend(impl: str) -> str:
    return impl[len("dpia-"):]


# ---------------------------------------------------------------------------
# launch counts
# ---------------------------------------------------------------------------

_KERNEL_MODULES = {"rmsnorm": _rms, "matmul": _mm, "flash_attention": _fa,
                   "dpia_cuda": stage3_cuda,
                   "rmsnorm_bwd": _rms.backward,
                   "flash_attention_bwd": _fa.backward}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset: K1 ``rmsnorm``, K2
    ``matmul``, K3 ``flash_attention``, K4 ``dpia_cuda`` (every kernel
    of every generated program), and the backward kernels of K1 and K3
    (``rmsnorm_bwd``, ``flash_attention_bwd``: one count a call of the
    C entry point, which launches two and three kernels)."""
    return {name: mod.launches for name, mod in _KERNEL_MODULES.items()}


def launch_counts_by_variant() -> Dict[str, Dict[str, int]]:
    """Launches since the last reset per variant of the kernels that have
    several: K1 ``rmsnorm`` (packed, warp, block), K2 ``matmul`` (wgmma,
    splitk_reduce, skinny, skinny_reduce, tf32x3, mma), K3
    ``flash_attention`` (mma, tf32x3) and its backward
    ``flash_attention_bwd`` (mma, tf32x3)."""
    return {name: dict(mod.launches_by_variant)
            for name, mod in _KERNEL_MODULES.items()
            if hasattr(mod, "launches_by_variant")}


def launch_snapshot() -> Dict[Tuple[str, Optional[str]], int]:
    """Every kernel's count (key ``(kernel, None)``) and each variant's
    (``(kernel, variant)``), flat, for :func:`add_launches`."""
    snap = {(name, None): mod.launches
            for name, mod in _KERNEL_MODULES.items()}
    for name, by_variant in launch_counts_by_variant().items():
        snap.update({(name, v): n for v, n in by_variant.items()})
    return snap


def add_launches(delta: Dict[Tuple[str, Optional[str]], int],
                 times: int = 1) -> None:
    """Add ``times`` x ``delta`` (a difference of two
    :func:`launch_snapshot` s) to the counts.

    For CUDA graphs: a wrapper counts when it is called, and under capture
    that call records its kernel without launching it.  The owner of a
    graph takes the capture's counts back (``times=-1``) and adds them
    once per replay, which is when the captured kernels launch."""
    for (name, variant), n in delta.items():
        mod = _KERNEL_MODULES[name]
        if variant is None:
            mod.launches += times * n
        else:
            mod.launches_by_variant[variant] += times * n


def reset_launch_counts() -> None:
    """Zero every kernel's count, and each cached generated program's."""
    for mod in _KERNEL_MODULES.values():
        mod.launches = 0
        for key in getattr(mod, "launches_by_variant", ()):
            mod.launches_by_variant[key] = 0
    for fn in compiler.executor_cache().values():
        if fn.backend in ("cuda", "shardmap"):
            fn._fn.launches = 0


# ---- BLAS ops (paper section 7) ---------------------------------------------

def scal(alpha, x, impl: str | None = None,
         options: CompileOptions | None = None):
    return _dispatch("scal", impl, options, alpha, x)


@_impl_handler("scal", "plain")
def _scal_ref(impl, opts, alpha, x):
    return ref.scal(alpha, x)


@_impl_handler("scal", "dpia-torch", "dpia-cuda")
def _scal_dpia(impl, opts, alpha, x):
    fn = _tuned_or_default("scal", _backend(impl), opts, n=x.shape[0])
    return fn(torch.as_tensor(alpha, dtype=x.dtype, device=x.device), x)


@_impl_handler("scal", "dpia-shardmap")
def _scal_mesh(impl, opts, alpha, x):
    fn = _mesh_or_none("scal", opts, x, dict(n=x.shape[0]))
    if fn is None:
        return _scal_dpia(_single_row(x), opts, alpha, x)
    loc = _local_of(x)
    return fn(torch.as_tensor(alpha, dtype=loc.dtype, device=loc.device), x)


def asum(x, impl: str | None = None, options: CompileOptions | None = None):
    return _dispatch("asum", impl, options, x)


@_impl_handler("asum", "plain")
def _asum_ref(impl, opts, x):
    return ref.asum(x)


@_impl_handler("asum", "dpia-torch", "dpia-cuda")
def _asum_dpia(impl, opts, x):
    return _tuned_or_default("asum", _backend(impl), opts, n=x.shape[0])(x)


@_impl_handler("asum", "dpia-shardmap")
def _asum_mesh(impl, opts, x):
    fn = _mesh_or_none("asum", opts, x, dict(n=x.shape[0]))
    return fn(x) if fn is not None else _asum_dpia(_single_row(x), opts, x)


def dot(x, y, impl: str | None = None, options: CompileOptions | None = None):
    return _dispatch("dot", impl, options, x, y)


@_impl_handler("dot", "plain")
def _dot_ref(impl, opts, x, y):
    return ref.dot(x, y)


@_impl_handler("dot", "dpia-torch", "dpia-cuda")
def _dot_dpia(impl, opts, x, y):
    fn = _tuned_or_default("dot", _backend(impl), opts, n=x.shape[0])
    return fn(x, y)


@_impl_handler("dot", "dpia-shardmap")
def _dot_mesh(impl, opts, x, y):
    fn = _mesh_or_none("dot", opts, x, dict(n=x.shape[0]))
    return fn(x, y) if fn is not None else _dot_dpia(_single_row(x), opts,
                                                     x, y)


def gemv(a, x, impl: str | None = None, options: CompileOptions | None = None):
    return _dispatch("gemv", impl, options, a, x)


@_impl_handler("gemv", "plain")
def _gemv_ref(impl, opts, a, x):
    return ref.gemv(a, x)


@_impl_handler("gemv", "dpia-torch", "dpia-cuda")
def _gemv_dpia(impl, opts, a, x):
    m, n = a.shape
    return _tuned_or_default("gemv", _backend(impl), opts, m=m, n=n)(a, x)


@_impl_handler("gemv", "dpia-shardmap")
def _gemv_mesh(impl, opts, a, x):
    # gemv has no mesh strategy (as in the reference): its single-device row
    return _gemv_dpia(_single_row(a), opts, a, x)


# ---- transformer ops ---------------------------------------------------------

def matmul(a, b, impl: str | None = None, out_dtype=None,
           options: CompileOptions | None = None):
    return _dispatch("matmul", impl, options, a, b, out_dtype=out_dtype)


@_impl_handler("matmul", "plain")
def _matmul_ref(impl, opts, a, b, out_dtype=None):
    return ref.matmul(a, b, out_dtype=out_dtype)


@_impl_handler("matmul", "cuda")
def _matmul_kernel(impl, opts, a, b, out_dtype=None):
    return _mm.matmul(a, b, out_dtype=out_dtype)


@_impl_handler("matmul", "dpia-torch", "dpia-cuda")
def _matmul_dpia(impl, opts, a, b, out_dtype=None):
    (m, k), n = a.shape, b.shape[1]
    fn = _tuned_or_default("matmul", _backend(impl), opts, m=m, k=k, n=n)
    return fn(a.float(), b.float()).to(out_dtype or a.dtype)


@_impl_handler("matmul", "dpia-shardmap")
def _matmul_mesh(impl, opts, a, b, out_dtype=None):
    (m, k), n = a.shape, b.shape[1]
    fn = _mesh_or_none("matmul", opts, a, dict(m=m, k=k, n=n))
    if fn is None:
        return _matmul_dpia(_single_row(a), opts, a, b, out_dtype=out_dtype)
    return fn(a.float(), b.float()).to(out_dtype or a.dtype)


def rmsnorm(x, w, eps: float = 1e-6, impl: str | None = None,
            options: CompileOptions | None = None):
    return _dispatch("rmsnorm", impl, options, x, w, eps=eps)


@_impl_handler("rmsnorm", "plain")
def _rmsnorm_ref(impl, opts, x, w, eps=1e-6):
    return ref.rmsnorm(x, w, eps=eps)


@_impl_handler("rmsnorm", "cuda")
def _rmsnorm_kernel(impl, opts, x, w, eps=1e-6):
    return _rms.rmsnorm(x, w, eps=eps)


@_impl_handler("rmsnorm", "dpia-torch", "dpia-cuda")
def _rmsnorm_dpia(impl, opts, x, w, eps=1e-6):
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    fn = _tuned_or_default("rmsnorm", _backend(impl), opts,
                           rows=x2.shape[0], d=d, eps=float(eps))
    return fn(x2.float().contiguous(), w.float()).reshape(x.shape).to(x.dtype)


@_impl_handler("rmsnorm", "dpia-shardmap")
def _rmsnorm_mesh(impl, opts, x, w, eps=1e-6):
    d = x.shape[-1]
    x2 = x if x.ndim == 2 else x.reshape(-1, d)
    fn = _mesh_or_none("rmsnorm", opts, x,
                       dict(rows=x2.shape[0], d=d, eps=float(eps)))
    if fn is None:
        return _rmsnorm_dpia(_single_row(x), opts, x, w, eps=eps)
    out = fn(x2.float().contiguous(), w.float())
    return (out if x.ndim == 2 else out.reshape(x.shape)).to(x.dtype)


def softmax(x, axis: int = -1, impl: str | None = None,
            options: CompileOptions | None = None):
    return _dispatch("softmax", impl, options, x, axis=axis)


@_impl_handler("softmax", "plain")
def _softmax_ref(impl, opts, x, axis=-1):
    return ref.softmax(x, dim=axis)


@_impl_handler("softmax", "dpia-torch", "dpia-cuda")
def _softmax_dpia(impl, opts, x, axis=-1):
    if x.ndim < 2 or axis not in (-1, x.ndim - 1):
        # the DPIA strategy covers row softmax only (as in the reference)
        if x.device.type == "cpu":
            return ref.softmax(x, dim=axis)
        raise ValueError(f"softmax: impl {impl!r} covers the last axis of a "
                         f"matrix only; got axis {axis} of {x.ndim} dims")
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    fn = _tuned_or_default("softmax", _backend(impl), opts,
                           rows=x2.shape[0], d=d)
    return fn(x2.float().contiguous()).reshape(x.shape).to(x.dtype)


@_impl_handler("softmax", "dpia-shardmap")
def _softmax_mesh(impl, opts, x, axis=-1):
    if x.ndim < 2 or axis not in (-1, x.ndim - 1):
        return _softmax_dpia(_single_row(x), opts, x, axis=axis)
    d = x.shape[-1]
    x2 = x if x.ndim == 2 else x.reshape(-1, d)
    fn = _mesh_or_none("softmax", opts, x, dict(rows=x2.shape[0], d=d))
    if fn is None:
        return _softmax_dpia(_single_row(x), opts, x, axis=axis)
    out = fn(x2.float().contiguous())
    return (out if x.ndim == 2 else out.reshape(x.shape)).to(x.dtype)


def flash_attention(q, k, v, *, causal: bool = True, scale=None,
                    q_offset: int = 0, impl: str | None = None,
                    options: CompileOptions | None = None):
    """Attention (see :func:`ref.flash_attention`).  There is no DPIA
    flash-attention strategy in either package, so the ``dpia-*`` names take
    the 'cuda' row: K3 on a CUDA tensor, the plain version on a CPU one."""
    return _dispatch("flash_attention", impl, options, q, k, v,
                     causal=causal, scale=scale, q_offset=q_offset)


@_impl_handler("flash_attention", "plain")
def _fa_ref(impl, opts, q, k, v, *, causal=True, scale=None, q_offset=0):
    return ref.flash_attention(q, k, v, causal=causal, scale=scale,
                               q_offset=q_offset)


@_impl_handler("flash_attention", "cuda", "dpia-torch", "dpia-cuda",
               "dpia-shardmap")
def _fa_kernel(impl, opts, q, k, v, *, causal=True, scale=None, q_offset=0):
    return _fa.flash_attention(q, k, v, causal=causal, scale=scale,
                               q_offset=q_offset)
