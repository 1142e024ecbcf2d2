"""The port's kernel API, as the models call it.

Every op takes the arguments of ``repro.kernels.ops``'s function of the same
name, an ``impl=`` naming one row of its table and an ``options=``
(:class:`repro_torch.compiler.CompileOptions`):

  'plain'      — the plain PyTorch version (``ref``); the reference's 'xla'
  'cuda'       — the hand-written CUDA kernel: K1 RMSNorm, K2 matmul,
                 K3 flash attention; the reference's 'pallas'.
                 Only ops that have one list it.
  'dpia-torch' — the op's DPIA strategy (``dpia_blas.strategy_*`` at the
                 reference's default parameters) through
                 ``Program.check().lower().compile("torch")``
  'dpia-cuda'  — the same strategy through the CUDA generator (K4):
                 one generated kernel per grid-level parfor

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
degradation ladder is not ported).  Compiled DPIA programs live in the
process-wide executor cache (``repro_torch.compiler.executor_cache()``)
under ``executors.make_key``, so a program staged once, or loaded from
the AOT store, is found by every later call; each default-strategy
decision is recorded in provenance (``obs.explain()``, origin
``default``).  The reference's autotuned parameters wait for the
autotuner (ROADMAP.md).
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import compiler, obs

from ..compiler import CompileOptions, Program, current_options
from ..compiler import executors as _executors
from ..core.dpia import stage3_cuda
from . import dpia_blas, ref
from . import flash_attention as _fa
from . import matmul as _mm
from . import rmsnorm as _rms

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
# DPIA rows: default strategies, staged once per executor key
# ---------------------------------------------------------------------------

# the reference's candidate block menu (repro/autotune/space.py:45)
SPLIT_BLOCKS = (128, 256, 512, 1024, 2048, 4096, 8192)


def default_params(kernel: str, **shape) -> Dict[str, object]:
    """The un-tuned strategy parameters each kernel ships with: the port's
    copy of ``repro.autotune.space.default_params`` (space.py:304-323)."""
    if kernel in ("dot", "asum", "scal"):
        n = shape["n"]
        b = 2048 if n % 2048 == 0 else max(
            x for x in SPLIT_BLOCKS + (n,) if n % x == 0)
        return {"block": b}
    if kernel == "matmul":
        return {"bm": min(128, shape["m"]), "bk": min(128, shape["k"])}
    if kernel in ("rmsnorm", "softmax"):
        return {"row_block": 8 if shape["rows"] % 8 == 0 else 1}
    if kernel == "gemv":
        return {"row_block": 128}
    raise ValueError(f"default_params: unknown kernel {kernel!r}")


_BUILDERS = {
    "scal": lambda n, block: dpia_blas.strategy_scal(n, block),
    "asum": lambda n, block: dpia_blas.strategy_asum(n, block),
    "dot": lambda n, block: dpia_blas.strategy_dot(n, block),
    "gemv": lambda m, n, row_block: dpia_blas.strategy_gemv(m, n, row_block),
    "matmul": lambda m, k, n, bm, bk: dpia_blas.strategy_matmul(
        m, k, n, bm, bk),
    "rmsnorm": lambda rows, d, eps, row_block: dpia_blas.strategy_rmsnorm(
        rows, d, eps, row_block),
    "softmax": lambda rows, d, row_block: dpia_blas.strategy_softmax(
        rows, d, row_block),
}


def program_name(kernel: str, **shape) -> str:
    """The name of ``kernel``'s program at ``shape`` (its generated source is
    built as ``build/dpia/<name>-<hash>.so``)."""
    return "_".join([kernel] + [str(v) for v in shape.values()])


def program(kernel: str, **shape) -> Program:
    """``kernel``'s default strategy at ``shape`` as a Program."""
    params = default_params(kernel, **shape)
    return Program.from_builder(lambda: _BUILDERS[kernel](**shape, **params),
                                name=program_name(kernel, **shape),
                                kernel=kernel, shape=shape)


def compiled(kernel: str, backend: str, *,
             options: Optional[CompileOptions] = None, **shape):
    """``program(kernel, **shape).check().lower().compile(backend)``,
    memoised in the executor cache: staged at most once per key per
    process, and never when the key was loaded from the AOT store.  The
    staging records the default-strategy decision in provenance."""
    opts = options if options is not None else current_options()
    key = _executors.make_key(kernel, shape, backend,
                              mesh=opts.mesh_descriptor(),
                              layout=opts.kv_layout)

    def build():
        fn = program(kernel, **shape).check().lower().compile(
            backend, options=opts)
        obs.record("kernel", kernel, key, default_params(kernel, **shape),
                   "default", shape=dict(shape), backend=backend,
                   mesh=opts.mesh_descriptor(), layout=opts.kv_layout,
                   note="autotune disabled in options (the port has no "
                        "autotuner yet)")
        return fn

    return compiler.executor_cache().get_or_compile(key, build)


def warm_kernel(kernel: str, *, backend: Optional[str] = None,
                options: Optional[CompileOptions] = None, **shape):
    """Stage (and, for ``cuda``, generate the source of) the executor the
    DPIA dispatch path would use for ``kernel`` at ``shape``, without
    running it: the same cache key as the ops' DPIA rows, so a warmed
    executor is a guaranteed hit.  ``backend`` defaults to the options'
    Stage III backend.  Persist the result with
    ``repro_torch.compiler.executor_cache().save_aot(dir)``."""
    opts = options if options is not None else current_options()
    if kernel == "rmsnorm":
        shape["eps"] = float(shape.get("eps", 1e-6))
    return compiled(kernel, backend or opts.dpia_backend, options=opts,
                    **shape)


def clear_caches() -> None:
    """Drop the staged DPIA programs (the executor cache)."""
    compiler.executor_cache().clear()


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


def _backend(impl: str) -> str:
    return impl[len("dpia-"):]


# ---------------------------------------------------------------------------
# launch counts
# ---------------------------------------------------------------------------

_KERNEL_MODULES = {"rmsnorm": _rms, "matmul": _mm, "flash_attention": _fa,
                   "dpia_cuda": stage3_cuda}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset: K1 ``rmsnorm``, K2
    ``matmul``, K3 ``flash_attention`` and K4 ``dpia_cuda`` (every kernel
    of every generated program)."""
    return {name: mod.launches for name, mod in _KERNEL_MODULES.items()}


def launch_counts_by_variant() -> Dict[str, Dict[str, int]]:
    """Launches since the last reset per variant of the kernels that have
    several: K1 ``rmsnorm`` (packed, warp, block), K2 ``matmul`` (wgmma,
    splitk_reduce, simt) and K3 ``flash_attention`` (mma, simt)."""
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
        if fn.backend == "cuda":
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
    fn = compiled("scal", _backend(impl), options=opts, n=x.shape[0])
    return fn(torch.as_tensor(alpha, dtype=x.dtype, device=x.device), x)


def asum(x, impl: str | None = None, options: CompileOptions | None = None):
    return _dispatch("asum", impl, options, x)


@_impl_handler("asum", "plain")
def _asum_ref(impl, opts, x):
    return ref.asum(x)


@_impl_handler("asum", "dpia-torch", "dpia-cuda")
def _asum_dpia(impl, opts, x):
    return compiled("asum", _backend(impl), options=opts, n=x.shape[0])(x)


def dot(x, y, impl: str | None = None, options: CompileOptions | None = None):
    return _dispatch("dot", impl, options, x, y)


@_impl_handler("dot", "plain")
def _dot_ref(impl, opts, x, y):
    return ref.dot(x, y)


@_impl_handler("dot", "dpia-torch", "dpia-cuda")
def _dot_dpia(impl, opts, x, y):
    return compiled("dot", _backend(impl), options=opts, n=x.shape[0])(x, y)


def gemv(a, x, impl: str | None = None, options: CompileOptions | None = None):
    return _dispatch("gemv", impl, options, a, x)


@_impl_handler("gemv", "plain")
def _gemv_ref(impl, opts, a, x):
    return ref.gemv(a, x)


@_impl_handler("gemv", "dpia-torch", "dpia-cuda")
def _gemv_dpia(impl, opts, a, x):
    m, n = a.shape
    return compiled("gemv", _backend(impl), options=opts, m=m, n=n)(a, x)


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
    fn = compiled("matmul", _backend(impl), options=opts, m=m, k=k, n=n)
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
    fn = compiled("rmsnorm", _backend(impl), options=opts, rows=x2.shape[0],
                  d=d, eps=float(eps))
    return fn(x2.float().contiguous(), w.float()).reshape(x.shape).to(x.dtype)


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
    fn = compiled("softmax", _backend(impl), options=opts, rows=x2.shape[0],
                  d=d)
    return fn(x2.float().contiguous()).reshape(x.shape).to(x.dtype)


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


@_impl_handler("flash_attention", "cuda", "dpia-torch", "dpia-cuda")
def _fa_kernel(impl, opts, q, k, v, *, causal=True, scale=None, q_offset=0):
    return _fa.flash_attention(q, k, v, causal=causal, scale=scale,
                               q_offset=q_offset)
