"""The port's kernel API, as the models call it.

Every op takes the arguments of ``repro.kernels.ops``'s function of the same
name and an ``impl=`` naming one row of its table:

  'plain'      — the plain PyTorch version (``ref``); the reference's 'xla'
  'cuda'       — the hand-written CUDA kernel: K1 RMSNorm, K2 matmul,
                 K3 flash attention; the reference's 'pallas'.
                 Only ops that have one list it.
  'dpia-torch' — the op's DPIA strategy (``dpia_blas.strategy_*`` at the
                 reference's default parameters) through
                 ``Program.check().lower().compile("torch")``
  'dpia-cuda'  — the same strategy through the CUDA generator (K4):
                 one generated kernel per grid-level parfor

``impl=None`` is 'cuda' for ``rmsnorm`` and ``flash_attention`` (the model
path) and 'plain' elsewhere, as the reference defaults to 'xla'.  An unknown
impl raises ``ValueError`` naming the valid ones.

Dispatch follows the tensor.  On a CPU tensor every row computes through its
plain counterpart (a kernel row: its plain version; a DPIA row: the torch
Stage III).  On a CUDA tensor a kernel row ('cuda', 'dpia-cuda') launches its
kernel or raises; no row substitutes another on failure.  Compiled DPIA
programs are memoised per (kernel, shape, backend).  The reference's options
scope, autotuned parameters and degradation ladder are not ported
(ROADMAP.md).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..compiler import Program
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


def _dispatch(op: str, impl: Optional[str], *args, **kw):
    name = impl or _DEFAULTS.get(op, "plain")
    fn = _OP_IMPLS[op].get(name)
    if fn is None:
        raise ValueError(f"{op}: unknown impl {name!r}; valid impls: "
                         f"{sorted(_OP_IMPLS[op])}")
    return fn(name, *args, **kw)


def impls(op: str) -> Tuple[str, ...]:
    """The impl names ``op`` takes."""
    return tuple(sorted(_OP_IMPLS[op]))


# ---------------------------------------------------------------------------
# DPIA rows: default strategies, compiled once per (kernel, shape, backend)
# ---------------------------------------------------------------------------

# the reference's candidate block menu (repro/autotune/space.py:45)
SPLIT_BLOCKS = (128, 256, 512, 1024, 2048, 4096, 8192)

_compiled: Dict[Tuple, object] = {}


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
                                name=program_name(kernel, **shape))


def compiled(kernel: str, backend: str, **shape):
    """``program(kernel, **shape).check().lower().compile(backend)``,
    memoised per (kernel, shape, backend)."""
    key = (kernel, backend, tuple(sorted(shape.items())))
    fn = _compiled.get(key)
    if fn is None:
        fn = _compiled[key] = program(kernel, **shape).check().lower(
            ).compile(backend)
    return fn


def clear_caches() -> None:
    """Drop the memoised DPIA programs."""
    _compiled.clear()


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
    """Zero every kernel's count, and each memoised generated program's."""
    for mod in _KERNEL_MODULES.values():
        mod.launches = 0
        for key in getattr(mod, "launches_by_variant", ()):
            mod.launches_by_variant[key] = 0
    for fn in _compiled.values():
        if fn.backend == "cuda":
            fn._fn.launches = 0


# ---- BLAS ops (paper section 7) ---------------------------------------------

def scal(alpha, x, impl: str | None = None):
    return _dispatch("scal", impl, alpha, x)


@_impl_handler("scal", "plain")
def _scal_ref(impl, alpha, x):
    return ref.scal(alpha, x)


@_impl_handler("scal", "dpia-torch", "dpia-cuda")
def _scal_dpia(impl, alpha, x):
    fn = compiled("scal", _backend(impl), n=x.shape[0])
    return fn(torch.as_tensor(alpha, dtype=x.dtype, device=x.device), x)


def asum(x, impl: str | None = None):
    return _dispatch("asum", impl, x)


@_impl_handler("asum", "plain")
def _asum_ref(impl, x):
    return ref.asum(x)


@_impl_handler("asum", "dpia-torch", "dpia-cuda")
def _asum_dpia(impl, x):
    return compiled("asum", _backend(impl), n=x.shape[0])(x)


def dot(x, y, impl: str | None = None):
    return _dispatch("dot", impl, x, y)


@_impl_handler("dot", "plain")
def _dot_ref(impl, x, y):
    return ref.dot(x, y)


@_impl_handler("dot", "dpia-torch", "dpia-cuda")
def _dot_dpia(impl, x, y):
    return compiled("dot", _backend(impl), n=x.shape[0])(x, y)


def gemv(a, x, impl: str | None = None):
    return _dispatch("gemv", impl, a, x)


@_impl_handler("gemv", "plain")
def _gemv_ref(impl, a, x):
    return ref.gemv(a, x)


@_impl_handler("gemv", "dpia-torch", "dpia-cuda")
def _gemv_dpia(impl, a, x):
    m, n = a.shape
    return compiled("gemv", _backend(impl), m=m, n=n)(a, x)


# ---- transformer ops ---------------------------------------------------------

def matmul(a, b, impl: str | None = None, out_dtype=None):
    return _dispatch("matmul", impl, a, b, out_dtype=out_dtype)


@_impl_handler("matmul", "plain")
def _matmul_ref(impl, a, b, out_dtype=None):
    return ref.matmul(a, b, out_dtype=out_dtype)


@_impl_handler("matmul", "cuda")
def _matmul_kernel(impl, a, b, out_dtype=None):
    return _mm.matmul(a, b, out_dtype=out_dtype)


@_impl_handler("matmul", "dpia-torch", "dpia-cuda")
def _matmul_dpia(impl, a, b, out_dtype=None):
    (m, k), n = a.shape, b.shape[1]
    fn = compiled("matmul", _backend(impl), m=m, k=k, n=n)
    return fn(a.float(), b.float()).to(out_dtype or a.dtype)


def rmsnorm(x, w, eps: float = 1e-6, impl: str | None = None):
    return _dispatch("rmsnorm", impl, x, w, eps=eps)


@_impl_handler("rmsnorm", "plain")
def _rmsnorm_ref(impl, x, w, eps=1e-6):
    return ref.rmsnorm(x, w, eps=eps)


@_impl_handler("rmsnorm", "cuda")
def _rmsnorm_kernel(impl, x, w, eps=1e-6):
    return _rms.rmsnorm(x, w, eps=eps)


@_impl_handler("rmsnorm", "dpia-torch", "dpia-cuda")
def _rmsnorm_dpia(impl, x, w, eps=1e-6):
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    fn = compiled("rmsnorm", _backend(impl), rows=x2.shape[0], d=d,
                  eps=float(eps))
    return fn(x2.float().contiguous(), w.float()).reshape(x.shape).to(x.dtype)


def softmax(x, axis: int = -1, impl: str | None = None):
    return _dispatch("softmax", impl, x, axis=axis)


@_impl_handler("softmax", "plain")
def _softmax_ref(impl, x, axis=-1):
    return ref.softmax(x, dim=axis)


@_impl_handler("softmax", "dpia-torch", "dpia-cuda")
def _softmax_dpia(impl, x, axis=-1):
    if x.ndim < 2 or axis not in (-1, x.ndim - 1):
        # the DPIA strategy covers row softmax only (as in the reference)
        if x.device.type == "cpu":
            return ref.softmax(x, dim=axis)
        raise ValueError(f"softmax: impl {impl!r} covers the last axis of a "
                         f"matrix only; got axis {axis} of {x.ndim} dims")
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    fn = compiled("softmax", _backend(impl), rows=x2.shape[0], d=d)
    return fn(x2.float().contiguous()).reshape(x.shape).to(x.dtype)


def flash_attention(q, k, v, *, causal: bool = True, scale=None,
                    q_offset: int = 0, impl: str | None = None):
    """Attention (see :func:`ref.flash_attention`).  There is no DPIA
    flash-attention strategy in either package, so the ``dpia-*`` names take
    the 'cuda' row: K3 on a CUDA tensor, the plain version on a CPU one."""
    return _dispatch("flash_attention", impl, q, k, v, causal=causal,
                     scale=scale, q_offset=q_offset)


@_impl_handler("flash_attention", "plain")
def _fa_ref(impl, q, k, v, *, causal=True, scale=None, q_offset=0):
    return ref.flash_attention(q, k, v, causal=causal, scale=scale,
                               q_offset=q_offset)


@_impl_handler("flash_attention", "cuda", "dpia-torch", "dpia-cuda")
def _fa_kernel(impl, q, k, v, *, causal=True, scale=None, q_offset=0):
    return _fa.flash_attention(q, k, v, causal=causal, scale=scale,
                               q_offset=q_offset)
