"""Compilation options: explicit, immutable, thread-locally scoped.

The port's copy of ``repro.compiler.options``.  :class:`CompileOptions` is
the record of what a kernel compilation depends on besides the term
itself.  It is threaded *explicitly* (every op takes an ``options=``
argument) with a thread-local context-manager stack for scoping::

    with compiler.options(backend="dpia-cuda"):
        y = ops.dot(x, y)             # sees the scoped options

Scopes nest (inner scopes inherit unset fields from the enclosing scope)
and are per-thread, so concurrent serving threads can run different
backends without racing on a global.  The process-wide *default* (what
``current_options()`` returns outside any scope) exists for the deprecated
``ops.set_default_impl`` shim and for start-up configuration via
:func:`set_default_options`.

Where the port differs from the reference:

* ``backend`` defaults to ``None``: each op takes its own default row
  (``kernels.ops``: the hand-written kernels K1 for ``rmsnorm`` and K3 for
  ``flash_attention``, ``plain`` elsewhere), so the model path does not
  move.  The reference's default is ``"xla"`` for every op.
* ``autotune`` follows ``REPRO_AUTOTUNE`` as in the reference (on unless
  it is ``"0"``); it changes the parameters of the DPIA rows only
  (``dpia-*``), never an op's kernel or its device.  The ``dpia-cuda``
  row takes only params measured on the card (``kernels.ops``).
* ``mesh`` takes only ``None`` (mesh and sharded serving are not ported
  yet: ROADMAP.md queue 1 item 7, mesh);
  :meth:`CompileOptions.mesh_descriptor` is ``"single"``.
* the reference's ``interpret`` (Pallas interpret mode) and ``jit``
  (``jax.jit`` around compiled programs) have no counterpart here and are
  left out, as is ``default_interpret``.
"""
from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field, replace as _dc_replace
from typing import Optional

from .backends import ops_impls

__all__ = ["CompileOptions", "options", "current_options",
           "set_default_options", "default_options"]


def _env_autotune() -> bool:
    return os.environ.get("REPRO_AUTOTUNE", "1") != "0"


@dataclass(frozen=True)
class CompileOptions:
    """Everything a kernel compilation depends on besides the term itself.

    backend       kernel-layer impl name: 'plain' | 'cuda' | 'dpia-<stage3>'
                  (validated against the backend registry); None: each
                  op's own default row
    autotune      let repro_torch.autotune choose the DPIA rows' strategy
                  params (default: the REPRO_AUTOTUNE env var, on unless
                  it is "0")
    tuning_cache  None (process default cache), a path, or a TuningCache
    mesh          must be None until the mesh slice is ported
    kv_layout     the serving KV-memory strategy this compilation scope
                  belongs to ('dense' | 'paged'); an executor-cache key
                  dimension, so artefacts staged for one memory layout
                  never serve the other
    """
    backend: Optional[str] = None
    autotune: bool = field(default_factory=_env_autotune)
    tuning_cache: object = None
    mesh: object = None
    kv_layout: str = "dense"

    def __post_init__(self):
        if self.backend is not None and self.backend not in ops_impls():
            raise ValueError(
                f"unknown backend {self.backend!r}; valid backends: "
                f"{list(ops_impls())} (or None: each op's default)")
        if self.mesh is not None:
            raise NotImplementedError(
                "mesh=: mesh and sharded serving are not ported yet "
                "(ROADMAP.md queue 1 item 7, mesh)")
        if self.kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout must be 'dense' or 'paged', got "
                             f"{self.kv_layout!r}")

    def replace(self, **kw) -> "CompileOptions":
        """A copy with the given fields replaced (validates like __init__)."""
        return _dc_replace(self, **kw)

    @property
    def dpia_backend(self) -> str:
        """The Stage III backend name this impl choice maps to: the named
        one for ``dpia-<name>``; the port's reference Stage III,
        ``torch``, for the native rows and for None."""
        if self.backend is not None and self.backend.startswith("dpia-"):
            return self.backend[len("dpia-"):]
        return "torch"

    def resolved_mesh(self):
        """The mesh compilation runs against: always None (single
        device) until the mesh slice."""
        return None

    def mesh_descriptor(self) -> str:
        """The mesh component of every executor-cache key."""
        return "single"


class _Scope(threading.local):
    def __init__(self):
        self.stack = []


_SCOPE = _Scope()
_DEFAULT_LOCK = threading.Lock()
_DEFAULT: Optional[CompileOptions] = None


def default_options() -> CompileOptions:
    """The process-wide default options (outside any ``options()`` scope)."""
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = CompileOptions()
    return _DEFAULT


def set_default_options(**kw) -> CompileOptions:
    """Replace fields of the process-wide default options.

    This is start-up configuration (and the target the deprecated
    ``ops.set_default_impl`` shim delegates to): inside an active
    ``with options(...)`` scope the scoped options still win."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        base = _DEFAULT if _DEFAULT is not None else CompileOptions()
        _DEFAULT = base.replace(**kw) if kw else base
    return _DEFAULT


def current_options() -> CompileOptions:
    """The innermost active options scope on this thread, else the default."""
    stack = _SCOPE.stack
    return stack[-1] if stack else default_options()


@contextmanager
def options(opts: Optional[CompileOptions] = None, **kw):
    """Scope compile options for the current thread.

    Either pass a full :class:`CompileOptions`, or keyword overrides which
    are applied on top of the *current* options (so scopes nest/inherit)::

        with compiler.options(backend="dpia-torch"):
            with compiler.options(kv_layout="paged"):  # backend still set
                ...
    """
    if opts is not None and kw:
        raise TypeError("options(): pass either a CompileOptions or field "
                        "overrides, not both")
    if opts is None:
        opts = current_options().replace(**kw) if kw else current_options()
    elif not isinstance(opts, CompileOptions):
        raise TypeError(f"options() expects CompileOptions, got "
                        f"{type(opts).__name__}")
    _SCOPE.stack.append(opts)
    try:
        yield opts
    finally:
        _SCOPE.stack.pop()
