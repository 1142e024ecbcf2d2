"""Stage III backend registry of the port: the backend names as data.

A :class:`Backend` wraps one Stage III code generator (functional/imperative
DPIA -> executable callable).  The port's generators in
``repro_torch.core.dpia.stage3_*`` self-register on import: ``"torch"``
(alias ``"dpia-torch"``) and ``"cuda"`` (alias ``"dpia-cuda"``).

The port's copy of ``repro.compiler.backends``.  Like it, this module imports
nothing from ``core.dpia`` at module level (the stage3 modules import *us*
to self-register); lookup imports ``core.dpia`` lazily so the built-ins are
there before first use.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

__all__ = ["Backend", "register_backend", "unregister_backend",
           "get_backend", "backend_names", "ops_impls"]


@dataclass(frozen=True)
class Backend:
    """One Stage III target.

    ``compile(expr, arg_vars, **kw) -> callable`` produces the executable.
    ``accepts`` names the keyword arguments the generator understands
    (``"check"``, ``"lowered"``): ``Program.compile`` passes them only when
    accepted."""
    name: str
    compile: Callable[..., Callable]
    accepts: Tuple[str, ...] = ()
    description: str = ""


_REGISTRY: Dict[str, Backend] = {}
_ALIASES: Dict[str, str] = {}
_LOCK = threading.Lock()


def _ensure_builtins() -> None:
    """Populate the registry with the stage3 built-ins (idempotent)."""
    from ..core import dpia  # noqa: F401  (import runs self-registration)


def register_backend(backend: Backend, *, aliases: Tuple[str, ...] = (),
                     overwrite: bool = False) -> Backend:
    """Add a Stage III backend (and optional alias names) to the registry."""
    if not isinstance(backend, Backend):
        raise TypeError(f"register_backend expects a Backend, got "
                        f"{type(backend).__name__}")
    with _LOCK:
        if backend.name in _REGISTRY and not overwrite:
            raise ValueError(f"backend {backend.name!r} is already registered "
                             f"(pass overwrite=True to replace it)")
        _REGISTRY[backend.name] = backend
        for a in aliases:
            _ALIASES[a] = backend.name
    return backend


def unregister_backend(name: str) -> None:
    """Remove a backend (and any aliases pointing at it)."""
    with _LOCK:
        _REGISTRY.pop(name, None)
        for a in [a for a, t in _ALIASES.items() if t == name]:
            del _ALIASES[a]


def get_backend(name) -> Backend:
    """Resolve a backend by name/alias (or pass a Backend through).

    Raises ``ValueError`` naming the registered backends on an unknown name.
    """
    if isinstance(name, Backend):
        return name
    _ensure_builtins()
    try:
        return _REGISTRY[_ALIASES.get(name, name)]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; registered backends: "
            f"{backend_names()} (aliases: {sorted(_ALIASES)})") from None


def backend_names() -> Tuple[str, ...]:
    """Registered backend names, sorted (aliases not included)."""
    _ensure_builtins()
    return tuple(sorted(_REGISTRY))


def ops_impls() -> Tuple[str, ...]:
    """Valid kernel-layer impl names for ``repro_torch.kernels.ops``
    dispatch: the two native rows (``plain``, and ``cuda`` for the ops
    with a hand-written kernel) plus one ``dpia-<backend>`` per registered
    backend.  The reference's ``ops_impls`` (``xla``, ``pallas``,
    ``dpia-*``) excludes backends with compile-time requirements; the
    port's backends have none."""
    return ("plain", "cuda") + tuple(f"dpia-{b}" for b in backend_names())
