"""The staged DPIA compiler of the port: the paper's pipeline as an API.

    fn = Program(expr, arg_vars).check().lower().compile("cuda")

The port's copy of ``repro.compiler``:

  backends  — registry of Stage III targets (``torch`` and ``cuda``
              self-register; user backends plug in the same way)
  options   — :class:`CompileOptions` threaded explicitly + thread-local
              ``with compiler.options(...):`` scoping
  program   — :class:`Program` with the staged fluent API
              ``check()`` -> ``lower(strategy)`` -> ``compile(backend)``,
              and its AOT document (``to_doc`` / ``export`` / ``load``)
  executors — the process-wide executor cache the op layer memoises in,
              with its AOT store (``save_aot`` / ``load_aot``)
  serialize — JSON round-tripping of DPIA phrases (the AOT format)

Quick use::

    from repro_torch import compiler
    from repro_torch.kernels import ops

    with compiler.options(backend="dpia-cuda"):   # scoped, thread-local
        y = ops.dot(x, y)

The reference's ``default_interpret`` (Pallas interpret mode) has no
counterpart here.
"""
# NOTE: import order matters: ``backends`` and ``options`` must be bound
# before ``program`` pulls in core.dpia, whose stage3 modules import
# compiler.backends back to self-register.
from . import backends, options as _options_mod  # noqa: F401
from .backends import (  # noqa: F401
    Backend, backend_names, get_backend, ops_impls, register_backend,
    unregister_backend,
)
from .options import (  # noqa: F401
    CompileOptions, current_options, default_options, options,
    set_default_options,
)
from .program import CompiledKernel, Program, program  # noqa: F401
from . import executors, serialize  # noqa: F401
from .executors import ExecutorCache  # noqa: F401
from .executors import default_cache as executor_cache  # noqa: F401

__all__ = [
    "Backend", "backend_names", "get_backend", "ops_impls",
    "register_backend", "unregister_backend",
    "CompileOptions", "options", "current_options", "default_options",
    "set_default_options",
    "Program", "CompiledKernel", "program",
    "ExecutorCache", "executor_cache", "executors", "serialize",
]
