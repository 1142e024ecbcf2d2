"""The staged DPIA compiler of the port: ``Program`` and the Stage III
backend registry (``"torch"``, ``"cuda"``).

    fn = Program(expr, arg_vars).check().lower().compile("cuda")

The reference's options scope, executor cache, AOT serialisation,
``Program.from_kernel`` (through the autotuner) and observability spans
wait for their slices of the port (ROADMAP.md).
"""
from .backends import (Backend, backend_names, get_backend,  # noqa: F401
                       register_backend)
from .program import CompiledKernel, Program  # noqa: F401
