"""Build and load the port's kernels.

CUDA C++ sources (``csrc/<name>.cu``) are compiled on first use, on the
machine with the card, into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/<name>-<hash>.so csrc/<name>.cu

The output lives in ``build/`` at the repository root (listed in
``.gitignore``), keyed by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads at once.  ``ptxas``'s report
(registers, shared memory, spills per kernel) is kept beside it as
``<name>-<hash>.log``.  The library is loaded with :mod:`ctypes`: every
pointer and the stream are ``c_void_p``, ints ``c_int``; each C entry point
returns ``cudaGetLastError()`` after its launch, and :func:`check` raises
when that is not 0.

Triton kernels compile through Triton's own JIT; :func:`import_triton`
points Triton's cache into the same ``build/`` directory.  Nothing here
runs at import time: this module imports on hosts without ``nvcc`` or
``triton``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build"
CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin); "
                           "the port's CUDA kernels build only where the "
                           "CUDA toolkit is installed")
    return path


def sources() -> list:
    """Names of every CUDA source in ``csrc/`` (without ``.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def target(name: str) -> Path:
    """The library path for ``csrc/<name>.cu`` at its current contents."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = ()) -> float:
    """Compile the named sources (default: all) that are not built yet, one
    ``nvcc`` per source, all started together.  Returns the seconds spent;
    raises with the compiler's output when a build fails."""
    names = list(names) or sources()
    t0 = time.perf_counter()
    todo = [(n, target(n)) for n in names if not target(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)     # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = ctypes.CDLL(str(target(name)))
        return lib


def function(lib_name: str, fn_name: str, argtypes) -> ctypes._CFuncPtr:
    """A C entry point with its argument types declared (returns c_int)."""
    fn = getattr(library(lib_name), fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, what: str) -> None:
    """Raise if a C entry point's ``cudaGetLastError()`` is not success."""
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{rc}")


def import_triton():
    """Import Triton with its compile cache inside ``build/``."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    return triton
