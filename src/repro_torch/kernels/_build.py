"""Build and load the port's kernels.

CUDA C++ sources (``csrc/<name>.cu``) are compiled on first use, on the
machine with the card, into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/<name>-<hash>.so csrc/<name>.cu

A source may add flags of its own (``SOURCE_FLAGS``): ``matmul_wgmma``
takes ``-I /usr/local/cutlass/include`` for CuTe's wgmma atoms, so it
builds only where CUTLASS's headers are installed.  The output lives in
``build/`` at the repository root (listed in ``.gitignore``), keyed by a
hash of the source, the headers beside it and its flags, so an edited
source rebuilds and an unchanged one loads at once.  ``ptxas``'s report
(registers, shared memory, spills per kernel) is kept beside it as
``<name>-<hash>.log``.  The library is loaded with :mod:`ctypes`: every
pointer and the stream are ``c_void_p``, ints ``c_int``; each C entry point
returns ``cudaGetLastError()`` after its launch, and :func:`check` raises
when that is not 0.

Generated sources (the DPIA CUDA generator's programs) go through the same
flags into ``build/dpia/<name>-<hash of text and flags>.so``, the text
written beside it as ``.cu``; :func:`build_generated` compiles a batch of
them in parallel.

Nothing here runs at import time: this module imports on hosts without
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build"
CSRC = Path(__file__).resolve().parent / "csrc"
DPIA_DIR = BUILD_DIR / "dpia"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

CUTLASS_INCLUDE = Path("/usr/local/cutlass/include")
# flags beyond NVCC_FLAGS, per source
SOURCE_FLAGS = {"matmul_wgmma": ("-I", str(CUTLASS_INCLUDE))}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}

# nvcc processes started by this process (one per source built): an AOT
# reload that finds its libraries built keeps this at 0
nvcc_runs = 0


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


def flags(name: str) -> Tuple[str, ...]:
    """nvcc's flags for ``csrc/<name>.cu``."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def target(name: str) -> Path:
    """The library path for ``csrc/<name>.cu`` at its current contents and
    flags."""
    h = hashlib.sha256(" ".join(flags(name)).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _compile(jobs) -> None:
    """Run one ``nvcc`` per (label, source, library, flags) job, all
    started together; keep each ptxas report beside its library; raise with
    the compiler's output when a build fails."""
    global nvcc_runs
    if not jobs:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc_runs += len(jobs)
    procs = []
    for label, src, out, opts in jobs:
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *opts, "-o", str(tmp), str(src)]
        procs.append((label, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for label, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{label}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)     # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def build(names: Sequence[str] = ()) -> float:
    """Compile the named sources (default: all) that are not built yet, one
    ``nvcc`` per source, all started together.  Returns the seconds spent;
    raises with the compiler's output when a build fails."""
    names = list(names) or sources()
    t0 = time.perf_counter()
    _compile([(n, CSRC / f"{n}.cu", target(n), flags(n)) for n in names
              if not target(n).exists()])
    return time.perf_counter() - t0


# ---- generated sources (the DPIA CUDA generator, core/dpia/stage3_cuda) ----

def generated_target(name: str, text: str) -> Path:
    """The library path of generated source ``text``:
    ``build/dpia/<name>-<sha of text and flags>.so`` (the source is written
    beside it as ``.cu``)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(text.encode())
    return DPIA_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_generated(items: Sequence[Tuple[str, str]]) -> float:
    """Compile generated ``(name, source text)`` pairs that are not built
    yet, in one parallel batch.  Returns the seconds spent."""
    t0 = time.perf_counter()
    jobs = {}
    for name, text in items:
        out = generated_target(name, text)
        if out.exists() or out in jobs:
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        src = out.with_suffix(".cu")
        src.write_text(text)
        jobs[out] = (name, src, out, NVCC_FLAGS)
    _compile(list(jobs.values()))
    return time.perf_counter() - t0


def load_generated(name: str, text: str) -> ctypes.CDLL:
    """The loaded library of generated source ``text``, built if needed."""
    out = generated_target(name, text)
    with _LOCK:
        lib = _LIBS.get(str(out))
        if lib is None:
            build_generated([(name, text)])
            lib = _LIBS[str(out)] = ctypes.CDLL(str(out))
        return lib


def ptxas_report(log: str, kernel_pattern: str) -> Dict[tuple, dict]:
    """Registers, static shared memory and spill bytes per kernel from a
    ``-Xptxas -v`` log, keyed by the groups ``kernel_pattern`` captures
    in the (mangled) kernel name."""
    out: Dict[tuple, dict] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\S+?)'?(?: for|$)", line)
        if m:
            k = re.search(kernel_pattern, m.group(1))
            cur = out.setdefault(k.groups(), {}) if k else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem_static"] = int(sm.group(1)) if sm else 0
    return out


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
